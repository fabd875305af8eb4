"""The `trex` CLI: convert and track tasks, headless.

Re-creates the reference tracker/main.cpp surface (:760-815 flag mapping,
:108-169 task inference, :522-690 start_tracking/start_converting):

    trex -i <input> -o <name> -d <dir> [-s file.settings] [-p prefix]
         [-task convert|track] [-nowindow] [-auto_quit] [-load]
         [-<any_setting> <value> ...]

Shorthand flags map onto settings; every other `-name value` pair sets
the setting of that name. Task inference: .pv input (or extensionless
path resolving to a .pv) -> track, otherwise convert.

Counterpart of ``trex_tpu/cli/trex.py``. Detection and tracking run on
the CUDA card under ``-detect_engine device`` and ``-track_engine
device`` (or ``auto``); `main(argv, device="cpu")` runs their plain
paths. ``-track_engine object``, ``-load`` (the .results restored into
the object Tracker) and ``auto`` with settings both fast engines refuse
track with the object Tracker on the host. What the port does not have
yet raises, naming its ROADMAP.md item: the visual identification,
categories and tags (``auto_train``, ``auto_apply``,
``auto_categorize``, ``auto_tags``, ``tags_path``), visual fields,
recognition data and tracklet images.

    python -m trex_tpu_torch.cli.trex -i <video|.pv> -d <dir> -auto_quit \
        -detect_engine device -track_engine device
"""
from __future__ import annotations

import sys
from pathlib import Path

from ..config import (
    AccessLevel,
    format_value,
    global_settings,
    load_settings_file,
    parse_value,
)

SHORTHAND = {
    "i": "source",
    "o": "filename",
    "d": "output_dir",
    "p": "output_prefix",
    "s": "settings_file",
    "m": "detect_model",
    "bm": "region_model",
    "load": "load",
    "task": "task",
    "nowindow": "nowindow",
    "auto_quit": "auto_quit",
    "auto_train": "auto_train",
    "dim": "detect_resolution",
}

FLAG_ONLY = {"nowindow", "auto_quit", "auto_train", "load", "auto_apply",
             "auto_no_results", "auto_categorize", "quiet"}


def parse_args(argv: list[str]) -> dict:
    """CommandLine::init semantics (misc/CommandLine.h, covered by the
    reference's test_commandline.cpp): an option's value spans every
    following token up to the next `-flag`, joined with spaces (paths
    with spaces arrive as several argv entries); a missing value makes
    a boolean flag; quoted values ('-7') shed their quotes so negative
    numbers are not mistaken for flags."""
    out: dict[str, object] = {}
    i = 0
    while i < len(argv):
        arg = argv[i]
        if not arg.startswith("-"):
            i += 1
            continue
        name = arg.lstrip("-")
        key = SHORTHAND.get(name, name)
        if key in FLAG_ONLY or i + 1 >= len(argv) \
                or (argv[i + 1].startswith("-")
                    and not _is_number(argv[i + 1])):
            out[key] = True
            i += 1
            continue
        parts = [argv[i + 1]]
        i += 2
        while i < len(argv) and not argv[i].startswith("-"):
            parts.append(argv[i])
            i += 1
        value = " ".join(parts)
        if len(value) >= 2 and value[0] == value[-1] and value[0] in "'\"":
            value = value[1:-1]
        out[key] = value
    return out


def _is_number(s: str) -> bool:
    try:
        float(s)
        return True
    except ValueError:
        return False


def determine_task(source: str, explicit: str | None,
                   out_pv_exists: bool = False) -> str:
    """main.cpp:108-169: explicit -task wins; .pv inputs track; an
    already-converted output pv (-o name whose <name>.pv exists in the
    output dir) resumes as track; everything else converts."""
    if explicit in ("convert", "track", "annotate", "rst"):
        return explicit
    if source and (source.endswith(".pv")
                   or Path(str(source) + ".pv").exists()):
        return "track"
    if out_pv_exists:
        return "track"
    return "convert"


class _SignalState:
    """Two-stage SIGINT + crash handlers (main.cpp:441-520): first ^C
    requests a graceful terminate, second forces exit; SIGSEGV/SIGBUS
    print a panic note; error_terminate propagates a nonzero exit."""

    def __init__(self):
        self.terminate_requested = False
        self.targets: list = []  # running Segmenter/TrackingState

    def install(self):
        import faulthandler
        import signal

        faulthandler.enable()  # SIGSEGV/SIGBUS/SIGABRT tracebacks

        def on_int(signum, frame):
            if self.terminate_requested:
                print("\n[signal] forced exit", file=sys.stderr)
                raise SystemExit(130)
            self.terminate_requested = True
            for t in self.targets:
                t.terminate = True
            print("\n[signal] terminate requested — finishing the "
                  "current frame (press ^C again to force)",
                  file=sys.stderr)

        try:
            signal.signal(signal.SIGINT, on_int)
            if hasattr(signal, "SIGHUP"):
                signal.signal(signal.SIGHUP,
                              lambda *_: sys.exit(129))
        except ValueError:
            pass  # not the main thread (library use)
        return self


def main(argv=None, device=None) -> int:
    """Run one task; `device` (``None`` = the card, ``"cpu"`` = the
    plain paths) is where detection and tracking run."""
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parse_args(argv)
    s = global_settings()
    sig = _SignalState().install()

    output_dir = Path(str(args.pop("output_dir", ".")).strip('"'))
    prefix = str(args.pop("output_prefix", "") or "").strip('"')
    source = str(args.pop("source", "") or "").strip('"')
    name = str(args.pop("filename", "") or "").strip('"')
    settings_file = args.pop("settings_file", None)
    # determineTaskType (main.cpp:119-128): an EXISTING converted
    # output pv routes straight to tracking (resume) unless -task says
    # otherwise
    _ob = output_dir / prefix if prefix else output_dir
    out_pv = (_ob / f"{name}.pv") if name else None
    task = determine_task(source, args.pop("task", None),
                          out_pv_exists=bool(out_pv
                                             and out_pv.exists()))
    auto_quit = bool(args.pop("auto_quit", False))
    args.pop("nowindow", None)  # always headless
    load = bool(args.pop("load", False))
    matching_log = args.pop("history_matching_log", None)

    if settings_file:
        load_settings_file(s, str(settings_file).strip('"'))

    # remaining args map to settings (cmdline layer wins)
    for k, v in args.items():
        try:
            s.set(k, parse_value(str(v)) if isinstance(v, str) else v,
                  source="cmdline", max_access=AccessLevel.SYSTEM)
        except Exception as e:  # unknown/invalid: warn, continue
            print(f"[warn] cannot set {k!r}: {e}", file=sys.stderr)

    out_base = output_dir / prefix if prefix else output_dir
    # data_prefix: subfolder below the output dir for NPZ/CSV exports
    # (Export.cpp:189-190 DataLocation::parse("output", data_prefix))
    data_dir = out_base / str(s["data_prefix"] or "data")

    # log_file (default_config.cpp:788): tee stdout/stderr to a file
    log_path = str(s.get("log_file", "") or "").strip()
    if log_path:
        class _Tee:
            def __init__(self, stream, fh):
                self._s, self._f = stream, fh

            def write(self, data):
                self._s.write(data)
                self._f.write(data)
                return len(data)

            def flush(self):
                self._s.flush()
                self._f.flush()

            def __getattr__(self, name):
                return getattr(self._s, name)

        p = Path(log_path)
        p.parent.mkdir(parents=True, exist_ok=True)
        _log_fh = open(p, "a", buffering=1)
        _saved_streams = (sys.stdout, sys.stderr)
        sys.stdout = _Tee(sys.stdout, _log_fh)
        sys.stderr = _Tee(sys.stderr, _log_fh)
    else:
        _log_fh = None
        _saved_streams = None

    def progress(done, total):
        if done % 50 == 0 or done == total:
            print(f"\r[{task}] {done}/{total}", end="", flush=True)

    try:
        if task == "rst":
            # `-task rst`: dump the parameter documentation
            # (main.cpp:92-106); inside the try so the finally below
            # restores the log tee on this path too
            out = out_base / "parameters_trex.rst"
            out_base.mkdir(parents=True, exist_ok=True)
            out.write_text(_generate_rst(s))
            print(f"[rst] wrote {out}")
            return 0

        # a fresh run must not inherit stage-timing records from
        # earlier in-process runs (tests/run_harness invoke main()
        # repeatedly)
        from ..utils.timing import global_collector as _gc
        _gc().clear()

        return _run_task(task, source, name, out_base, data_dir, s,
                         sig, args, auto_quit, load, matching_log,
                         progress, device)
    except KeyboardInterrupt:
        return 130
    except Exception as e:
        # error_terminate (main.cpp:957-962): propagate nonzero exit
        print(f"[error] {type(e).__name__}: {e}", file=sys.stderr)
        if s.get("error_terminate", True):
            return 1
        raise
    finally:
        if _saved_streams is not None:
            sys.stdout, sys.stderr = _saved_streams
            try:
                _log_fh.close()
            except OSError:
                pass


def _generate_rst(s) -> str:
    """The parameter documentation as reStructuredText (the JAX
    package's tools/settings_docs.py, over the port's registry)."""
    lines = [".. toctree::", "   :maxdepth: 2", "", "TRex parameters",
             "===============", ""]
    for name in s.names():
        p = s.param(name)
        lines.append(f".. function:: {name}({p.type})")
        lines.append("")
        lines.append(f"\t**default value:** {format_value(p.default)}")
        lines.append("")
        if p.access.name != "PUBLIC":
            lines.append(f"\t**access level:** {p.access.name}")
            lines.append("")
        if p.doc:
            lines.append(f"\t{p.doc}")
            lines.append("")
        lines.append("")
    return "\n".join(lines)


_VI = "comes with the visual-identification slice (ROADMAP.md A item 3)"

# options whose modules the port does not have yet, with their items
_UNPORTED_TRACK = (
    ("auto_train", "auto_train (accumulation training) " + _VI),
    ("auto_apply", "auto_apply (identity correction) " + _VI),
    ("auto_categorize", "auto_categorize " + _VI),
    ("auto_tags", "auto_tags needs -load and the tag model; it " + _VI),
    ("auto_tags_on_startup", "auto_tags_on_startup " + _VI),
    ("tags_path", "tags_path (tag detections) " + _VI))
_UNPORTED_OUTPUTS = (
    ("output_recognition_data", "output_recognition_data: "
     "export_recognition " + _VI),
    ("output_visual_fields", "output_visual_fields needs ops/raycast.py "
     "and track/visual_field.py (ROADMAP.md A item 3)"),
    ("output_tracklet_images", "output_tracklet_images: "
     "export_tracklet_images needs ops/crops.py (ROADMAP.md A item 3)"))


def _refuse_unported(s, task: str, auto_quit: bool):
    """Raise for the options whose modules the port does not have yet,
    before any frame is converted or tracked."""
    checks = _UNPORTED_OUTPUTS if auto_quit and not s["auto_no_outputs"] \
        else ()
    if task == "track":
        checks = _UNPORTED_TRACK + checks
    for key, what in checks:
        value = s[key]
        if value and (not isinstance(value, str) or value.strip()):
            raise NotImplementedError(what)


def _run_task(task, source, name, out_base, data_dir, s, sig, args,
              auto_quit, load, matching_log, progress, device=None):
    if task in ("convert", "track"):
        _refuse_unported(s, task, auto_quit)
    if task == "convert":
        if not source:
            print("no input (-i) given", file=sys.stderr)
            return 1
        if not name:
            # default output name = find_basename over the resolved
            # source array (commons PathArray; SettingsInitializer)
            from ..io.patharray import (find_basename, has_pattern,
                                        resolve_paths, sanitize_filename)

            if has_pattern(source):
                name = sanitize_filename(
                    find_basename(resolve_paths(source)))
            if not name:
                name = Path(source.replace("%", "_")).stem or "output"
        from ..pipeline import Segmenter

        pv_path = out_base / f"{name}.pv"
        out_base.mkdir(parents=True, exist_ok=True)
        seg = Segmenter(s, source, pv_path, track=True, progress=progress,
                        device=device)
        sig.targets.append(seg)
        tracker = seg.run()
        print(f"\n[convert] wrote {pv_path} "
              f"({seg.fps_stat:.1f} fps)")
        if seg.engine_choice:
            print(f"[convert] {seg.engine_choice}")
        if s["grabber_force_settings"]:
            # live tracking always (over)writes <filename>.settings in
            # the output folder (grabber default_config doc)
            from ..config.settings_io import settings_to_text

            sp = out_base / f"{name}.settings"
            sp.write_text(settings_to_text(s))
            print(f"[convert] wrote {sp} (grabber_force_settings)")
        _dump_timing(s)
        if matching_log and tracker is not None:
            _write_matching_log(tracker, out_base / str(matching_log))
        if auto_quit and not s["auto_no_outputs"]:
            if tracker is not None:
                _export(tracker, s, data_dir, name)
        return 0

    if task == "track":
        pv_path = Path(source)
        if not pv_path.suffix:
            pv_path = pv_path.with_suffix(".pv")
        if not pv_path.exists() and name:
            # resume route (determineTaskType): the source was frames
            # but <output>/<name>.pv already exists
            cand = out_base / f"{name}.pv"
            if cand.exists():
                pv_path = cand
        if not pv_path.exists():
            print(f"pv file not found: {pv_path}", file=sys.stderr)
            return 1
        if not name:
            name = pv_path.stem
        from ..pipeline import TrackingState

        engine_mode = (s.get("track_engine", "auto") or "auto")
        if load and engine_mode != "object":
            # .results restore rebuilds Individual state through the
            # object tracker (TrackingState::load_state)
            if engine_mode in ("fast", "device"):
                print(f"[load] track_engine={engine_mode} cannot "
                      "restore .results state; using object",
                      file=sys.stderr)
            s.set("track_engine", "object", source="load")
        state = TrackingState(s, pv_path, progress=progress, device=device)
        sig.targets.append(state)
        print(f"[track] {state.engine_choice}")
        loaded = False
        if load:
            from ..export.results import load_results

            results_path = pv_path.with_suffix(".results")
            if results_path.exists():
                load_results(state.tracker, results_path)
                loaded = True
            else:
                print(f"[load] no results at {results_path}; "
                      f"tracking from scratch", file=sys.stderr)
        if loaded:
            # -load means USE the stored state (TrackingState::load_state)
            # — re-tracking on top would duplicate every frame record
            tracker = state.tracker
            print(f"\n[track] loaded {len(tracker.individuals)} "
                  f"individuals from {results_path}")
        else:
            tracker = state.run()
            engine_note = type(tracker).__name__
            if getattr(tracker, "demoted", False):
                engine_note += " (demoted to host: assists dominate)"
            print(f"\n[track] tracked {len(state.pv)} frames, "
                  f"{len(tracker.individuals)} individuals [{engine_note}]")
            if s["match_mode"] == "benchmark":
                # final per-algorithm timing + agreement summary
                # (PairingGraph.cpp:1282-1288 periodic report)
                from ..track.matching import benchmark_report

                for line in benchmark_report():
                    print(f"[match benchmark] {line}")
        if s["gui_show_memory_stats"]:
            from ..utils.memstats import tracker_memory_stats

            tracker_memory_stats(tracker).print()
        _dump_timing(s)
        if matching_log:
            _write_matching_log(tracker, out_base / str(matching_log))
        if auto_quit and not s["auto_no_outputs"]:
            # every engine serves the full export surface in archive
            # mode (need_individuals default True)
            _export(tracker, s, data_dir, name, pv_file=state.pv)
            if not s["auto_no_results"]:
                from ..export.results import save_results

                save_results(tracker, s, pv_path.with_suffix(".results"))
        return 0

    if task == "annotate":
        # the annotation editor is a GUI scene (main.cpp:318); the
        # headless surface consumes annotations via track_annotations
        print("task 'annotate' is GUI-only; set track_annotations "
              "and export instead", file=sys.stderr)
        return 1
    print(f"unsupported task {task!r}", file=sys.stderr)
    return 1


def _dump_timing(s):
    """timing_stats_file: per-stage pipeline timing as Chrome
    trace-event JSON (the TimingStatsCollector lane chart)."""
    path = str(s.get("timing_stats_file", "") or "").strip()
    if not path:
        return
    from ..utils.timing import global_collector, to_chrome_trace

    c = global_collector()
    to_chrome_trace(c.records(), path)
    summary = c.summary()
    print(f"[timing] wrote {path} "
          f"({sum(v['n'] for v in summary.values())} records, "
          f"{len(summary)} lanes)")


def _write_matching_log(tracker, path):
    """history_matching_log: per-frame assignment table as HTML
    (reference -history_matching_log, used by its test harness)."""
    from pathlib import Path

    rows = []
    for f in range(max(0, tracker.start_frame),
                   tracker.end_frame + 1):
        cells = []
        for fid, ind in sorted(tracker.individuals.items()):
            b = ind.basic_stuff(f)
            cells.append(f"<td>{b.blob.blob_id if b else ''}</td>")
        st = tracker.statistics.get(f)
        rows.append(f"<tr><td>{f}</td>"
                    f"<td>{st.number_fish if st else ''}</td>"
                    + "".join(cells) + "</tr>")
    head = "".join(f"<th>fish{fid}</th>"
                   for fid in sorted(tracker.individuals.keys()))
    html = ("<html><body><table border=1>"
            f"<tr><th>frame</th><th>assigned</th>{head}</tr>"
            + "\n".join(rows) + "</table></body></html>")
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(html)


def _export(tracker, s, data_dir, name, pv_file=None):
    """The reference's export surface (ui/Export.cpp:156-900) that the
    port has: per-fish data files, posture, statistics, heatmaps and
    annotations. The other `output_*` products were refused before the
    task ran (_UNPORTED_OUTPUTS)."""
    from ..export.export import (export_data, export_posture,
                                 export_statistics)

    paths = []
    if not s["auto_no_tracking_data"]:
        # auto_no_tracking_data skips the output_fields data files
        # (posture/results still write)
        paths += export_data(tracker, s, data_dir, name,
                             pv_file=pv_file)
    if s["output_posture_data"]:
        paths += export_posture(tracker, s, data_dir, name)
    if s["output_heatmaps"]:
        from ..track.heatmap import export_heatmaps

        paths += [export_heatmaps(tracker, s, data_dir, name)]
    if s["output_statistics"]:
        paths += export_statistics(tracker, s, data_dir, name)
    if s["track_annotations"]:
        # per-frame human annotations export (track_annotations doc:
        # 'a map {frame:[[clid,type,[points...]],...]} that can be
        # used to export annotations per frame')
        from ..track.annotations import export_annotations

        paths += [export_annotations(s["track_annotations"],
                                     data_dir, name)]
    print(f"[export] wrote {len(paths)} files to {data_dir}")


def cli_entry():
    """console_scripts entry point (pyproject [project.scripts])."""
    sys.exit(main())


if __name__ == "__main__":
    sys.exit(main())

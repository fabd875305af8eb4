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
track with the object Tracker on the host. ``-auto_train`` runs the
accumulation curriculum, training the identity network on the card, and
saves its weights (``<pv stem>_weights.npz``); ``-auto_apply`` loads
them (or ``visual_identification_model_path``). Either then predicts
every tracklet's crops on the card, reassigns identities and re-tracks
with the corrections; ``output_recognition_data`` and
``output_tracklet_images`` export its probabilities and the tracklets'
crops. ``-auto_categorize`` trains the category MLP on the card from
the labeled ranges and labels every long tracklet.
``output_visual_fields`` exports every posture frame's visual fields,
projected on the card. ``tags_recognize`` decodes the tags among the
noise blobs with the keras network of ``tags_model_path`` on the card
(``tags_path`` exports them, ``tags_save_predictions`` their crops);
``-load -auto_tags`` reassigns identities from the stored tag
detections and re-tracks.

    python -m trex_tpu_torch.cli.trex -i <video|.pv> -d <dir> -auto_quit \
        -detect_engine device -track_engine device
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

from ..config import (
    AccessLevel,
    format_value,
    global_settings,
    load_settings_file,
    parse_value,
)
from ..utils.drawing import line, write_png

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


def _run_task(task, source, name, out_base, data_dir, s, sig, args,
              auto_quit, load, matching_log, progress, device=None):
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
                _export(tracker, s, data_dir, name, device=device)
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
        _export_tags(tracker, s, out_base, name)
        _dump_timing(s)
        if matching_log:
            _write_matching_log(tracker, out_base / str(matching_log))
        auto_train = bool(s["auto_train"])
        if auto_train or s["auto_apply"]:
            _auto_train_apply(tracker, state, s, pv_path, auto_train,
                              device)
        if s["auto_categorize"]:
            _auto_categorize(tracker, s, state, device)
        if s["auto_tags"] or s["auto_tags_on_startup"]:
            # auto_tags_on_startup: the startup trigger for the same
            # physical-tag correction flow
            _auto_tags(tracker, state, s, load)
        if auto_quit and not s["auto_no_outputs"]:
            # every engine serves the full export surface in archive
            # mode (need_individuals default True)
            _export(tracker, s, data_dir, name, pv_file=state.pv,
                    device=device)
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


def _export_tags(tracker, s, out_base, name):
    """tags_path: the matched tags as NPZ; tags_save_predictions: their
    crops as PNGs sorted into 'tag <id>' folders (grabber doc)."""
    tags_path = str(s["tags_path"] or "").strip()
    if not (tags_path and getattr(tracker, "detected_tags", None)):
        return
    from ..track.tags import save_tags

    p = Path(tags_path)
    if not p.is_absolute():
        p = out_base / p
    save_tags(p.with_suffix(".npz"), tracker.detected_tags)
    print(f"[tags] wrote {p.with_suffix('.npz')}")
    if s["tags_save_predictions"]:
        root = out_base / f"tags_{name}"
        n_img = 0
        for fid, tag_list in tracker.detected_tags.items():
            for t in tag_list:
                d = root / f"tag {t.tag_id}"
                d.mkdir(parents=True, exist_ok=True)
                write_png(d / f"f{t.frame}_id{fid}.png", t.image)
                n_img += 1
        print(f"[tags] wrote {n_img} prediction crops to {root}")


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


def _auto_categorize(tracker, s, state, device=None):
    """auto_categorize (TrackingState.cpp:890): after tracking ends,
    train the category MLP (on `device`, the card when None) from the
    labeled ranges in the attached DataStore (loaded from .results or
    set programmatically) and apply predictions to every sufficiently
    long tracklet."""
    from ..ml.categorize import Categorizer

    cats = s["categories_ordered"] or []
    if not cats:
        print("[auto_categorize] categories_ordered is empty — nothing "
              "to categorize", file=sys.stderr)
        return
    store = getattr(tracker, "category_store", None)
    cat = Categorizer(s, list(cats), device=device)
    if store is not None and store.labeled_ranges():
        # remap label ids by NAME: the loaded store's category order
        # (e.g. from an older .results) may differ from this run's
        # categories_ordered
        for rl in store.labeled_ranges():
            try:
                name = store.label_name(rl.label)
            except IndexError:
                continue
            if name in cat.store.categories:
                cat.store.set_ranged_label(rl.fid, rl.start, rl.end,
                                           name)
        # carry the per-blob index over as well (consumed by the
        # track_consistent_categories matching veto)
        for f, per in getattr(store, "_blob_labels", {}).items():
            for bid, lbl in per.items():
                try:
                    name = store.label_name(lbl)
                except IndexError:
                    continue
                if name in cat.store.categories:
                    cat.store.set_blob_label(f, bid, name)
    tracker.category_store = cat.store
    try:
        cat.train(tracker)
    except ValueError as e:
        print(f"[auto_categorize] cannot train: {e}", file=sys.stderr)
        return
    applied = cat.apply(tracker)
    print(f"[auto_categorize] labeled {len(applied)} tracklets across "
          f"{len(cats)} categories")


def _uniqueness_image(per: dict) -> np.ndarray:
    """recognition_save_progress_images: one step's per-frame uniqueness
    as a black curve on 512x128 white."""
    img = np.full((128, 512), 255, np.uint8)
    if per:
        fs = sorted(per)
        xs = np.linspace(0, 511, len(fs)).astype(int)
        ys = 127 - (np.array([per[f] for f in fs]) * 127).astype(int)
        for k in range(1, len(fs)):
            line(img, (xs[k - 1], ys[k - 1]), (xs[k], ys[k]), 0)
    return img


def _auto_tags(tracker, state, s, load: bool):
    """auto_tags (TrackingState.cpp:898-899): apply the tag detections
    stored in the results file as identity ground truth and re-track.
    Only usable with '-load' — the tag information lives in the results
    file written during conversion (TrackingState.cpp:112-120)."""
    tags = getattr(tracker, "loaded_tags", None)
    if not load or tags is None:
        print("Can currently only use auto_tags in combination with "
              "'-load', when loading from a results file (where the "
              "tag information is stored).", file=sys.stderr)
        s.set("auto_tags", False, source="auto_tags")
        return
    if not tags:
        print("[auto_tags] no tag detections in the results file")
        return
    from ..ml.auto_tags import apply_tags

    matches, corrections = apply_tags(tracker, s, tags)
    print(f"[auto_tags] reassigned={corrections.reassigned} "
          f"skipped={corrections.skipped} "
          f"identities={len(corrections.ranges)}")
    if corrections.reassigned:
        existing = s["manual_matches"] or {}
        merged = dict(existing)
        for f, m in matches.items():
            merged.setdefault(f, {}).update(
                {str(k): v for k, v in m.items()})
        s.set("manual_matches", merged, source="auto_tags")
        print("[auto_tags] re-tracking with tag corrections...")
        tracker.individuals.clear()
        tracker.active.clear()
        tracker._next_id = 0
        tracker.start_frame = -1
        tracker.manual_matches = merged
        state.tracker = tracker
        state.run()


def _auto_train_apply(tracker, state, s, pv_path, train: bool,
                      device=None):
    """auto_train/auto_apply path (main.cpp:908-931): run the
    accumulation curriculum (or load weights), then auto-correct
    identities and re-track with the corrections. The network trains
    and predicts on `device` (the card when None)."""
    from ..ml import Accumulation, check_tracklets_identities

    acc = Accumulation(tracker, s, device=device)
    weights = pv_path.with_name(pv_path.stem + "_weights.npz")
    # visual_identification_model_path overrides the default weights
    # location for apply (default_config)
    override = str(s["visual_identification_model_path"] or "").strip()
    if override:
        weights = Path(override)
    if train and s["debug_recognition_output_all_methods"]:
        # debug: one sample crop per normalization method side by side
        from ..ops.crops import normalized_crop

        for ind in list(tracker.individuals.values())[:1]:
            for b in ind.basic[:1]:
                post = ind.posture_stuff(b.frame)
                tiles = [normalized_crop(
                    b.blob, tracker.background, s,
                    midline=post.midline if post else None,
                    mode=m) for m in ("none", "moments", "posture",
                                      "legacy")]
                dp = pv_path.with_name(
                    pv_path.stem + "_normalization_methods.png")
                write_png(dp, np.concatenate(tiles, axis=1))
                print(f"[auto_train] wrote {dp} (debug: none | "
                      "moments | posture | legacy)")
    if train:
        print("[auto_train] running accumulation...")
        result = acc.start()
        print(f"[auto_train] uniqueness={result.final_uniqueness:.3f} "
              f"steps={len(result.steps)} success={result.success}")
        if not result.success and s["auto_train_on_startup"]:
            # startup-triggered training treats failure as fatal
            # (Accumulation.cpp:998 throws under auto_train_on_startup
            # instead of warning)
            raise SystemExit(
                "[auto_train] accumulation did not reach sufficient "
                "uniqueness (auto_train_on_startup set: failures are "
                "fatal)")
        acc.trainer.save_weights(weights)
        if result.training_images is not None:
            # visual_identification_save_images: keep the successful
            # training set next to the weights
            ip = weights.with_name(weights.stem + "_training_images.npz")
            np.savez_compressed(ip, images=result.training_images,
                                labels=result.training_labels)
            print(f"[auto_train] wrote {ip}")
        if result.progress_maps:
            # recognition_save_progress_images: per-step uniqueness
            # history rendered as PNG curves (the reference saves the
            # GUI's uniqueness plots)
            for step_i, rng, per in result.progress_maps:
                write_png(weights.with_name(
                    f"{weights.stem}_uniqueness_step{step_i}.png"),
                    _uniqueness_image(per))
            print(f"[auto_train] wrote {len(result.progress_maps)} "
                  "uniqueness progress images")
        if s["auto_train_dont_apply"]:
            # train-only startup: quit without applying / correcting
            # (VisualIdentDialog.cpp:97 auto_quit after start())
            print("[auto_train] auto_train_dont_apply set: skipping "
                  "apply/auto-correct")
            return
    elif weights.exists():
        acc.trainer.load_weights(weights)
    else:
        print(f"[auto_apply] no weights at {weights}", file=sys.stderr)
        return

    class _Net:
        num_classes = acc.num_individuals

        def probabilities(self, images):
            return acc.trainer.predict(images)

    matches, corrections = check_tracklets_identities(tracker, s, _Net())
    print(f"[auto_correct] reassigned={corrections.reassigned} "
          f"skipped={corrections.skipped} "
          f"identities={len(corrections.ranges)}")
    if corrections.reassigned:
        existing = s["manual_matches"] or {}
        merged = dict(existing)
        for f, m in matches.items():
            merged.setdefault(f, {}).update(
                {str(k): v for k, v in m.items()})
        s.set("manual_matches", merged, source="auto_correct")
        print("[auto_correct] re-tracking with corrections...")
        tracker.individuals.clear()
        tracker.active.clear()
        tracker._next_id = 0
        tracker.start_frame = -1
        tracker.manual_matches = merged
        state.tracker = tracker
        state.run()


def _export(tracker, s, data_dir, name, pv_file=None, device=None):
    """The reference's full export surface (ui/Export.cpp:156-900):
    per-fish data files, plus every `output_*`-gated side product; the
    visual fields are projected on `device` (the card when None)."""
    from ..export.export import (export_data, export_posture,
                                 export_recognition,
                                 export_statistics,
                                 export_tracklet_images)

    paths = []
    if not s["auto_no_tracking_data"]:
        # auto_no_tracking_data skips the output_fields data files
        # (posture/results still write)
        paths += export_data(tracker, s, data_dir, name,
                             pv_file=pv_file)
    if s["output_posture_data"]:
        paths += export_posture(tracker, s, data_dir, name)
    if s["output_recognition_data"]:
        paths += export_recognition(tracker, s, data_dir, name)
    if s["output_visual_fields"]:
        from ..track.visual_field import export_visual_fields

        paths += export_visual_fields(tracker, s, data_dir, name,
                                      device=device)
    if s["output_heatmaps"]:
        from ..track.heatmap import export_heatmaps

        paths += [export_heatmaps(tracker, s, data_dir, name)]
    if s["output_tracklet_images"]:
        paths += export_tracklet_images(tracker, s, data_dir, name)
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

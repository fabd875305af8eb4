"""`pvinfo` CLI: inspect .pv files.

Counterpart of ``trex_tpu/cli/pvinfo.py`` (the reference's
tracker/pvinfo.cpp surface used by its test harness,
Tests/run_unix.bash:173-224): print header info, frame counts, selected
parameters from metadata; -quiet/-plain_text modes; -fix and -merge.

    python -m trex_tpu_torch.cli.pvinfo <file.pv> [-print_parameters [a,b]]
"""
from __future__ import annotations

import sys
from pathlib import Path

from ..io.pv import PVFile


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    path = None
    quiet = "-quiet" in argv
    plain = "-plain_text" in argv
    fix = "-fix" in argv
    print_params = []
    merge_out = None
    merge_in = []
    out_dir = None
    prefix = None
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "-i" and i + 1 < len(argv):
            path = argv[i + 1]
            i += 2
        elif a == "-d" and i + 1 < len(argv):
            out_dir = argv[i + 1]
            i += 2
        elif a == "-p" and i + 1 < len(argv):
            prefix = argv[i + 1]
            i += 2
        elif a == "-print_parameters" and i + 1 < len(argv):
            v = argv[i + 1].strip("[]")
            print_params = [x.strip().strip('"') for x in v.split(",") if x]
            i += 2
        elif a == "-merge":
            merge_out = argv[i + 1] if i + 1 < len(argv) else None
            # inputs run until the next -flag (its value must not be
            # swallowed into the merge list)
            merge_in = []
            j = i + 2
            while j < len(argv) and not argv[j].startswith("-"):
                merge_in.append(argv[j])
                j += 1
            i = j
            continue
        elif not a.startswith("-") and path is None:
            path = a
            i += 1
        else:
            i += 1

    # -d/-p resolution (pvinfo.cpp DataLocation: the input lives in
    # <output_dir>/<output_prefix>/, run_unix.bash:check_frame_count)
    if path and (out_dir or prefix):
        cand = []
        name = Path(path).name
        if out_dir and prefix:
            cand.append(Path(out_dir) / prefix / name)
        if prefix:
            cand.append(Path(path).parent / prefix / name)
        if out_dir:
            cand.append(Path(out_dir) / name)
        for c in cand:
            if c.with_suffix(".pv").exists() or c.exists():
                path = str(c)
                break

    if merge_out:
        from ..io.pv import merge_files

        if not merge_in:
            print("usage: pvinfo -merge <output.pv> <in1.pv> "
                  "[in2.pv ...]", file=sys.stderr)
            return 1
        n = merge_files(merge_out, merge_in)
        print(f"merged {len(merge_in)} files into {merge_out} ({n} frames)")
        return 0
    if not path:
        print("usage: pvinfo [-i] <file.pv> [-print_parameters [a,b,...]] "
              "[-quiet] [-plain_text]", file=sys.stderr)
        return 1
    p = Path(path)
    if not p.suffix:
        p = p.with_suffix(".pv")
    if fix:
        from ..io.pv import fix_file

        kept, dropped = fix_file(p)
        print(f"fixed {p}: kept {kept} frames, dropped {dropped}")
        return 0
    f = PVFile.open(p)
    h = f.header
    if print_params:
        meta = h.metadata_dict()
        from ..config import global_settings

        s = global_settings()
        for name in print_params:
            if name == "video_length":
                value = h.num_frames
            elif name in meta:
                value = meta[name]
            elif name in s:
                value = s[name]
            else:
                value = "<not found>"
            # parameter_format=settings (the default): `name = value`
            # lines, which the reference harness parses
            # (run_unix.bash: awk '/^video_length = /')
            print(value if plain else f"{name} = {value}")
        return 0
    if plain:
        # pvinfo.cpp:445: "version N\nframes M"
        print(f"version {h.version}\nframes {h.num_frames}")
        return 0
    if quiet:
        print(h.num_frames)
        return 0
    mb = p.stat().st_size / 1e6
    print(f"PV file: {p}")
    print(f"version: V_{h.version} encoding: {h.encoding}")
    print(f"resolution: {h.width}x{h.height} offsets: {h.offsets}")
    print(f"frames: {h.num_frames} size: {mb:.2f} MB")
    print(f"timestamp: {h.timestamp} average_tdelta: {h.average_tdelta}")
    print(f"project: {h.name!r} source: {h.source!r}")
    if h.conversion_start is not None:
        print(f"conversion range: [{h.conversion_start}, "
              f"{h.conversion_end}]")
    meta = h.metadata_dict()
    if meta and not plain:
        print("metadata:")
        for k in sorted(meta):
            print(f"  {k} = {meta[k]}")
    return 0


def cli_entry():
    """console_scripts entry point (pyproject [project.scripts])."""
    try:
        sys.exit(main())
    except BrokenPipeError:
        import os

        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        sys.exit(0)


if __name__ == "__main__":
    try:
        sys.exit(main())
    except BrokenPipeError:
        # downstream pager/head closed the pipe: exit quietly like
        # any well-behaved unix CLI
        import os

        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        sys.exit(0)

#!/usr/bin/env python3
"""A/B timing of the port's hand-written kernels on one CUDA card.

    python3 kernel_ab.py [--root DIR ...] [--out results.json]

Times kernel B1 (``label_components_vmem``) on the 32 detection masks of
1024^2 with 256 fish, and kernel B2 (``neighbor_min``) on their initial
labels padded with INACTIVE (32 x 1026^2, and the first frame alone):
the inputs ``chip_smoke.py`` gives them on their paths, made by its
``detection_masks`` and ``stencil_tiles``. It does so for the
``trex_tpu_torch`` package under each ``--root`` in turn (default: this
checkout), each in a process of its own; give the roots as old, new,
new, old to compare two versions on one card. For each root it prints
one JSON line: per kernel the median of single synchronised calls
(``ms``, as ``chip_smoke.py``'s kernels line), the time per call over
back-to-back calls (``ms_back_to_back``), the device time of each CUDA
kernel under ``torch.profiler`` (``passes_ms``), whether the output
equals the root's plain version, and the time of one PyTorch copy that
moves the same bytes (``copy_ms``, back to back: the mask to int32 for
B1, a clone of the tiles for B2), the rate this card reaches for that
traffic. Exits non-zero without CUDA.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


def measure(root: Path) -> dict:
    import torch

    sys.path.insert(0, str(root))
    from trex_tpu_torch import kernels
    from trex_tpu_torch.ops import cc_device

    if not Path(kernels.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"trex_tpu_torch of {root} not imported")
    # the inputs and timers of this checkout's chip_smoke.py, whatever the
    # root under test
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    kernels.build()
    mask = smoke.detection_masks(torch.device("cuda", 0))[3]
    tiles = smoke.stencil_tiles(mask)
    frame = tiles[:1].contiguous()
    out = {"root": str(root)}
    # copy: one PyTorch elementwise kernel that moves the kernel's bytes
    # (reads its input once, writes an output of its size once)
    for name, fn, plain, copy in (
            ("ccl_label", lambda: cc_device.label_components_vmem(mask),
             lambda: cc_device.label_components_plain(mask),
             lambda: mask.to(torch.int32)),
            ("neighbor_min", lambda: cc_device.neighbor_min(tiles),
             lambda: cc_device.neighbor_min_plain(tiles),
             lambda: tiles.clone()),
            ("neighbor_min_one_frame", lambda: cc_device.neighbor_min(frame),
             lambda: cc_device.neighbor_min_plain(frame),
             lambda: frame.clone())):
        equal = torch.equal(fn(), plain())
        out[name] = dict(equal=equal,
                         ms=smoke.time_ms(fn, iters=20),
                         ms_back_to_back=smoke.time_ms_back_to_back(fn),
                         passes_ms=smoke.kernel_split(fn) or "not measured",
                         copy_ms=smoke.time_ms_back_to_back(copy))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", action="append", type=Path,
                    help="checkout whose trex_tpu_torch to time "
                    "(repeatable, in order)")
    ap.add_argument("--out", help="also write the results as JSON here")
    ap.add_argument("--child", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    if args.child:
        print(json.dumps(measure(args.child.resolve())))
        return 0
    results = []
    for root in args.root or [HERE]:
        cmd = [sys.executable, str(Path(__file__).resolve()), "--child",
               str(root.resolve())]
        p = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=300)
        if p.returncode != 0:
            print(p.stdout + p.stderr, file=sys.stderr)
            return p.returncode
        line = p.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        results.append(json.loads(line))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip()
    print(card)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "runs": results}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

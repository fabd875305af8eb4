"""The readings that set the limits of ``correct``.

    python3 perfbench/control.py --workload <name> --seconds <s> \
        --seeds <n> [<n> ...]

For each seed, in one process: one run of the cell as ``run.py`` makes
it (set-up, a window of `s` seconds at the cell's own load, the check),
printing the program's compared numbers (the lower readings), and the
control's: the float8 reference in the program's place on the same
sampled frames (the upper readings), each judged by the cell's limits.
One JSON line a seed, then on standard error how many seeds the program
and the control each passed; it exits 1 where the control passed on
any seed or the program failed on one.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from perfbench.run import use_checkout_caches

    use_checkout_caches()
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 3
    from perfbench import harness

    passed = {"program": 0, "control": 0}
    for seed in args.seeds:
        res = harness.run_cell(args.workload, seed, args.seconds, False,
                               time.monotonic(), control=True)
        passed["program"] += res["correct"]
        passed["control"] += res["control_correct"]
        print(json.dumps({
            "seed": seed, "correct": res["correct"],
            "control_correct": res["control_correct"],
            "frames": res["attempted"],
            "program": {k: v["value"] for k, v in res["checks"].items()},
            "control": {k: v["value"] for k, v in res["control"].items()},
            "limits": {k: v["limit"] for k, v in res["checks"].items()}}),
            flush=True)
    n = len(args.seeds)
    print(f"{args.workload}: the program correct on {passed['program']} of "
          f"{n} seeds, the control on {passed['control']} of {n}",
          file=sys.stderr)
    return 0 if passed == {"program": n, "control": 0} else 1


if __name__ == "__main__":
    sys.exit(main())

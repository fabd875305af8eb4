"""Run one cell of BENCHMARK.json once and print its result line.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Runs on the machine it is started on, on one CUDA card; without one (or
with fewer cards than the cell asks for), without the port beside it, or
with JAX or the JAX package loaded once the window has closed, it exits
with a code other than 0 and prints no result. The last line of
standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``,
and last ``checks``: each number compared with its limit); the last
lines of standard error repeat the checks.
"""
import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "perfbench"


def use_checkout_caches() -> None:
    """Every build and kernel cache at a fixed place in the checkout."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


def emit(result: dict, out=None, err=None) -> None:
    """The checks on standard error, then the result line on standard
    output (its ``checks`` key last)."""
    out, err = out or sys.stdout, err or sys.stderr
    checks = result.pop("checks")
    result["checks"] = checks
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=err)
    err.flush()
    print(json.dumps(result), file=out, flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    use_checkout_caches()
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"]
                 if w["name"] == args.workload), None)
    if cell is None:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < int(cell["chips"]):
        print(f"needs {cell['chips']} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    try:
        import trex_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"the port is not beside the benchmark: {e}", file=sys.stderr)
        return 2
    from perfbench import harness

    torch.cuda.set_device(0)
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"JAX or the JAX package was loaded: {bad}", file=sys.stderr)
        return 4
    emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())

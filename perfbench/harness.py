"""One run of one cell: set-up, the measured window, the trace, the check.

The cell, its configuration, its traffic and its limits are data, found
by name (``BENCHMARK.json``; ``perfbench/configs``, ``perfbench/traffic``,
``perfbench/limits``), and each per-layer metric is a reader of its own
in ``perfbench/metrics/<name>.py``. A later cell adds files; nothing
here names one.

The system under test is the port's detection facade:
``trex_tpu_torch.detect.base.create_detection(settings)`` with
``detect_type=yolo`` and the checkpoint this run wrote, then
``apply(frame_index, image)`` on one frame after another, one frame in
flight (a lab converting a recorded video).
"""
from __future__ import annotations

import gc
import importlib.util
import json
import math
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from . import flops, scene, trace as tracing, weights
from .reference import compare, postprocess, yolov8

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "trex_tpu")
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3


def forbidden_modules() -> list[str]:
    """Loaded modules whose whole top-level name is JAX's or the JAX
    package's."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def load_cell(workload: str) -> dict:
    """The cell's entry, its configuration, traffic and limits, by name."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    cfg_entry = next(c for c in bench["configs"]
                     if c["name"] == cell["config"])
    return {
        "bench": bench, "cell": cell,
        "config": json.loads((ROOT / cfg_entry["file"]).read_text()),
        "traffic": json.loads((ROOT / "perfbench" / "traffic"
                               / f"{cell['traffic']}.json").read_text()),
        "limits": json.loads((ROOT / "perfbench" / "limits"
                              / f"{workload}.json").read_text()),
    }


def metric_readers(bench: dict, workload: str) -> dict:
    """name -> read(trace) of every per-layer metric of `workload`."""
    out = {}
    for m in bench["per_layer"]:
        if workload not in m.get("workloads", [workload]):
            continue
        path = ROOT / "perfbench" / "metrics" / f"{m['name']}.py"
        spec = importlib.util.spec_from_file_location(
            f"perfbench_metric_{len(out)}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out[m["name"]] = (mod.read, m["unit"])
    return out


def _settings(values: dict):
    from trex_tpu_torch.config.registry import Settings

    s = Settings()
    for k, v in values.items():
        s.set(k, v)
    return s


class Reservoir:
    """A uniform sample of `k` of the window's frames, drawn from the
    seed, without knowing in advance how many the window holds."""

    def __init__(self, k: int, seed: int):
        self.k, self.seen, self.items = k, 0, []
        self.rng = np.random.default_rng([seed, 7])

    def offer(self, make):
        if self.seen < self.k:
            self.items.append(make())
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                self.items[j] = make()
        self.seen += 1


def _device_info(dev) -> dict:
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": 1}


def card_and_power_limit() -> str:
    """``nvidia-smi``'s name and power limit of the card, for the log."""
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             t_start: float, device: str = "cuda",
             overrides: dict | None = None, log=print,
             control: bool = False) -> dict:
    """One run; returns the result line's object (``checks`` last).
    With `control`, also ``control`` and ``control_correct``: the row
    numbers of the float8 reference put in the program's place, each
    beside the cell's limit, and the verdict they give
    (``control.py``; the benchmark's own runs do not compute it)."""
    from trex_tpu_torch.detect import base as det_base
    from trex_tpu_torch.detect import yolo as det_yolo
    from trex_tpu_torch.detect.base import create_detection

    spec = load_cell(workload)
    for part, over in (overrides or {}).items():
        spec[part] = {**spec[part], **over}
    config, traffic, bench = spec["config"], spec["traffic"], spec["bench"]
    dev = torch.device(device)
    seed = int(seed) % (1 << 63)
    settings = {**config["settings"], **traffic.get("settings", {})}
    size = int(config["imgsz"])

    # ---- set-up --------------------------------------------------------
    # setup_s is the user's: the imports, the card's context, the frame
    # pool, the checkpoint's load and the warm-up. The benchmark's own
    # work (seeded weights, their calibration by the reference forward,
    # the checkpoint's write, the reference's copy of the weights) lies
    # between `own_from` and `own_to` and is left out of it.
    stages = {"imports": time.monotonic() - t_start}
    if dev.type == "cuda":
        # the card's context and cuDNN's load, which the reference's
        # calibration below would otherwise be the first to pay
        torch.nn.functional.conv2d(torch.zeros(1, 1, 4, 4, device=dev),
                                   torch.zeros(1, 1, 3, 3, device=dev))
        torch.cuda.synchronize(dev)
    stages["context"] = time.monotonic() - t_start
    frames = scene.make_pool(traffic, seed)
    stages["pool"] = own_from = time.monotonic() - t_start
    model = weights.calibrated(
        config, traffic, settings, frames, seed, dev,
        stat_frames=int(traffic.get("calibration_frames", 1)))
    tmp = Path(tempfile.mkdtemp(prefix="perfbench-", dir=os.environ.get(
        "TMPDIR")))
    try:
        stages["weights"] = time.monotonic() - t_start
        ckpt = tmp / f"{config['name']}.pt"
        weights.write_checkpoint(model, ckpt)
        stages["checkpoint"] = time.monotonic() - t_start
        ref_state = {k: v.detach().to("cpu", copy=True)
                     for k, v in model.state_dict().items()}
        del model
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        own_to = time.monotonic() - t_start
        backend = create_detection(_settings(
            {**settings, "detect_type": "yolo", "detect_model": str(ckpt)}),
            device=dev)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    stages["load"] = time.monotonic() - t_start
    detector = backend.detector
    captured = []
    infer = detector._infer

    def capture_infer(canvas):
        out = infer(canvas)
        captured.append(out)
        return out

    detector._infer = capture_infer
    for i in range(int(traffic.get("warmup_frames", 2))):
        backend.apply(i, frames[i % len(frames)])
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    stages["warm-up"] = time.monotonic() - t_start
    setup_s = stages["warm-up"] - (own_to - own_from)
    log("set-up s at the end of each stage: " + ", ".join(
        f"{k} {v:.2f}" for k, v in stages.items())
        + f"; the benchmark's own {own_to - own_from:.2f} left out: "
        f"setup_s {setup_s:.2f}", file=sys.stderr)

    # ---- the window -----------------------------------------------------
    spans = tracing.Spans(trace)
    patches = []
    if trace:
        patches = spans.wrap_port(detector, det_yolo, det_base)
    sample = Reservoir(int(traffic.get("check_frames", 4)), seed)
    apply_s = []
    attempted = failed = 0
    prof = tracing.profiler(dev) if trace else None
    try:
        if prof is not None:
            prof.__enter__()
        t0 = time.monotonic()
        t_end = t0 + seconds
        i = 0
        while time.monotonic() < t_end:
            k = i % len(frames)
            captured.clear()
            attempted += 1
            a = time.monotonic()
            try:
                with spans("apply"):
                    blobs = backend.apply(i, frames[k])
            except Exception as e:  # a failed frame counts, the run goes on
                failed += 1
                log(f"frame {i}: {type(e).__name__}: {e}", file=sys.stderr)
                blobs = None
            apply_s.append(time.monotonic() - a)
            if blobs is not None:
                rows, got = list(captured), blobs
                sample.offer(lambda: (k, rows, got))
            i += 1
        window_s = time.monotonic() - t0
    finally:
        if prof is not None:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            prof.__exit__(None, None, None)
        for restore in patches:
            restore()
    done = attempted - failed
    memory_peak = torch.cuda.max_memory_allocated(dev) \
        if dev.type == "cuda" else 0

    result = {"correct": False, "attempted": attempted, "failed": failed,
              "metrics": {}, "device": {**_device_info(dev),
                                        "memory_peak_bytes": memory_peak}}
    cost = flops.forward_cost(config, 1, 2)
    tiles = postprocess.tile_bounds(
        frames[0].shape[1], frames[0].shape[0], size,
        int(settings.get("detect_tile_target_width", 0)),
        int(settings.get("detect_tile_image", 0)),
        float(settings.get("detect_tile_overlap", 0.0)))
    if trace:
        tr = tracing.reduce(prof, frames=done,
                            tiles_per_frame=len(tiles),
                            flops_per_tile=cost["flops"],
                            bytes_per_tile=cost["bytes"],
                            peak_flops=PEAK_FLOPS[config["dtype"]],
                            peak_bytes_per_s=PEAK_BYTES_PER_S,
                            apply_s=apply_s)
        del prof
        result["device"]["busy_s"] = tr.busy_s
        result["device"]["window_s"] = tr.window_s
        for name, (read, unit) in metric_readers(bench, workload).items():
            value = read(tr)
            if value is not None:
                result["metrics"][name] = {"value": value, "unit": unit}
        result["breakdown"] = tr.breakdown()
        outside = tr.device_s({"kernel"}) - tr.device_s({"kernel"}, "forward")
        n_outside = len(tr.device_intervals({"kernel"})) - len(
            tr.device_intervals({"kernel"}, "forward"))
        log(f"traced frames {done}, apply samples {len(apply_s)}; kernels "
            f"launched outside the forward {n_outside}, "
            f"{1e3 * outside:.3f} ms; card {card_and_power_limit()}",
            file=sys.stderr)
    else:
        e2e = {"frames_per_s": done / window_s, "setup_s": setup_s}
        for m in bench["end_to_end"]:
            if workload in m.get("workloads", [workload]):
                result["metrics"][m["name"]] = {"value": e2e[m["name"]],
                                                "unit": m["unit"]}

    # ---- the check, once the window has closed ---------------------------
    detector._infer = infer
    del backend, detector, infer
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    numbers = check(config, settings, frames, sample.items, ref_state, dev)
    if control:
        # the control judged as the program is, by the cell's limits
        ctl_ok, result["control"] = compare.verdict(control_rows(
            config, settings, frames, sample.items, ref_state, dev),
            spec["limits"])
        result["control_correct"] = bool(ctl_ok and done > 0)
    ok, checks = compare.verdict(numbers, spec["limits"])
    result["correct"] = bool(ok and failed == 0 and done > 0)
    result["checks"] = checks
    return result


def reference_rows(model, tiles_u8: np.ndarray, config: dict, dev,
                   block: int = 8) -> dict:
    """The reference's decoded rows of (T, S, S, 3) uint8 tiles, in
    blocks of `block` tiles, as numpy arrays."""
    parts = []
    with torch.no_grad(), yolov8.no_tf32():
        for i in range(0, len(tiles_u8), block):
            x = torch.from_numpy(tiles_u8[i:i + block]).to(dev).permute(
                0, 3, 1, 2)
            dec = yolov8.decode(model(x), config["task"],
                                config.get("kpt_shape", (17, 3)))
            parts.append({k: v.cpu().numpy() for k, v in dec.items()})
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def reference_model(config: dict, state: dict, dev, fp8: bool = False):
    model = yolov8.YOLOv8(config["scale"], config["task"], config["nc"],
                          config.get("kpt_shape", (17, 3)))
    model.load_state_dict({k: v.float() for k, v in state.items()})
    return yolov8.set_mode(model.to(dev).eval(), fp8=fp8)


def check(config, settings, frames, sample, state, dev) -> dict:
    """The compared numbers over the sampled frames: the worst frame's
    row gaps, and all frames' blob mismatches."""
    if not sample:
        return {"rows.score": math.inf, "rows.geometry": math.inf,
                "blobs.mismatched": math.inf}
    model = reference_model(config, state, dev)
    worst = {"rows.score": 0.0, "rows.geometry": 0.0}
    mismatched = 0
    for k, rows_list, blobs in sample:
        tiles = weights.tiles_of([frames[k]], config, settings)
        ref = reference_rows(model, tiles, config, dev)
        prog = {key: np.concatenate([r[key] for r in rows_list])
                for key in rows_list[0]} if rows_list else {}
        for name, v in compare.row_gaps(prog, ref, config["task"]).items():
            worst[name] = max(worst[name], v)
        want = postprocess.frame_blobs(prog, frames[k], int(
            config["imgsz"]), settings, config["task"]) if rows_list else []
        mismatched += compare.blob_mismatches(
            [compare.program_blob(b) for b in blobs], want)
    del model
    return {**worst, "blobs.mismatched": mismatched}


def control_rows(config, settings, frames, sample, state, dev) -> dict:
    """The row numbers of the control: the reference with its
    convolutions' inputs and weights in float8 e4m3, one step below the
    configuration's bfloat16, against the float32 reference, on the
    same sampled frames."""
    ref = reference_model(config, state, dev)
    low = reference_model(config, state, dev, fp8=True)
    worst = {"rows.score": 0.0, "rows.geometry": 0.0}
    for k, _, _ in sample:
        tiles = weights.tiles_of([frames[k]], config, settings)
        want = reference_rows(ref, tiles, config, dev)
        got = reference_rows(low, tiles, config, dev)
        for name, v in compare.row_gaps(got, want, config["task"]).items():
            worst[name] = max(worst[name], v)
    return worst

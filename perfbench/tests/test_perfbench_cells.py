"""Dry runs of each cell on the CPU at a tiny size, and the pieces of
the yardstick: tiles, operation counts, the reference against the port,
the isolation from JAX, and a cell added as data alone."""
import io
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
from conftest import ROOT, TINY, WORKLOADS

from perfbench import flops, harness, run
from perfbench.reference import compare, postprocess, yolov8


def dry_run(workload, trace=False, seed=2**31 + 11, overrides=None):
    res = harness.run_cell(workload, seed, 1.5, trace, time.monotonic(),
                           device="cpu", overrides=overrides or TINY,
                           log=lambda *a, **k: None)
    out, err = io.StringIO(), io.StringIO()
    run.emit(res, out, err)
    return json.loads(out.getvalue().strip().splitlines()[-1]), err.getvalue()


@pytest.mark.parametrize("workload", WORKLOADS)
def test_dry_run_prints_one_contract_line(workload):
    line, err = dry_run(workload)
    assert list(line)[-1] == "checks"
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in line
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    assert set(line["metrics"]) == {"frames_per_s", "setup_s"}
    assert all(m["value"] > 0 for m in line["metrics"].values())
    assert err.strip().splitlines()[-1].startswith("check blobs.mismatched")


def test_traced_dry_run_reads_the_host_spans():
    line, _ = dry_run(WORKLOADS[0], trace=True)
    assert line["correct"] is True
    # no card: the device metrics read nothing and stay out of the line
    assert {"detect.host_ms", "merge.ms", "blobs.ms", "mfu"} <= \
        set(line["metrics"])
    assert "yolo.forward_roofline" not in line["metrics"]
    assert line["device"]["window_s"] > 0 and "breakdown" in line


@pytest.mark.parametrize("workload,edge,tiles", [
    (WORKLOADS[0], 640, 28), (WORKLOADS[1], 1024, 15)])
def test_4k_frames_cut_into_the_cells_tiles(workload, edge, tiles):
    from trex_tpu_torch.detect.tiling import compute_tile_bounds

    spec = harness.load_cell(workload)
    s = {**spec["config"]["settings"], **spec["traffic"]["settings"]}
    t = spec["traffic"]
    port = compute_tile_bounds((t["width"], t["height"]), (edge, edge),
                               s["detect_tile_target_width"], 0,
                               s["detect_tile_overlap"])
    ref = postprocess.tile_bounds(t["width"], t["height"], edge,
                                  s["detect_tile_target_width"], 0,
                                  s["detect_tile_overlap"])
    assert len(port) == tiles and [tuple(map(int, b)) for b in port] == ref
    assert s["detect_batch_size"] >= tiles  # one forward a frame


@pytest.mark.parametrize("workload", WORKLOADS)
def test_operation_count_within_2_percent_of_the_published(workload):
    config = harness.load_cell(workload)["config"]
    cost = flops.forward_cost(config)
    pub = config["published"]
    assert abs(cost["flops"] / 1e9 / pub["GFLOPs"] - 1) < 0.02
    assert abs(cost["params"] / 1e6 / pub["params_M"] - 1) < 0.02
    assert cost["bytes"] > 0


def _same_weights(task):
    """The reference at scale n with seeded weights, and the port's model
    built from the same checkpoint in float32."""
    from trex_tpu_torch.models.yolo import build
    from trex_tpu_torch.models.yolo_convert import (convert_state_dict,
                                                    extract_state_dict)

    nc = 1 if task == "pose" else 15
    cfg = {"scale": "n", "task": task, "nc": nc, "kpt_shape": [17, 3]}
    from perfbench import weights

    ref = weights.random_model(cfg, torch.Generator().manual_seed(3), "cpu",
                               15.0)
    sd = extract_state_dict({"model": ref})
    kw = {"num_keypoints": 17, "kpt_dims": 3} if task == "pose" else {}
    port = build(nc, "n", task, dtype=torch.float32, device="cpu",
                 state=convert_state_dict(sd, "n", task), **kw)
    return cfg, ref, port


@pytest.mark.parametrize("task", ["pose", "obb"])
def test_reference_rows_match_the_port_in_float32(task):
    from trex_tpu_torch.models.yolo import decode_predictions

    cfg, ref, port = _same_weights(task)
    x = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (2, 3, 160, 160), dtype=np.uint8))
    with torch.no_grad():
        want = yolov8.decode(ref(x), task)
        got = decode_predictions(port(x), cfg["nc"])
    gaps = compare.row_gaps({k: got[k].numpy() for k in want if k in got},
                            {k: v.numpy() for k, v in want.items()}, task)
    assert gaps["rows.score"] < 1e-4 and gaps["rows.geometry"] < 1e-5


def test_reference_postprocess_matches_the_port_on_shared_rows():
    """The port's threshold, NMS, merge and blobs against the reference's
    from the same rows (many detections, crowded tiles)."""
    for workload in WORKLOADS:
        line, _ = dry_run(workload, overrides={
            **TINY, "traffic": {**TINY["traffic"], "animals": 40}})
        assert line["checks"]["blobs.mismatched"]["value"] == 0


def test_isolation_nothing_of_jax_is_loaded():
    code = (
        "import sys, time; sys.path.insert(0, %r);"
        "sys.path.insert(0, %r);"
        "from conftest import TINY; from perfbench import harness;"
        "harness.run_cell(%r, 5, 1.0, False, time.monotonic(),"
        " device='cpu', overrides=TINY, log=lambda *a, **k: None);"
        "print(sorted({m.split('.')[0] for m in sys.modules}))"
        % (str(ROOT), str(ROOT / "perfbench" / "tests"), WORKLOADS[0]))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=ROOT).stdout
    loaded = set(json.loads(out.strip().splitlines()[-1].replace("'", '"')))
    assert "trex_tpu_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "optax", "trex_tpu"}


def test_a_cell_added_as_data_runs_without_a_code_edit(tmp_path):
    for part in ("perfbench", "trex_tpu_torch"):
        shutil.copytree(ROOT / part, tmp_path / part, ignore=shutil.
                        ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (tmp_path / "perfbench" / "traffic" / "small-8.json").write_text(
        json.dumps({"name": "small-8", "width": 640, "height": 360,
                    "animals": 8, "stamp_scale": 1, "pool": 2,
                    "steps_between": 3, "calibration_frames": 1,
                    "warmup_frames": 1, "check_frames": 1,
                    "settings": {"detect_tile_overlap": 0.2}}))
    name = "yolov8x-pose.small-8"
    bench["workloads"].append({"name": name, "config": "yolov8x-pose",
                               "traffic": "small-8", "chips": 1,
                               "why": "a test cell"})
    for m in bench["per_layer"]:
        m["workloads"].append(name)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    shutil.copy(ROOT / "perfbench" / "limits" / f"{WORKLOADS[0]}.json",
                tmp_path / "perfbench" / "limits" / f"{name}.json")
    code = (
        "import io, json, sys, time; sys.path.insert(0, '.');"
        "from perfbench import harness, run;"
        "res = harness.run_cell(%r, 9, 1.0, True, time.monotonic(),"
        " device='cpu', overrides={'config': %r},"
        " log=lambda *a, **k: None);"
        "run.emit(res)" % (name, TINY["config"]))
    env = {**os.environ, "PYTHONPATH": ""}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=tmp_path, env=env).stdout
    line = json.loads(out.strip().splitlines()[-1])
    assert line["correct"] is True and "merge.ms" in line["metrics"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_a_short_run_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", workload,
         "--seed", str(2**31 + 3), "--seconds", "3", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, check=True).stdout
    line = json.loads(out.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"


def test_idle_gaps_go_to_the_innermost_open_span():
    from perfbench.trace import Trace

    t = Trace(spans={"apply": np.array([[0.0, 5.0]]),
                     "merge": np.array([[1.0, 2.0]]),
                     "prepare": np.array([[2.5, 3.5]])},
              device=[("k", "kernel", 0.0, 1.0, 0.0),
                      ("m", "memcpy", 3.0, 4.0, 2.9)],
              window=(0.0, 5.0), frames=1, tiles_per_frame=1,
              flops_per_tile=1.0, bytes_per_tile=1.0, peak_flops=1.0,
              peak_bytes_per_s=1.0)
    gaps = dict(t.breakdown()["idle_gaps"])
    assert gaps == {"host:apply": 1.5, "host:merge": 1.0,
                    "host:prepare": 0.5}
    assert t.busy_s == 2.0


def test_kernels_belong_to_the_span_they_were_launched_in():
    """A kernel counts in the forward by where it was launched, however
    late the card ran it; kernels launched elsewhere in apply, or linked
    to no launch, stay out of it."""
    from perfbench.trace import Trace

    forward = [(f"conv{i}", "kernel", 1.5 + i, 2.0 + i, 1.1 + 0.1 * i)
               for i in range(3)]
    t = Trace(spans={"apply": np.array([[0.0, 9.0]]),
                     "forward": np.array([[1.0, 1.4]]),
                     "gray": np.array([[0.2, 0.8]])},
              device=forward + [("gray", "kernel", 0.5, 0.7, 0.3),
                                ("late", "kernel", 6.0, 7.0, 5.0),
                                ("unlinked", "kernel", 7.0, 8.0, np.nan),
                                ("up", "memcpy", 1.2, 1.3, 1.05)],
              window=(0.0, 9.0), frames=1, tiles_per_frame=1,
              flops_per_tile=1.0, bytes_per_tile=1.0, peak_flops=1.0,
              peak_bytes_per_s=1.0)
    assert t.device_s({"kernel"}, "forward") == pytest.approx(1.5)
    assert t.device_s({"kernel"}) == pytest.approx(3.7)
    read = {name: harness.metric_readers(harness.load_cell(WORKLOADS[0])[
        "bench"], WORKLOADS[0])[name][0] for name in (
        "yolo.forward_device_ms", "yolo.forward_roofline",
        "transfer.device_ms")}
    assert read["yolo.forward_device_ms"](t) == pytest.approx(1500.0)
    assert read["yolo.forward_roofline"](t) == pytest.approx(100 / 1.5)
    assert read["transfer.device_ms"](t) == pytest.approx(100.0)
    t.spans.pop("forward")
    assert read["yolo.forward_device_ms"](t) is None

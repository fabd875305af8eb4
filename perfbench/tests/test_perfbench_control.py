"""The comparison that decides ``correct`` fails where it must: the
control (the reference in float8 in the program's place) and faults
planted in the timed path underneath a whole run.

The runs skip the harness's look for a card (``device="cpu"``) at the
tiny size of ``conftest.TINY``. The limits there are the tiny size's
own (a scale-n model at a 320 input departs less than the cells' x
model): the program's numbers are read at that size, and the control
and each fault have to read past them by the same margins the cells'
limits keep.
"""
import time

import numpy as np
import pytest
import torch
from conftest import TINY, WORKLOADS

from perfbench import harness


def run(workload, limits=None, control=False, seed=17):
    over = dict(TINY)
    if limits is not None:
        over["limits"] = limits
    return harness.run_cell(workload, seed, 1.5, False, time.monotonic(),
                            device="cpu", overrides=over,
                            log=lambda *a, **k: None, control=control)


def tiny_limits(sound):
    """The tiny size's limits, set from its sound run as the cells' are
    from theirs: about three times the program's reading."""
    limits = {k: v["value"] * 3 + 1e-9 for k, v in sound["checks"].items()}
    limits["blobs.mismatched"] = 0
    return limits


@pytest.mark.parametrize("workload", WORKLOADS)
def test_the_float8_control_reads_far_past_the_program(workload):
    sound = run(workload)
    assert sound["correct"] is True
    res = run(workload, limits=tiny_limits(sound), control=True)
    assert res["correct"] is True, res["checks"]
    # judged by the harness's own comparison, the control fails
    assert res["control_correct"] is False, res["control"]
    assert set(res["control"]) == {"rows.score", "rows.geometry"}
    assert all(c["limit"] is not None for c in res["control"].values())


def _one_blob_moved(monkeypatch):
    import trex_tpu_torch.detect.yolo as y

    for name in ("boxes_to_blobs", "obbs_to_blobs"):
        orig = getattr(y, name)

        def moved(*a, _orig=orig, **k):
            blobs = _orig(*a, **k)
            if blobs:
                blobs[0].lines = blobs[0].lines.copy()
                blobs[0].lines[:, 1:] += 3
            return blobs
        monkeypatch.setattr(y, name, moved)


def _half_the_tiles(monkeypatch):
    """Half of a frame's tiles forwarded; their rows stand in for the
    other half."""
    from trex_tpu_torch.detect.yolo import YOLODetector

    orig = YOLODetector.infer_device

    def half(self, canvas):
        h = max(1, len(canvas) // 2)
        dec = orig(self, canvas[:h])
        reps = -(-len(canvas) // h)
        return {k: torch.cat([v] * reps)[:len(canvas)]
                if torch.is_tensor(v) and v.dim() and v.shape[0] == h
                else v for k, v in dec.items()}
    monkeypatch.setattr(YOLODetector, "infer_device", half)


def _scores_altered(monkeypatch):
    """One tile's scores replaced by the next tile's, where the decode
    produces them."""
    from trex_tpu_torch.detect.yolo import YOLODetector

    orig = YOLODetector.infer_device

    def swapped(self, canvas):
        dec = orig(self, canvas)
        dec["conf"] = dec["conf"].roll(1, 0)
        return dec
    monkeypatch.setattr(YOLODetector, "infer_device", swapped)


FAULTS = {"an answer altered where it is produced": _one_blob_moved,
          "half of the batch left out": _half_the_tiles,
          "scores altered in the decode": _scores_altered}


@pytest.mark.parametrize("workload", WORKLOADS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_fault_underneath_makes_the_run_incorrect(workload, fault,
                                                    monkeypatch):
    sound = run(workload)
    assert sound["correct"] is True
    FAULTS[fault](monkeypatch)
    res = run(workload, limits=tiny_limits(sound))
    assert res["correct"] is False, res["checks"]


def test_row_gaps_are_infinite_for_missing_rows():
    from perfbench.reference import compare

    ref = {"conf": np.ones((2, 5)), "boxes": np.ones((2, 5, 4))}
    got = compare.row_gaps({"conf": np.ones((1, 5)),
                            "boxes": np.ones((1, 5, 4))}, ref, "detect")
    assert got["rows.score"] == float("inf")

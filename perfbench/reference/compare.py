"""The numbers that decide ``correct``, each beside its limit.

Two stages, because a bfloat16 forward and its float32 reference do not
pass the same anchors over the threshold (a score near the threshold
moves by rounding), so the reference cannot rebuild the same detections
from its own rows:

1. The decoded rows of every tile of a sampled frame, the program's
   (its forward and decode on the card, as the timed path brought them
   to the host) against the reference's float32 forward and decode of
   the same tiles: ``rows.score`` is the RMS gap of the best class's
   score logits over all anchors, over the spread (standard deviation)
   of the reference's; ``rows.geometry`` is the RMS gap of every box
   coordinate and keypoint or oriented-box centre and side, in pixels,
   over the RMS side of the reference's boxes.
2. From the program's own rows onwards, the reference's threshold,
   NMS, scale-back, tile merge and rasterisation against the blobs that
   ``apply`` returned: ``blobs.mismatched`` counts the blobs of either
   side with no counterpart of the same class and score on the other,
   and the counterparts whose rows or pixels differ (a scanline end may
   part by one pixel of rounding between the program's float32
   geometry and the reference's float64).
"""
from __future__ import annotations

import numpy as np

LOGIT_CLAMP = 1e-7


def _logit(conf):
    c = np.clip(np.asarray(conf, np.float64), LOGIT_CLAMP, 1 - LOGIT_CLAMP)
    return np.log(c / (1 - c))


def _geometry(rows, task):
    parts = [np.asarray(rows["boxes"], np.float64).reshape(-1, 4)]
    if task == "pose":
        kp = np.asarray(rows["keypoints"], np.float64)
        parts.append(kp[..., :2].reshape(-1, 2))
    if task == "obb":
        parts.append(np.asarray(rows["obb"], np.float64)[..., :4]
                     .reshape(-1, 4))
    return parts


def row_gaps(program: dict, reference: dict, task: str) -> dict:
    """``rows.score`` and ``rows.geometry`` of one frame's tiles; inf
    where the program's rows do not have the reference's shape."""
    if any(np.shape(program.get(k)) != np.shape(reference[k])
           for k in reference if k != "logit"):
        return {"rows.score": float("inf"), "rows.geometry": float("inf")}
    lp, lr = _logit(program["conf"]), _logit(reference["conf"])
    score = float(np.sqrt(np.mean((lp - lr) ** 2)) / max(lr.std(), 1e-12))
    rb = np.asarray(reference["boxes"], np.float64).reshape(-1, 4)
    side = np.sqrt(np.mean((rb[:, 2:] - rb[:, :2]) ** 2))
    sq = n = 0.0
    for a, b in zip(_geometry(program, task), _geometry(reference, task)):
        sq += float(((a - b) ** 2).sum())
        n += a.size
    geometry = float(np.sqrt(sq / n) / max(side, 1e-12))
    return {"rows.score": score, "rows.geometry": geometry}


def _rows_of(blob):
    return {int(y): (int(a), int(b)) for y, a, b in blob["lines"]}


def _same(a, b, px_tol=1):
    ra, rb = _rows_of(a), _rows_of(b)
    if not ra or not rb:
        return ra == rb
    ya, yb = sorted(ra), sorted(rb)
    if abs(ya[0] - yb[0]) > px_tol or abs(ya[-1] - yb[-1]) > px_tol:
        return False
    pa = dict(zip(ra, np.split(a["pixels"], np.cumsum(
        [ra[y][1] - ra[y][0] + 1 for y in ra])[:-1])))
    pb = dict(zip(rb, np.split(b["pixels"], np.cumsum(
        [rb[y][1] - rb[y][0] + 1 for y in rb])[:-1])))
    for y in set(ra) & set(rb):
        (a0, a1), (b0, b1) = ra[y], rb[y]
        if abs(a0 - b0) > px_tol or abs(a1 - b1) > px_tol:
            return False
        if (a0, a1) == (b0, b1) and not np.array_equal(pa[y], pb[y]):
            return False
    return True


def blob_mismatches(program: list, reference: list) -> int:
    """Blobs of either side without an equal counterpart (same class and
    score, rows within a pixel, pixels equal where the rows are)."""
    left = list(reference)
    bad = 0
    for b in program:
        hit = next((i for i, r in enumerate(left)
                    if r["clid"] == b["clid"] and r["p"] == b["p"]
                    and _same(b, r)), None)
        if hit is None:
            bad += 1
        else:
            left.pop(hit)
    return bad + len(left)


def program_blob(blob) -> dict:
    """A blob ``apply`` returned, in the reference's form."""
    pred = blob.prediction or {}
    return {"clid": int(pred.get("clid", -1)), "p": float(pred.get("p", -1)),
            "lines": np.asarray(blob.lines, np.int64),
            "pixels": np.asarray(blob.pixels).reshape(-1)}


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): every number at most its
    limit (a number without a limit fails)."""
    out = {k: {"value": v, "limit": limits.get(k)} for k, v in
           numbers.items()}
    ok = all(d["limit"] is not None and d["value"] <= d["limit"]
             for d in out.values())
    return ok, out

"""The port's auto_tags (trex_tpu_torch/ml/auto_tags.py) against the JAX
package's, the twin of tests/test_ml.py's auto_tags cases: the
per-tracklet tag votes, the conflict-free assignment, the manual matches
and the tag detections' round trip through .results. Votes and
probabilities equal bit for bit (the same numpy code on the same
values)."""
import numpy as np
import pytest

from test_torch_accumulation import GAPS, toy_tracker
from trex_tpu.config import reset_global_settings as jax_reset
from trex_tpu.ml.auto_tags import apply_tags as jax_apply_tags
from trex_tpu.ml.auto_tags import \
    tag_tracklet_predictions as jax_predictions
from trex_tpu.track.blob import TrackBlob as JaxTrackBlob
from trex_tpu.track.tracker import Tracker as JaxTracker
from trex_tpu_torch.config import reset_global_settings
from trex_tpu_torch.ml.auto_tags import apply_tags, tag_tracklet_predictions
from trex_tpu_torch.track.blob import TrackBlob
from trex_tpu_torch.track.tracker import Tracker


def _both(gaps=frozenset()):
    return (toy_tracker(jax_reset, JaxTracker, JaxTrackBlob, gaps=gaps),
            toy_tracker(reset_global_settings, Tracker, TrackBlob,
                        gaps=gaps))


def _tags(tracker, shift=1, every=2, p=1.0, noise=None):
    """tests/test_ml.py's detections: tag (fid + shift) % 3 rides on fish
    fid's blob every `every` frames; `noise` adds a wrong, less confident
    claim on some blobs."""
    tags = {}
    for fid, ind in sorted(tracker.individuals.items()):
        tid = (fid + shift) % 3
        dets = tags.setdefault(tid, {})
        for f in range(0, 30, every):
            b = ind.basic_stuff(f)
            if b is not None:
                dets[f] = (int(b.blob.blob_id), p)
    if noise is not None:
        for fid, ind in sorted(tracker.individuals.items()):
            b = ind.basic_stuff(noise)
            if b is not None:
                tags.setdefault(3, {})[noise] = (int(b.blob.blob_id), 0.25)
    return tags


def _preds_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert (x.fid, x.range, x.samples) == (y.fid, y.range, y.samples)
        assert x.probs.tobytes() == y.probs.tobytes()


@pytest.mark.parametrize("gaps", [frozenset(), GAPS], ids=["whole", "gaps"])
@pytest.mark.parametrize("kw", [dict(), dict(shift=2, every=3, p=0.6),
                                dict(every=1, noise=4)],
                         ids=["every2", "every3", "noise"])
def test_auto_tags_votes_and_assignment(gaps, kw):
    (jt, js), (pt, ps) = _both(gaps)
    jtags, ptags = _tags(jt, **kw), _tags(pt, **kw)
    assert jtags == ptags
    jp, pp = jax_predictions(jt, jtags), tag_tracklet_predictions(pt, ptags)
    _preds_equal(jp, pp)
    assert pp
    for p in pp:
        if "noise" not in kw:
            assert p.probs.argmax() == (p.fid + kw.get("shift", 1)) % 3
    jm, jc = jax_apply_tags(jt, js, jtags)
    pm, pc = apply_tags(pt, ps, ptags)
    assert pm == jm
    assert (pc.reassigned, pc.skipped) == (jc.reassigned, jc.skipped)
    assert pc.ranges == jc.ranges
    assert pm


def test_apply_tags_retrack_fn_and_empty():
    (jt, js), (pt, ps) = _both()
    seen = []
    out, corr = apply_tags(pt, ps, _tags(pt),
                           retrack_fn=lambda m: seen.append(m) or "done")
    assert out == "done" and seen and corr.ranges
    assert tag_tracklet_predictions(pt, {}) == []
    m, c = apply_tags(pt, ps, {})
    jm, jc = jax_apply_tags(jt, js, {})
    assert m == jm and c.ranges == jc.ranges


def test_auto_tags_roundtrip_through_results(tmp_path):
    """tests/test_ml.py::test_auto_tags_roundtrip_through_results: the
    Hungarian matcher's assignments go into .results and come back as
    `loaded_tags`, in both packages, from either package's file."""
    from trex_tpu.export.results import load_results as jax_load
    from trex_tpu.export.results import save_results as jax_save
    from trex_tpu_torch.export.results import load_results, save_results

    (jt, js), (pt, ps) = _both()
    for t in (jt, pt):
        t.tag_assignments = {3: {0: 2}, 5: {0: 2}}
        t.tag_assignment_p = {3: {0: 0.75}, 5: {0: 0.5}}
    jax_save(jt, js, tmp_path / "j.results")
    save_results(pt, ps, tmp_path / "p.results")
    assert (tmp_path / "j.results").read_bytes() \
        == (tmp_path / "p.results").read_bytes()
    bg = np.full((120, 120), 200, np.uint8)
    for path in (tmp_path / "j.results", tmp_path / "p.results"):
        j2 = JaxTracker(js, background=bg)
        p2 = Tracker(ps, background=bg)
        jax_load(j2, path)
        load_results(p2, path)
        assert p2.loaded_tags == j2.loaded_tags
        assert 2 in p2.loaded_tags
        b3 = pt.individuals[0].basic_stuff(3)
        assert p2.loaded_tags[2][3][0] == int(b3.blob.blob_id)

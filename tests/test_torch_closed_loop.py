"""The closed loop (trex_tpu_torch/closed_loop.py) against the JAX
package's (trex_tpu/closed_loop.py): the cases of tests/test_aux.py
(the loop over the object Tracker with a user module; closed_loop_enable
through TrackingState) through both packages, the user module's hot
reload, its two forms of update_tracking and its failures, which warn
and do not stop the tracking, and the live visual fields through the
Segmenter and TrackingState, every frame's planes equal to the JAX
package's."""
import numpy as np
import pytest

from test_torch_engine import one_torch_thread  # noqa: F401
from test_torch_tracker import TRACKING, apply, blob_at, drive
from test_torch_visual_field import synth_video  # noqa: F401
from trex_tpu import closed_loop as J
from trex_tpu.config import reset_global_settings as jax_reset
from trex_tpu.pipeline import Segmenter as JaxSegmenter
from trex_tpu.pipeline import TrackingState as JaxTrackingState
from trex_tpu_torch import closed_loop as T
from trex_tpu_torch import pipeline
from trex_tpu_torch.config import reset_global_settings
from trex_tpu_torch.io.pv import PVFile, PVFrame, PVHeader
from trex_tpu_torch.track.tracker import Tracker

RECORDER = """
calls = []
def request_features():
    return {features!r}
def update_tracking(data):
    calls.append((data.frame, data.ids.tolist()))
"""


def _frame_equal(got, want):
    assert got.frame == want.frame and got.time == want.time
    np.testing.assert_array_equal(got.ids, want.ids)
    np.testing.assert_array_equal(got.positions, want.positions)
    np.testing.assert_array_equal(got.velocities, want.velocities)
    assert (got.midlines is None) == (want.midlines is None)
    for a, b in zip(got.midlines or [], want.midlines or []):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
    assert (got.visual_fields is None) == (want.visual_fields is None)
    if want.visual_fields is not None:
        assert list(got.visual_fields) == list(want.visual_fields)
        for fid, planes in want.visual_fields.items():
            for k, v in planes.items():
                np.testing.assert_array_equal(got.visual_fields[fid][k], v,
                                              err_msg=f"{fid} {k}")


def _pair():
    """Both packages' object Trackers over tests/test_aux.py's three
    frames of one moving blob."""
    bg = np.full((100, 100), 200, np.uint8)
    frames = [[blob_at(10 + f, 10, value=100)] for f in range(3)]
    return drive(TRACKING, frames, bg)


def test_closed_loop(tmp_path):
    """tests/test_aux.py::test_closed_loop: the callback and the user
    module see frame 2 with its one individual."""
    ref, got = _pair()
    out = {}
    for k, mod, tracker, kw in (("j", J, ref, {}),
                                ("p", T, got, {"device": "cpu"})):
        seen = []
        loop = mod.ClosedLoop(tracker, tracker.settings,
                              callback=seen.append,
                              features=["position", "midline"], **kw)
        module = tmp_path / k / "user_loop.py"
        module.parent.mkdir()
        module.write_text(RECORDER.format(features="position"))
        loop.load_module(module)
        data = loop.update(2)
        assert seen and seen[0].frame == 2 and len(data.ids) == 1
        assert loop.features == ["position"]
        assert loop._module.calls == [(2, data.ids.tolist())]
        out[k] = data
    _frame_equal(out["p"], out["j"])
    assert out["p"].midlines is None


@pytest.mark.parametrize("features,want", [
    ("position, midline ,", ["position", "midline"]),
    (["midline", " position"], ["midline", "position"]),
    (("visual_field",), ["visual_field"])])
def test_request_features_list_or_string(tmp_path, features, want):
    ref, got = _pair()
    for k, mod, tracker in (("j", J, ref), ("p", T, got)):
        loop = mod.ClosedLoop(tracker, tracker.settings)
        module = tmp_path / k / "m.py"
        module.parent.mkdir()
        module.write_text(RECORDER.format(features=features))
        loop.load_module(module)
        assert loop.features == want


def test_hot_reload_and_failures_warn_as_in_jax(tmp_path, capfd):
    """The module reloads when its mtime changes; a module that does not
    load keeps the previous one, an update_tracking that raises warns, an
    update_tracking without a parameter reads frame_data: each as the
    JAX package does it, with its warnings."""
    import os

    ref, got = _pair()
    logs = {}
    for k, mod, tracker, kw in (("j", J, ref, {}),
                                ("p", T, got, {"device": "cpu"})):
        root = tmp_path / k
        root.mkdir()
        module = root / "m.py"
        module.write_text(RECORDER.format(features="position"))
        loop = mod.ClosedLoop(tracker, tracker.settings, **kw)
        loop.load_module(module)
        first = loop._module
        loop.update(0)

        def rewrite(text, step):
            module.write_text(text)
            st = module.stat()
            os.utime(module, ns=(st.st_atime_ns,
                                 st.st_mtime_ns + step * 10 ** 9))

        rewrite("def update_tracking(:\n", 1)  # a syntax error
        capfd.readouterr()
        loop.update(1)
        err = [capfd.readouterr().err]
        assert loop._module is first and first.calls == [(0, [0]), (1, [0])]
        rewrite("frames = []\n"
                "def update_tracking():\n"
                "    frames.append(frame_data.frame)\n"
                "    if frame_data.frame == 2:\n"
                "        raise ValueError('user fault')\n", 2)
        loop.update(1)
        loop.update(2)
        err.append(capfd.readouterr().err)
        assert loop._module is not first and loop._module.frames == [1, 2]
        assert loop.features == ["position"]
        logs[k] = [e.replace(str(root), "<dir>") for e in err]
    assert logs["p"] == logs["j"]
    assert "cannot (re)load" in logs["p"][0]
    assert "update_tracking failed: user fault" in logs["p"][1]


def _one_blob_pv(path):
    """tests/test_aux.py's four-frame .pv of one moving blob."""
    bg = np.full((100, 100), 200, np.uint8)
    with PVFile.create(path, PVHeader(width=100, height=100,
                                      average=bg)) as f:
        for i in range(4):
            fr = PVFrame(timestamp=i * 40_000)
            lines, px, _ = blob_at(10 + i, 10, value=100)
            fr.add_object(lines, px)
            f.add_frame(fr)
    return path


def test_closed_loop_enable_wires_track_loop(tmp_path):
    """tests/test_aux.py::test_closed_loop_enable_wires_track_loop:
    closed_loop_enable and closed_loop_path run the user module after
    every frame TrackingState tracks with the object Tracker."""
    pv = _one_blob_pv(tmp_path / "cl.pv")
    lines = {}
    for k, reset, state_cls, kw in (
            ("j", jax_reset, JaxTrackingState, {}),
            ("p", reset_global_settings, pipeline.TrackingState,
             {"device": "cpu"})):
        log = tmp_path / f"{k}.txt"
        module = tmp_path / f"{k}_loop.py"
        module.write_text(
            "def request_features():\n"
            "    return 'position'\n"
            "def update_tracking(data):\n"
            f"    open({str(log)!r}, 'a').write(\n"
            "        f'{data.frame} {len(data.ids)} {data.positions}\\n')\n")
        s = apply(reset(), dict(TRACKING, closed_loop_enable=True,
                                closed_loop_path=str(module)))
        state = state_cls(s, pv, **kw)
        state.run()
        lines[k] = log.read_text().splitlines()
    assert isinstance(state.tracker, Tracker)
    assert [int(l.split()[0]) for l in lines["p"]] == [0, 1, 2, 3]
    assert all(int(l.split()[1]) == 1 for l in lines["p"])
    assert lines["p"] == lines["j"]


def test_closed_loop_without_a_module_warns_and_runs(tmp_path, capfd):
    pv = _one_blob_pv(tmp_path / "cl.pv")
    err = {}
    for k, reset, state_cls, kw in (
            ("j", jax_reset, JaxTrackingState, {}),
            ("p", reset_global_settings, pipeline.TrackingState,
             {"device": "cpu"})):
        s = apply(reset(), dict(TRACKING, closed_loop_enable=True,
                                closed_loop_path=str(tmp_path / "none.py")))
        capfd.readouterr()
        tracker = state_cls(s, pv, **kw).run()
        assert len(tracker.individuals) == 1
        err[k] = capfd.readouterr().err
    assert "[closed_loop] enabled but module" in err["p"]
    assert err["p"] == err["j"]


LIVE = """
import numpy as np
frames = []
def request_features():
    return 'position,midline,visual_field'
def update_tracking(data):
    vf = data.visual_fields or {{}}
    frames.append(data.frame)
    np.savez({out!r} + f'/{{data.frame}}.npz', ids=data.ids,
             vf_ids=np.asarray(list(vf), np.int64),
             **{{f'{{k}}_{{fid}}': v for fid, p in vf.items()
                for k, v in p.items()}})
"""


@pytest.mark.parametrize("entry", ["segmenter", "tracking_state"])
def test_live_visual_fields_equal_jax(synth_video, tmp_path, entry):
    """The loop with a module that requests positions, midlines and visual
    fields, run by the Segmenter while it converts (lazily, once the
    tracker exists) and by TrackingState over the .pv: every frame
    reaches the module, with the JAX package's ids and planes."""
    root, src = synth_video
    conv = dict(meta_encoding="gray", averaging_method="max",
                average_samples=5)
    got = {}
    for k, reset, seg_cls, state_cls, kw in (
            ("j", jax_reset, JaxSegmenter, JaxTrackingState, {}),
            ("p", reset_global_settings, pipeline.Segmenter,
             pipeline.TrackingState, {"device": "cpu"})):
        out = tmp_path / k
        out.mkdir()
        module = tmp_path / f"{k}_live.py"
        module.write_text(LIVE.format(out=str(out)))
        loop = dict(closed_loop_enable=True, closed_loop_path=str(module))
        pv = tmp_path / f"{k}.pv"
        if entry == "segmenter":
            seg_cls(apply(reset(), dict(conv, **loop)), src, pv, **kw).run()
        else:
            seg_cls(apply(reset(), conv), src, pv, track=False, **kw).run()
            state_cls(apply(reset(), loop), pv, **kw).run()
        got[k] = out
    names = sorted(p.name for p in got["j"].glob("*.npz"))
    assert names == [f"{i}.npz" for i in range(10)]
    assert sorted(p.name for p in got["p"].glob("*.npz")) == names
    fields = 0
    for name in names:
        with np.load(got["j"] / name) as want, np.load(got["p"] / name) as g:
            assert sorted(g.files) == sorted(want.files)
            for key in want.files:
                np.testing.assert_array_equal(g[key], want[key],
                                              err_msg=f"{name} {key}")
            fields += len(want["vf_ids"])
    assert fields >= 50

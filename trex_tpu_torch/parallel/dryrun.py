"""The dryrun of several devices (the port's counterpart of the JAX
package's ``__graft_entry__.py``).

``entry()`` is the forward of the flagship identity network (v118_3, 100
classes) on a (128, 80, 80, 1) batch of crops. ``dryrun_multichip(n)``
starts n ranks (``distributed.launch``) and runs three checks:

1. one v118_3 training step (float32, dropout on) on a (data x model)
   mesh of ranks, 2-D when n is even and at least 4 (square as possible,
   ``make_mesh``'s rule), else data only. The batch splits over
   ``data``; every Dense layer whose width divides by the model size is
   column parallel over ``model`` (:class:`ColumnParallelDense`: its
   rank's slice of the output features, then the slices joined by
   ``distributed.gather_rows``), its Adam moments on the same slice.
   BatchNorm and dropout are data parallel (``layers.data_parallel``).
   Every rank's backward gives the gradient of the sum of all ranks'
   losses (each collective's backward is its adjoint), which counts each
   data slice's loss once a model rank: replicated gradients are summed
   over every rank, column slices over their data group, and both
   divided by the rank count. The step's global loss and the gathered
   Dense gradients and updated parameters must equal a single-device
   step on the global batch;
2. detection of a frame batch sharded over a mesh of the first rank's
   local devices (``detect_batch_runs_sharded``), byte-equal to the
   single-device call;
3. ``track_videos_sharded`` of one video a device, byte-equal to each
   video's ``track_video_device`` with the history split off.

Checks 2 and 3 need no collective and run in the first rank alone, as
they run in one process outside a dryrun. ``gather_rows`` joins slices
by an all-reduce of zero-filled slices on every backend: gloo has no
all-gather of CUDA tensors, and the sum is exact.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from ..device import resolve_device

# float32 summed in another order across ranks: the loss, and each
# gathered Dense gradient and parameter relative to its largest magnitude
DRYRUN_TOL = 1e-5
LR = 1e-4
NUM_CLASSES = 8
EDGE = 16


def entry(device=None, batch: int = 128):
    """(fn, example_args): the softmax forward of v118_3 for 100
    classes on a (batch, 80, 80, 1) batch of crops on `device` (the
    card when None)."""
    from ..models import VITrainer, build

    dev = resolve_device(device)
    model = VITrainer(build("v118_3", 100), 100, (80, 80, 1),
                      device=dev).model

    @torch.no_grad()
    def forward(images):
        return torch.softmax(model(images.permute(0, 3, 1, 2)).float(), -1)
    return forward, (torch.zeros((batch, 80, 80, 1), device=dev),)


class ColumnParallelDense(nn.Module):
    """A ``layers.Dense`` split over the ranks of `group` by output
    feature: this rank holds rows ``[index * k, (index + 1) * k)`` of the
    weight and the bias, computes its slice and joins every rank's
    slices (differentiably) into the full output."""

    def __init__(self, dense, index: int, size: int, group):
        super().__init__()
        k = dense.weight.shape[0] // size
        self.dtype = dense.dtype
        self.group = group
        self.weight = nn.Parameter(
            dense.weight.detach()[index * k:(index + 1) * k].clone())
        self.bias = nn.Parameter(
            dense.bias.detach()[index * k:(index + 1) * k].clone())

    def forward(self, x):
        from .distributed import gather_rows

        y = F.linear(x.to(self.dtype), self.weight.to(self.dtype)) \
            + self.bias.to(self.dtype)
        return gather_rows(y, self.group, dim=-1)


def column_parallel(model: nn.Module, index: int, size: int, group) -> list:
    """Replace every Dense of `model` whose width divides by `size` with
    its :class:`ColumnParallelDense`; returns the replacements."""
    from ..models.layers import Dense

    found = [(parent, name, child) for parent in model.modules()
             for name, child in parent.named_children()
             if isinstance(child, Dense) and size > 1
             and child.weight.shape[0] % size == 0]
    out = []
    for parent, name, child in found:
        parent._modules[name] = ColumnParallelDense(child, index, size,
                                                    group)
        out.append(parent._modules[name])
    return out


def _groups(data: int, model: int):
    """(data group, model group) of this rank on a (data x model) grid of
    ranks numbered data-major; every rank makes every group, in order."""
    rank = dist.get_rank()
    mine = [None, None]
    for j in range(model):
        g = dist.new_group([d * model + j for d in range(data)])
        if rank % model == j:
            mine[0] = g
    for d in range(data):
        g = dist.new_group([d * model + j for j in range(model)])
        if rank // model == d:
            mine[1] = g
    return mine


def _dense_tensors(model, grad: bool = False):
    """Each Dense's weight and bias (or their gradients) by module name,
    gathered over the model group where it is column parallel."""
    from ..models.layers import Dense
    from .distributed import gather_rows

    out = {}
    for name, m in model.named_modules():
        if isinstance(m, (ColumnParallelDense, Dense)):
            for p in ("weight", "bias"):
                t = getattr(m, p)
                t = (t.grad if grad else t).detach()
                if isinstance(m, ColumnParallelDense):
                    t = gather_rows(t, m.group)
                out[f"{name}.{p}"] = t.cpu().clone()
    return out


def _rel_err(got: dict, want: dict) -> float:
    return max(float((got[k] - want[k]).abs().max()
                     / want[k].abs().max().clamp_min(1e-30)) for k in want)


def _train_check(n: int, dev) -> dict:
    from ..models import VITrainer, build
    from ..models.layers import data_parallel
    from ..models.training import adam, mean_gradients, \
        softmax_cross_entropy
    from .distributed import DataGroup
    from .mesh import make_mesh

    rank = dist.get_rank()
    axes = ("data", "model") if n % 2 == 0 and n >= 4 else ("data",)
    shape = make_mesh(n, axes, device="cpu").shape
    data, model_par = shape["data"], shape.get("model", 1)
    data_g, model_g = _groups(data, model_par)
    d, j = rank // model_par, rank % model_par

    def fresh():
        return VITrainer(build("v118_3", NUM_CLASSES, dtype=torch.float32),
                         NUM_CLASSES, (EDGE, EDGE, 1), device=dev).model
    batch = 2 * n
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(batch, 1, EDGE, EDGE)).astype(
        np.float32) * 60 + 128).to(dev)
    y = (torch.arange(batch) % NUM_CLASSES).to(dev)

    def step(net, xs, ys, sync):
        opt = adam(net.parameters(), LR)
        gen = torch.Generator(dev).manual_seed(1)
        opt.zero_grad(set_to_none=True)
        loss = softmax_cross_entropy(net(xs, train=True, rng=gen), ys,
                                     NUM_CLASSES)
        loss.backward()
        sync(net)
        grads = _dense_tensors(net, grad=True)
        opt.step()
        return loss.detach(), grads

    ref = fresh()
    ref_loss, want_g = step(ref, x, y, lambda net: None)
    ref_loss = float(ref_loss)
    want = _dense_tensors(ref)

    net = data_parallel(fresh(), DataGroup(data_g, d, data))
    sharded = column_parallel(net, j, model_par, model_g)
    sharded_ids = {id(p) for m in sharded for p in m.parameters()}

    def sync(net):
        # the mean over the n ranks: a column-parallel slice's gradient
        # already sums its model group's terms (gather_rows' adjoint)
        params = list(net.parameters())
        mean_gradients([p for p in params if id(p) not in sharded_ids],
                       None, n)
        mean_gradients([p for p in params if id(p) in sharded_ids],
                       data_g, n)

    per = batch // data
    loss, got_g = step(net, x[d * per:(d + 1) * per],
                       y[d * per:(d + 1) * per], sync)
    dist.all_reduce(loss, group=data_g)
    loss_err = abs(float(loss) / data - ref_loss) / max(1.0, abs(ref_loss))
    return dict(mesh=dict(shape), loss=float(loss) / data,
                ref_loss=ref_loss, loss_err=loss_err,
                grad_err=_rel_err(got_g, want_g),
                param_err=_rel_err(_dense_tensors(net), want),
                sharded_params=len(sharded) * 2)


def _detect_check(n: int, mesh) -> bool:
    from ..ops.runcc import detect_batch_runs, detect_batch_runs_sharded

    rng = np.random.default_rng(1)
    frames = np.full((n * 2, 64, 64), 200, np.uint8)
    for b in range(frames.shape[0]):
        y, x = rng.integers(8, 48, 2)
        frames[b, y:y + 6, x:x + 10] = 90
    bg = np.full((64, 64), 200, np.uint8)
    kw = dict(detect_threshold=15, detect_absolute=False,
              track_threshold=20, track_absolute=False, max_runs=128,
              max_pixels=2048, max_blobs=32, max_child_runs=128,
              max_children=32)
    out = detect_batch_runs_sharded(frames, bg, mesh, **kw)
    single = detect_batch_runs(frames, bg, device=mesh.devices.ravel()[0],
                               **kw)
    return bool((out["det"]["n_blobs"] == 1).all()) and all(
        torch.equal(v, single[g][k]) for g in ("det", "child", "det_runs",
                                               "child_runs")
        for k, v in out[g].items())


def _track_check(n: int, mesh) -> bool:
    from ..config import reset_global_settings
    from ..ops.device_tracker import track_video_device, \
        track_videos_sharded

    s = reset_global_settings()
    for k, v in (("track_max_individuals", 2), ("track_max_speed", 300),
                 ("cm_per_pixel", 1.0), ("frame_rate", 25),
                 ("track_threshold", 20),
                 ("track_threshold_is_absolute", False),
                 ("track_background_subtraction", True),
                 ("track_size_filter", [[10, 400]]),
                 ("match_mode", "automatic"),
                 ("track_do_history_split", False)):
        s.set(k, v)
    bg = np.full((64, 64), 200, np.uint8)
    videos = np.full((n, 4, 64, 64), 200, np.uint8)
    for v in range(n):
        for t in range(4):
            x = 8 + 4 * t + 2 * v
            videos[v, t, 20:26, x:x + 8] = 80
    kw = dict(max_runs=256, max_pixels=4096, max_blobs=16,
              max_child_runs=256, max_children=16)
    hist = track_videos_sharded(videos, bg, s, mesh=mesh, **kw)
    ok = bool(hist["fish_seen"][:, :, 0].all())
    dev0 = mesh.devices.ravel()[0]
    for v in range(n):
        solo = track_video_device(videos[v], bg, s, device=dev0, **kw)
        ok &= all(torch.equal(hist[k][v].to(dev0), solo[k])
                  for k in ("fish_x", "fish_y", "fish_seen", "n_assigned"))
    return ok


def _dryrun_rank(n: int, local: str) -> dict:
    from .distributed import rank_device
    from .mesh import make_mesh

    dev = rank_device()
    out = _train_check(n, dev)
    if dist.get_rank() == 0:
        mesh = make_mesh(n, device=local)
        out.update(local_mesh=repr(mesh), detect_equal=_detect_check(
            n, mesh), track_equal=_track_check(n, mesh))
    dist.barrier()
    return out


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """Run the three checks over `n_devices` ranks: on the cards under
    NCCL (`device` None, one card a rank), or as gloo ranks on the CPU
    (``"cpu"``). Prints a line a check; raises when one fails; returns
    the first rank's numbers with the largest errors of all ranks."""
    from .distributed import launch

    dev = resolve_device(device)
    local = "cpu" if dev.type == "cpu" else None
    outs = launch(_dryrun_rank, n_devices, device, n_devices, local)
    res = dict(outs[0])
    for k in ("loss_err", "grad_err", "param_err"):
        res[k] = max(o[k] for o in outs)
    print(f"dryrun_multichip: {n_devices} ranks on {dev} (mesh "
          f"{res['mesh']}), loss {res['loss']:.6f} (single device "
          f"{res['ref_loss']:.6f}), errors: loss {res['loss_err']:.2e}, "
          f"Dense gradients {res['grad_err']:.2e}, parameters "
          f"{res['param_err']:.2e}; {res['sharded_params']} column-parallel "
          f"tensors", 
          flush=True)
    print(f"dryrun detection: batch {2 * n_devices} over "
          f"{res['local_mesh']}, byte-equal to one device: "
          f"{res['detect_equal']}", flush=True)
    print(f"dryrun tracking: {n_devices} videos over the same mesh, "
          f"histories byte-equal to per-video scans: {res['track_equal']}",
          flush=True)
    if not (max(res["loss_err"], res["grad_err"], res["param_err"])
            <= DRYRUN_TOL and res["detect_equal"] and res["track_equal"]):
        raise RuntimeError(f"dryrun_multichip({n_devices}) failed: {res}")
    return res

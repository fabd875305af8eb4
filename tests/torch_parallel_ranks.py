"""Rank bodies of the port's multi-process tests
(tests/test_torch_parallel.py, tests/test_torch_vi_dp.py), run through
``trex_tpu_torch.parallel.launch``. Spawned ranks import this module
afresh, so it imports no JAX and nothing of trex_tpu."""
import numpy as np
import torch
import torch.distributed as dist

from trex_tpu_torch.parallel import distributed


def probe():
    """What a gloo rank sees: initialize(), its batch slice, a gathered
    global batch and a DeviceMesh over the ranks."""
    r = dist.get_rank()
    local = np.arange(4) + 10 * r
    mesh = distributed.hybrid_mesh(("data", "model"))
    return {"initialized": distributed.initialize(device="cpu"), "rank": r,
            "world": dist.get_world_size(),
            "slice": distributed.process_batch_slice(32),
            "global": distributed.global_batch_array(mesh, local).numpy(),
            "mesh_names": tuple(mesh.mesh_dim_names),
            "mesh_shape": tuple(mesh.mesh.shape)}


def own_gloo_group(rank, world, store_path, out_dir):
    """A rank of a gloo group that the caller builds itself, outside
    initialize() and launch() (torch.multiprocessing.spawn): without
    CUDA, rank_device() and hybrid_mesh() raise rather than take the
    CPU, which hybrid_mesh(device="cpu") names; the trainer then takes
    the CPU from that mesh. Writes what it saw to `out_dir`."""
    import os

    from trex_tpu_torch.models import VITrainer, build

    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world)
    seen = {}
    try:
        for name, call in (("rank_device", distributed.rank_device),
                           ("hybrid_mesh",
                            lambda: distributed.hybrid_mesh(("data",)))):
            try:
                call()
                seen[name] = "ran"
            except RuntimeError as e:
                seen[name] = str(e)
        mesh = distributed.hybrid_mesh(("data",), device="cpu")
        t = VITrainer(build("v118_3", 2, dtype=torch.float32), 2,
                      (16, 16, 1), mesh=mesh)
        seen.update(mesh_type=mesh.device_type, device=str(t.device),
                    dp=(t.dp.rank, t.dp.size),
                    named=str(distributed.rank_device("cpu")))
    finally:
        dist.destroy_process_group()
    torch.save(seen, os.path.join(out_dir, f"rank{rank}.pt"))


def first_step_grads(flat, images, labels, batch_size):
    """The gradients the trainer hands its first Adam step (dropout off),
    by parameter name: after the ranks' mean when a process group is
    up (a port Mesh of every rank's CPU place), else the single
    process's on the whole batch."""
    from trex_tpu_torch.models import VITrainer, build, vi_params
    from trex_tpu_torch.parallel import mesh as pmesh

    ncls = int(labels.max()) + 1
    kw = dict(mesh=pmesh.make_mesh(dist.get_world_size(), device="cpu")) \
        if dist.is_initialized() else dict(device="cpu")
    t = VITrainer(build("v118_3", ncls, dtype=torch.float32), ncls,
                  images.shape[1:], **kw)
    vi_params.from_flax_arrays(t.model, flat)
    _no_dropout(t.model)
    grads = {}

    class Taken(Exception):
        pass

    def record(*a, **k):
        grads.update({n: p.grad.detach().numpy().copy() for n, p in
                      t.model.named_parameters()})
        raise Taken
    t.opt.step = record
    try:
        t.train(images, labels, val_images=images, val_labels=labels,
                max_epochs=1, batch_size=batch_size, min_iterations=1)
    except Taken:
        pass
    return grads


def fail_on_rank_one():
    if dist.get_rank() == 1:
        raise RuntimeError("rank 1 fails")
    return 0


def _no_dropout(model):
    from trex_tpu_torch.models.layers import Dropout

    for m in model.modules():
        if isinstance(m, Dropout):
            m.rate = 0.0
    return model


def train_vi(flat, images, labels, train_kw, predict_n, dropout=True,
             batch_stats_after_one_step=False, mesh_kind="port"):
    """One rank of data-parallel VITrainer training (float32 v118_3 on
    the CPU) from the flax-layout arrays `flat`: the history, the
    predictions of the first `predict_n` images, the trained parameters
    and, when asked, the BatchNorm statistics after one step."""
    from trex_tpu_torch.models import VITrainer, build, vi_params
    from trex_tpu_torch.parallel import mesh as pmesh

    world = dist.get_world_size()
    mesh = pmesh.make_mesh(world, device="cpu") if mesh_kind == "port" \
        else distributed.hybrid_mesh(("data",))
    train_kw = dict(train_kw)
    ncls = int(train_kw.pop("num_classes"))
    t = VITrainer(build("v118_3", ncls, dtype=torch.float32), ncls,
                  images.shape[1:], mesh=mesh)
    vi_params.from_flax_arrays(t.model, flat)
    if not dropout:
        _no_dropout(t.model)
    out = {}
    if batch_stats_after_one_step:
        kw = dict(train_kw, max_epochs=1)
        snap = t.state
        out["stats_one_step"] = _one_step_stats(t, images, labels, kw)
        t.state = snap
        t._aug_rng.manual_seed(7)
    res = t.train(images, labels, **train_kw)
    out["history"] = res.history
    out["probs"] = t.predict(images[:predict_n],
                             batch_size=train_kw["batch_size"])
    out["params"] = {k: v.detach().cpu().numpy().copy()
                     for k, v in t.model.state_dict().items()}
    return out


def _one_step_stats(trainer, images, labels, kw):
    """The BatchNorm running statistics after the first training step."""
    seen = {}
    step = trainer._train_step

    def once(*a):
        r = step(*a)
        if not seen:
            seen.update({k: v.detach().cpu().numpy().copy() for k, v in
                         trainer.model.state_dict().items()
                         if k.endswith((".mean", ".var"))})
        return r
    trainer._train_step = once
    trainer.train(images, labels, **kw)
    trainer._train_step = step
    return seen


def train_static(images, labels, epochs, batch_size, output_prefix):
    """One rank of learn_static.train_static over a mesh of every rank,
    saving to `output_prefix` (rank 0 writes): the history and the
    trained parameters."""
    from trex_tpu_torch.ml.learn_static import train_static as ts
    from trex_tpu_torch.parallel import mesh as pmesh

    mesh = pmesh.make_mesh(dist.get_world_size(), device="cpu")
    trainer, res = ts(images, labels, max_epochs=epochs,
                      batch_size=batch_size, output_prefix=output_prefix,
                      mesh=mesh, device="cpu")
    return dict(history=res.history,
                params={k: v.detach().numpy().copy() for k, v in
                        trainer.model.state_dict().items()})

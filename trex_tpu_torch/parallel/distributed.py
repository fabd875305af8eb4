"""Processes, process groups and meshes over ranks (counterpart of
``trex_tpu/parallel/distributed.py``).

The JAX package runs one controller that drives every device, and
``jax.distributed`` joins hosts into one runtime. PyTorch runs a
process a card when the work needs collectives inside the forward and
backward passes (data-parallel training): every rank runs the same
program, ``torch.distributed`` joins them, and NCCL carries the
collectives between cards. The backend is chosen explicitly and never
swapped for another: NCCL when every rank has a card of its own, gloo on
the CPU or where the caller names it (gloo also all-reduces CUDA
tensors, through the host). A failing init raises.

- :func:`initialize` joins a process started by ``torchrun`` (its
  ``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/``RANK``/``LOCAL_RANK``)
  or given explicit arguments; it returns False when nothing is
  configured, as the JAX one does without a coordinator;
- :func:`launch` starts n ranks of a function from one process
  (``torch.multiprocessing``, start method ``spawn``), each joined
  through a ``FileStore`` in a temporary directory, and returns what
  each rank returned; a rank's exception is raised in the caller;
- :func:`hybrid_mesh` is a ``DeviceMesh`` over the ranks (hosts on the
  outer axis, a model axis of 1 by default) and degrades to the local
  :class:`~.mesh.Mesh` in a single process;
- :func:`gather_rows` joins every rank's rows by an all-reduce (SUM) of
  zero-filled slices, exact and differentiable, on every backend (gloo
  has no all-gather of CUDA tensors).
"""
from __future__ import annotations

import os
import tempfile
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from .mesh import Mesh, local_devices

LAUNCH_HINT = (
    "a mesh of several devices in one process cannot train: data-parallel "
    "training runs one process a card under torch.distributed. Launch one "
    "rank a card (torchrun, each rank calling "
    "trex_tpu_torch.parallel.initialize(), or "
    "trex_tpu_torch.parallel.launch(fn, n_cards)) and pass each rank "
    "hybrid_mesh(('data',)) or the mesh of every rank's device")

# the device of this process's rank, set where the process joins a group
_RANK_DEVICE: Optional[torch.device] = None


class DataGroup(NamedTuple):
    """The ranks a data-parallel model spans: the process group, this
    rank's index in it and its size."""
    group: object
    rank: int
    size: int


def _rank_card(dev: torch.device, local_rank: int) -> torch.device:
    if dev.type != "cuda":
        return dev
    return torch.device("cuda", local_rank if dev.index is None
                        else dev.index)


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None,
               local_rank: Optional[int] = None,
               backend: Optional[str] = None, device=None) -> bool:
    """Join this process to a ``torch.distributed`` run.

    Arguments default to torchrun's environment (``MASTER_ADDR`` means
    ``env://``). Returns False when nothing is configured (a single
    process), True once the process group is up, already or now. The
    rank's card is ``LOCAL_RANK`` when `device` names no card; the
    backend is NCCL on cards and gloo on the CPU unless `backend` says
    otherwise."""
    global _RANK_DEVICE
    if dist.is_initialized():
        return True
    env = os.environ
    if world_size is None and env.get("WORLD_SIZE"):
        world_size = int(env["WORLD_SIZE"])
    if rank is None and env.get("RANK"):
        rank = int(env["RANK"])
    if local_rank is None:
        local_rank = int(env.get("LOCAL_RANK", 0))
    if init_method is None and env.get("MASTER_ADDR"):
        init_method = "env://"
    if init_method is None:
        if world_size in (None, 1):
            return False
        raise ValueError(f"world_size {world_size} without an address: "
                         "set MASTER_ADDR/MASTER_PORT or init_method")
    dev = _rank_card(resolve_device(device), local_rank)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=-1 if world_size is None
                            else world_size,
                            rank=-1 if rank is None else rank)
    _RANK_DEVICE = dev
    return True


def rank_device(device=None) -> torch.device:
    """The device of this process's rank. `device` None: the one
    :func:`initialize` or :func:`launch` set, else this rank's card
    (``LOCAL_RANK``, or the current card where torchrun set none), and
    without CUDA it raises (``resolve_device``): a process group built
    elsewhere, gloo's too, runs on the CPU only where the caller names
    it (``device="cpu"``)."""
    if device is None and _RANK_DEVICE is not None:
        return _RANK_DEVICE
    dev = resolve_device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    local = os.environ.get("LOCAL_RANK")
    return torch.device("cuda", torch.cuda.current_device()
                        if local is None else int(local))


def hybrid_mesh(axis_names: Sequence[str] = ("data", "model"),
                model_axis_size: Optional[int] = None, device=None,
                n_devices: Optional[int] = None):
    """A mesh whose leading axis spans hosts and whose trailing axis
    stays within a host. Across ranks, a ``DeviceMesh`` of shape (world
    / m, m) over the ranks, m the model axis (1 unless given, at most
    the ranks of one host); torchrun numbers ranks host by host, so a
    model group never leaves its host. In a single process, the local
    :class:`Mesh` over :func:`~.mesh.local_devices` (`device`,
    `n_devices`) with the same axis names."""
    axis_names = tuple(axis_names)
    if not dist.is_initialized():
        devices = local_devices(n_devices, device)
        n = len(devices)
        m = max(1, min(model_axis_size or 1, n))
        if len(axis_names) == 1:
            return Mesh(devices, axis_names)
        return Mesh(np.asarray(devices, dtype=object).reshape(n // m, m),
                    axis_names)
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    dev = rank_device(device)
    n_local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    m = max(1, min(model_axis_size or 1, n_local))
    shape = (world,) if len(axis_names) == 1 else (world // m, m)
    return init_device_mesh(dev.type, shape, mesh_dim_names=axis_names)


def process_batch_slice(global_batch: int) -> slice:
    """This rank's rows of a global batch: every rank takes the same
    count, so the batch is cut to a multiple of the world size (rank
    and world in place of JAX's process index and count)."""
    n, i = (dist.get_world_size(), dist.get_rank()) \
        if dist.is_initialized() else (1, 0)
    per = global_batch // n
    return slice(i * per, i * per + per)


class _AllReduceSum(torch.autograd.Function):
    """All-reduce (SUM) whose backward is its adjoint: the all-reduce of
    the gradients. Each rank's backward then gives the gradient of the
    sum of every rank's loss with respect to its own inputs."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad, ctx.group), None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of every rank's `x` over `group`, differentiable."""
    return _AllReduceSum.apply(x, group)


def gather_rows(x: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """Every rank's `x` joined along `dim` in rank order, on every rank:
    each rank places its slice among zeros and the slices are summed
    (:func:`all_reduce_sum`, so gradients flow back to each rank's
    slice). Exact: every sum adds zeros to one value."""
    n = dist.get_world_size(group)
    r = dist.get_rank(group)
    zero = torch.zeros_like(x)
    return all_reduce_sum(torch.cat([x if i == r else zero
                                     for i in range(n)], dim), group)


def global_batch_array(mesh, local_data, axis: str = "data"):
    """The global batch from every rank's local rows: across ranks their
    concatenation in rank order (:func:`gather_rows`) on this rank's
    device; in a single process the local data is the global batch, on
    the first device of the mesh's `axis`."""
    x = local_data if isinstance(local_data, torch.Tensor) \
        else torch.as_tensor(np.asarray(local_data))
    if not dist.is_initialized():
        return x.to(mesh.axis_devices(axis)[0])
    return gather_rows(x.to(_mesh_device(mesh)))


def _mesh_device(mesh) -> torch.device:
    """This rank's device on a mesh across ranks: the CPU where a
    ``DeviceMesh`` was built on it, else :func:`rank_device`; rank r's
    device of a port :class:`Mesh` of as many devices as ranks."""
    if isinstance(mesh, Mesh) and mesh.size == dist.get_world_size():
        return mesh.devices.ravel()[dist.get_rank()]
    return rank_device("cpu" if getattr(mesh, "device_type", None) == "cpu"
                       else None)


def data_group(mesh, axis: str = "data"):
    """(device, DataGroup or None) of a model replicated over `mesh` and
    fed batches split over `axis`: a ``DeviceMesh`` gives the group of
    its `axis` (or its only axis) and this rank's device, the CPU where
    the mesh was built on it and else a card (:func:`rank_device`); a
    port :class:`Mesh` of one device is that device with no group; a
    port Mesh of several devices needs a process group of as many ranks,
    rank r on the mesh's r-th device, and raises otherwise
    (:data:`LAUNCH_HINT`)."""
    from torch.distributed.device_mesh import DeviceMesh

    if isinstance(mesh, DeviceMesh):
        names = mesh.mesh_dim_names or ()
        group = mesh.get_group(axis) if axis in names else mesh.get_group()
        size = dist.get_world_size(group)
        return _mesh_device(mesh), (
            DataGroup(group, dist.get_rank(group), size) if size > 1
            else None)
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a trex_tpu_torch.parallel.Mesh or "
                        f"a DeviceMesh, got {type(mesh).__name__}")
    devices = mesh.devices.ravel()
    if mesh.size == 1:
        return devices[0], None
    if dist.is_initialized() and dist.get_world_size() == mesh.size \
            == mesh.shape.get(axis):
        r = dist.get_rank()
        return devices[r], DataGroup(dist.group.WORLD, r, mesh.size)
    raise ValueError(LAUNCH_HINT)


def _backend(dev: torch.device, nprocs: int, backend: Optional[str]) -> str:
    """NCCL when every rank has a card of its own; gloo on the CPU or
    when asked. Several ranks on one named card need gloo, asked for."""
    shared = dev.type == "cuda" and dev.index is not None and nprocs > 1
    if dev.type == "cuda" and dev.index is None \
            and nprocs > torch.cuda.device_count():
        raise ValueError(f"{nprocs} ranks on {torch.cuda.device_count()} "
                         "cards: NCCL takes a card a rank; name one card "
                         "and backend='gloo' to share it")
    if backend is None:
        if shared:
            raise ValueError(f"{nprocs} ranks on {dev}: NCCL takes a card "
                             "a rank; pass backend='gloo' to share it")
        return "gloo" if dev.type == "cpu" else "nccl"
    if backend == "nccl" and (dev.type != "cuda" or shared):
        raise ValueError(f"NCCL needs a card a rank, not {nprocs} ranks "
                         f"on {dev}")
    return backend


def _rank_main(rank, world, device, backend, tmp, fn, args):
    global _RANK_DEVICE
    dev = _rank_card(torch.device(device), rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    store = dist.FileStore(os.path.join(tmp, "store"), world)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world,
                            device_id=dev if backend == "nccl" else None)
    _RANK_DEVICE = dev
    try:
        out = fn(*args)
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def launch(fn, nprocs: int, device=None, *args,
           backend: Optional[str] = None) -> list:
    """Run ``fn(*args)`` in `nprocs` new processes, one rank each, joined
    in one process group, and return each rank's return value in rank
    order. `device` None means the cards, rank r on card r under NCCL;
    ``"cpu"`` runs gloo ranks on the CPU; a named card (``"cuda:0"``)
    holds every rank with ``backend="gloo"``. `fn` and `args` are
    pickled (a function importable by name). A rank that raises stops
    the others, and its exception is raised here."""
    import torch.multiprocessing as mp

    dev = resolve_device(device)
    backend = _backend(dev, nprocs, backend)
    with tempfile.TemporaryDirectory(prefix="trex_launch_") as tmp:
        mp.spawn(_rank_main, args=(nprocs, str(dev), backend, tmp, fn,
                                   args), nprocs=nprocs, join=True)
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(nprocs)]

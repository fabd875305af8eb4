"""Device mesh and sharding helpers (counterpart of
``trex_tpu/parallel/mesh.py``).

The JAX package drives every device from one process through a
``jax.sharding.Mesh``; XLA splits a sharded array's work over its
devices. The port keeps that form for the work that needs no
collective (detection, multi-video tracking): a :class:`Mesh` is an
array of ``torch.device``s with named axes, a batch is split into one
shard a device along an axis, each shard runs on its device and the
results are joined in the batch's order. Data-parallel training, whose
forward and backward passes need collectives, runs one process a card
under ``torch.distributed`` instead (``distributed.py``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device


class Mesh:
    """An n-dimensional array of ``torch.device``s with one name an axis.
    ``shape`` maps each name to its size, as ``jax.sharding.Mesh.shape``
    does. A device may appear more than once (two shards on one card)."""

    def __init__(self, devices, axis_names: Sequence[str]):
        self.devices = np.vectorize(torch.device, otypes=[object])(
            np.asarray(devices, dtype=object))
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"{self.devices.ndim}-D devices for axes "
                             f"{self.axis_names}")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def axis_devices(self, axis: str) -> list:
        """The device of each shard along `axis`: the first device of
        every slice of the mesh at that axis' index."""
        i = self.axis_names.index(axis)
        moved = np.moveaxis(self.devices, i, 0)
        return list(moved.reshape(moved.shape[0], -1)[:, 0])

    def __repr__(self):
        names = ", ".join(f"{k}={v}" for k, v in self.shape.items())
        return f"Mesh({names}; {', '.join(map(str, self.devices.ravel()))})"


def local_devices(n_devices: Optional[int] = None, device=None) -> list:
    """The devices a mesh is made of. ``device`` None (or ``"cuda"``):
    the process's cards, the first `n_devices` of them; a device with an
    index, or ``"cpu"``: `n_devices` places of that device (default 1),
    the counterpart of the JAX tests' virtual CPU devices. (A
    :class:`Mesh` takes any list of devices.) Without CUDA, a card
    raises (``device.resolve_device``)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
        return devs[:n_devices] if n_devices is not None else devs
    return [dev] * (1 if n_devices is None else int(n_devices))


def make_mesh(n_devices: Optional[int] = None, axis_names=("data",),
              device=None) -> Mesh:
    """A mesh over `n_devices` of :func:`local_devices`. Two axes split
    as square as possible (data x model): ``a = floor(sqrt(n))``, lowered
    until it divides n, as the JAX package splits."""
    devices = local_devices(n_devices, device)
    if len(axis_names) == 1:
        return Mesh(devices, axis_names)
    n = len(devices)
    a = int(np.floor(np.sqrt(n)))
    while n % a:
        a -= 1
    return Mesh(np.asarray(devices, dtype=object).reshape(a, n // a),
                axis_names)


class Sharding(NamedTuple):
    """Where an array lives on a mesh: split along its leading dimension
    over `axis`, or replicated on every device (`axis` None)."""
    mesh: Mesh
    axis: Optional[str]


def batch_sharding(mesh: Mesh, axis: str = "data") -> Sharding:
    """Shard the leading (batch) dimension over `axis`."""
    return Sharding(mesh, axis)


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, None)


def shard_batch(mesh: Mesh, batch, axis: str = "data"):
    """Split a host batch over `axis`, one shard on each of its devices,
    padded with zeros to a multiple of the axis size. Returns (list of
    shards, real_n)."""
    batch = torch.as_tensor(np.asarray(batch)) \
        if not isinstance(batch, torch.Tensor) else batch
    n = batch.shape[0]
    devs = mesh.axis_devices(axis)
    pad = (-n) % len(devs)
    if pad:
        batch = torch.cat([batch, batch.new_zeros((pad,) + batch.shape[1:])])
    per = batch.shape[0] // len(devs)
    return [batch[i * per:(i + 1) * per].to(d)
            for i, d in enumerate(devs)], n


def run_shards(fn, devices: Sequence[torch.device]) -> list:
    """``fn(i, devices[i])`` for every shard i, and the results in shard
    order. One host thread a distinct device runs that device's shards
    one after another, so that the work of every card is launched before
    any is waited for (the port's shards stop on the host for their
    data-dependent loops)."""
    from concurrent.futures import ThreadPoolExecutor
    from contextlib import nullcontext

    by_dev: dict = {}
    for i, d in enumerate(devices):
        by_dev.setdefault(d, []).append(i)

    def run(dev):
        with torch.cuda.device(dev) if dev.type == "cuda" \
                else nullcontext():
            return [(i, fn(i, dev)) for i in by_dev[dev]]
    out = [None] * len(devices)
    with ThreadPoolExecutor(len(by_dev)) as pool:
        for part in pool.map(run, list(by_dev)):
            for i, r in part:
                out[i] = r
    return out


def join_shards(parts: list, device: torch.device):
    """Per-shard outputs (nested dicts of tensors) concatenated along
    their leading dimension on `device`."""
    if isinstance(parts[0], dict):
        return {k: join_shards([p[k] for p in parts], device)
                for k in parts[0]}
    return torch.cat([p.to(device) for p in parts])


def shard_params(mesh: Mesh, tree):
    """Replicate a parameter tree (nested dicts of tensors) on every
    device of the mesh: one copy a distinct device, keyed by device."""
    def put(x, dev):
        if isinstance(x, dict):
            return {k: put(v, dev) for k, v in x.items()}
        return torch.as_tensor(x).to(dev)
    return {d: put(tree, d)
            for d in dict.fromkeys(mesh.devices.ravel())}

"""Identity-CNN training loop (counterpart of
``trex_tpu/models/training.py``, replacing the embedded torch path of the
reference: python/visual_recognition_torch.py).

Semantics mirrored from the reference, through the JAX package:
- Adam with lr = gpu_learning_rate (1e-4), epochs <= gpu_max_epochs (150)
  (visual_recognition_torch.py train() :1036), computed as
  ``optax.adam(lr)`` computes it (:func:`adam`);
- ValidationCallback early stop: per-class validation accuracy computed
  each epoch; training stops once the worst class stayed above 0.97 for
  5 epochs or reaches 0.99 (visual_recognition_torch.py:355-689, :607);
- predict(): batched softmax probabilities (:984), in batches of 512
  with the tail batch padded, as the JAX package pads it;
- checkpoints saved as <filename>_weights.npz in the JAX package's flat
  layout (``vi_params.py``), so either package loads the other's files.

The network, its forward and backward passes, the optimizer and the
augmentation run on the card unless the caller names the CPU
(``device.py``). The batch order and the validation split are drawn in
numpy exactly as the JAX package draws them; dropout and augmentation
draw from ``torch.Generator``s of the trainer on its device.

Data parallel (``mesh``): the JAX package shards each batch over a
mesh's ``data`` axis from one controller, and XLA all-reduces what the
step needs. The port runs one process (rank) a card under
``torch.distributed``: every rank calls the same ``train`` on the same
arrays, draws the same split, batch order, augmentation and dropout,
keeps its rows of each batch, and all-reduces the BatchNorm statistics
(``layers.data_parallel``), the gradients, the loss and the accuracy,
so that every rank takes the step the single-card trainer takes on the
whole batch, within float32 summation order.
"""
from __future__ import annotations

import copy
import json
import math
import warnings
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..device import resolve_device
from .layers import data_parallel, materialize
from .vi_params import from_flax_arrays, to_flax_arrays


def softmax_cross_entropy(logits, labels, num_classes):
    """optax.softmax_cross_entropy against one-hot labels, batch mean."""
    onehot = F.one_hot(labels.long(), num_classes).to(logits.dtype)
    return -(onehot * torch.log_softmax(logits, dim=-1)).sum(-1).mean()


def focal_loss(logits, labels, num_classes, gamma: float = 2.0):
    """Focal loss option (visual_identification_network.py:15-110)."""
    onehot = F.one_hot(labels.long(), num_classes).to(logits.dtype)
    logp = torch.log_softmax(logits, dim=-1)
    w = (1 - torch.exp(logp)) ** gamma
    return -(onehot * w * logp).sum(-1).mean()


def adam(params, lr: float = 1e-4) -> torch.optim.Adam:
    """``optax.adam(lr)``: b1 0.9, b2 0.999, eps 1e-8 added after the
    square root of the bias-corrected second moment, no weight decay.
    ``torch.optim.Adam`` computes that function (``p -= lr / bc1 * mu /
    (sqrt(nu) / sqrt(bc2) + eps)``); its fused kernel orders the
    operations otherwise, within float32 rounding of optax
    (tests/test_torch_vi_train.py::test_adam_equals_optax)."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            fused=True)


def adam_steps(opt: torch.optim.Adam) -> int:
    """The count of steps `opt` has taken (optax's ``count``)."""
    for st in opt.state.values():
        return int(st["step"])
    return 0


def mean_gradients(params, group=None, size: Optional[int] = None) -> None:
    """Average the gradients of `params` over the ranks of `group` (every
    rank when None) in one flattened all-reduce (SUM), then divide by
    `size` (the group's size unless given) once. In the trainer, each
    rank's gradient of its local mean loss already carries, through the
    all-reduced BatchNorm statistics, the other ranks' terms, so the
    mean is the gradient of the global batch's mean loss."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group) if size is None else size
    i = 0
    for g in grads:
        g.copy_(flat[i:i + g.numel()].view_as(g))
        i += g.numel()


def make_train_step(model, num_classes: int, loss: str = "ce", dp=None):
    """One training step: the loss of a train-mode forward (batch
    statistics, dropout from `rng`), its gradients, the Adam update and
    the BatchNorm running statistics of the same forward. Returns the
    loss and the batch accuracy as device scalars (this rank's, when
    data parallel over `dp`; the gradients are averaged over the ranks
    before the update)."""
    loss_fn = focal_loss if loss == "focal" else softmax_cross_entropy

    def train_step(opt: torch.optim.Adam, images, labels, rng):
        opt.zero_grad(set_to_none=True)
        logits = model(images, train=True, rng=rng)
        loss_val = loss_fn(logits, labels, num_classes)
        loss_val.backward()
        if dp is not None:
            mean_gradients(model.parameters(), dp.group, dp.size)
        opt.step()
        acc = (logits.argmax(-1) == labels).float().mean()
        return loss_val.detach(), acc

    return train_step


def augment_draws(batch: int, height: int, width: int,
                  generator: torch.Generator, device=None) -> dict:
    """The augmentation's random draws for `batch` images
    (visual_recognition_torch.py:1301-1337: RandomAffine(+-5 deg,
    translate +-move_range) and brightness/contrast jitter 0.85-1.15):
    angle in radians, shifts in pixels, brightness and contrast."""
    move_range = min(0.05, 2 / min(width, height))
    deg = 5.0
    u = torch.rand((5, batch), generator=generator, device=device)

    def uniform(k, lo, hi):
        return u[k] * (hi - lo) + lo
    return dict(ang=uniform(0, -deg, deg) * (math.pi / 180.0),
                tx=uniform(1, -move_range, move_range) * width,
                ty=uniform(2, -move_range, move_range) * height,
                bright=uniform(3, 0.85, 1.15), contr=uniform(4, 0.85, 1.15))


def augment_transform(images, ang, tx, ty, bright, contr):
    """The augmentation applied to (B, C, H, W) float32 images with the
    given draws: each output pixel samples the input at the inverse
    rotation about the centre and shift, bilinearly as
    ``jax.scipy.ndimage.map_coordinates(order=1, mode="constant",
    cval=0)`` does (each of the four corners outside the image reads 0
    on its own; scipy's instead zeroes the whole sample), then the
    brightness factor, the contrast about each image's mean and the clip
    to [0, 255]."""
    b, c, h, w = images.shape
    dev = images.device
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yy = torch.arange(h, device=dev, dtype=torch.float32)[:, None] \
        .expand(h, w) - cy
    xx = torch.arange(w, device=dev, dtype=torch.float32)[None, :] \
        .expand(h, w) - cx
    ca = torch.cos(ang)[:, None, None]
    sa = torch.sin(ang)[:, None, None]
    # inverse transform: rotate by -ang, shift by -t
    sx = ca * xx[None] + sa * yy[None] + cx - tx[:, None, None]
    sy = -sa * xx[None] + ca * yy[None] + cy - ty[:, None, None]

    def nodes(coord):
        lower = torch.floor(coord)
        upper_w = coord - lower
        index = lower.to(torch.int64)
        return ((index, 1 - upper_w), (index + 1, upper_w))

    flat = images.reshape(b, c, h * w)
    out = None
    for iy, wy in nodes(sy):
        for ix, wx in nodes(sx):
            valid = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
            idx = (iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)) \
                .reshape(b, 1, h * w).expand(b, c, h * w)
            v = torch.gather(flat, 2, idx).reshape(b, c, h, w)
            v = torch.where(valid[:, None], v, torch.zeros((), device=dev))
            term = (wy * wx)[:, None] * v
            out = term if out is None else out + term
    out = out * bright[:, None, None, None]
    mean = out.mean(dim=(1, 2, 3), keepdim=True)
    out = (out - mean) * contr[:, None, None, None] + mean
    return torch.clamp(out, 0.0, 255.0)


@dataclass
class TrainResult:
    epochs: int = 0
    history: list = field(default_factory=list)
    per_class_accuracy: Optional[np.ndarray] = None
    best_worst_accuracy: float = 0.0
    stopped_early: bool = False
    uniqueness_history: list = field(default_factory=list)


class VITrainer:
    """Trains the identity network and predicts with it: `model` (from
    ``vi_network.build``) is made for `image_shape` (H, W, C) with
    parameters drawn from `generator` (seeded with `seed` when None) and
    placed on `device` (the card when None). Dropout draws from a
    generator on that device seeded with ``seed + 1``, the augmentation
    from one seeded with ``seed + 7`` (the JAX package's augmentation
    key).

    `mesh` makes the trainer data parallel over the ranks of its
    `data_axis` (``parallel.distributed.data_group``): a
    ``DeviceMesh`` (``parallel.hybrid_mesh`` across ranks), or a port
    ``Mesh`` of as many devices as ranks, rank r on its r-th device; the
    mesh then names the device. A mesh of one device is the plain
    trainer on it. A mesh of several devices in one process raises:
    training over several cards runs one rank a card (torchrun or
    ``parallel.launch``). Every rank calls ``train`` with the same
    arguments; ``batch_size`` must divide by the ranks."""

    def __init__(self, model, num_classes: int, image_shape,
                 learning_rate: float = 1e-4, loss: str = "ce",
                 seed: int = 0, generator: Optional[torch.Generator] = None,
                 device=None, mesh=None, data_axis: str = "data"):
        self.dp = None
        if mesh is not None:
            from ..parallel.distributed import data_group

            device, self.dp = data_group(mesh, data_axis)
        self.device = resolve_device(device)
        self.num_classes = num_classes
        self.image_shape = tuple(int(v) for v in image_shape)
        if generator is None:
            generator = torch.Generator().manual_seed(seed)
        self.model = data_parallel(materialize(
            model, self.image_shape, generator, self.device), self.dp)
        self.opt = adam(self.model.parameters(), learning_rate)
        self._train_step = make_train_step(self.model, num_classes, loss,
                                           self.dp)
        self._dropout_rng = torch.Generator(self.device).manual_seed(
            seed + 1)
        self._aug_rng = torch.Generator(self.device).manual_seed(seed + 7)

    # ------------------------------------------------------------------
    @property
    def state(self) -> dict:
        """A deep snapshot of everything a training step changes: the
        parameters and BatchNorm statistics, Adam's moments and step,
        and the dropout generator. Setting it copies a snapshot back (the
        accumulation's rollback), so one snapshot may be restored more
        than once."""
        return copy.deepcopy(dict(
            model=self.model.state_dict(), opt=self.opt.state_dict(),
            dropout_rng=self._dropout_rng.get_state()))

    @state.setter
    def state(self, snap: dict):
        self.model.load_state_dict(snap["model"])
        # the optimizer keeps the tensors it is given: copy them, so that
        # its steps leave the snapshot as it was
        self.opt.load_state_dict(copy.deepcopy(snap["opt"]))
        self._dropout_rng.set_state(snap["dropout_rng"])

    @property
    def steps(self) -> int:
        """Training steps taken so far (Adam's count)."""
        return adam_steps(self.opt)

    # ------------------------------------------------------------------
    def train(self, images: np.ndarray, labels: np.ndarray,
              val_images: Optional[np.ndarray] = None,
              val_labels: Optional[np.ndarray] = None,
              max_epochs: int = 150, batch_size: int = 128,
              min_iterations: int = 100,
              accuracy_stop_all: float = 0.97,
              accuracy_stop_worst: float = 0.99,
              uniqueness_fn: Optional[Callable[[], float]] = None,
              callbacks: Optional[Callable[[int, dict], None]] = None,
              seed: int = 0, augment: bool = False) -> TrainResult:
        images = np.asarray(images, np.float32)
        labels = np.asarray(labels, np.int32)
        if images.size and float(images.max()) <= 1.5:
            warnings.warn(
                "VI networks expect 0-255 gray inputs (the model "
                "normalizes x/127.5-1); inputs look 0-1 scaled",
                stacklevel=2)
        n = len(images)
        dp = self.dp
        if dp is not None and batch_size % dp.size:
            raise ValueError(f"batch_size {batch_size} does not split over "
                             f"{dp.size} data-parallel ranks")
        local = batch_size // (1 if dp is None else dp.size)
        lo = 0 if dp is None else dp.rank * local
        if val_images is None:
            # stratified 25% split: every class keeps at least one
            # validation sample (a plain permutation can drop a rare
            # class from validation entirely, pinning its per-class
            # accuracy at 0 and blocking early stopping forever)
            rng = np.random.default_rng(seed)
            val_idx = []
            train_idx = []
            for c in np.unique(labels):
                rows = np.flatnonzero(labels == c)
                rows = rows[rng.permutation(len(rows))]
                k = max(1, len(rows) // 4) if len(rows) > 1 else 0
                val_idx.extend(rows[:k])
                train_idx.extend(rows[k:])
            val_idx = np.asarray(val_idx, np.int64)
            train_idx = np.asarray(train_idx, np.int64)
            if not len(val_idx):  # single tiny class: fall back
                cut = max(1, n // 4)
                order = rng.permutation(n)
                val_idx, train_idx = order[:cut], order[cut:]
            val_images, val_labels = images[val_idx], labels[val_idx]
            images, labels = images[train_idx], labels[train_idx]
            n = len(images)
        # the training set lives on the device for the whole call; every
        # batch has the same shape (small sets are upsampled to a full
        # batch), as the JAX package keeps it for one compiled step
        dev_images = torch.from_numpy(images).to(self.device) \
            .permute(0, 3, 1, 2).contiguous()
        dev_labels = torch.from_numpy(labels.astype(np.int64)) \
            .to(self.device)
        h, w = self.image_shape[:2]
        result = TrainResult()
        rng = np.random.default_rng(seed + 1)
        steps_done = 0
        steps_per_epoch = max(1, n // batch_size)
        worst_backlog: list = []
        patience = 5  # reference backlog length

        for epoch in range(max_epochs):
            order = rng.permutation(n)
            if n < batch_size:
                order = np.concatenate(
                    [order, rng.integers(0, n, batch_size - n)])
            losses, accs = [], []
            for step_i in range(steps_per_epoch):
                sidx = (step_i * batch_size) % max(1, n)
                idx = order[sidx : sidx + batch_size]
                if len(idx) < batch_size:
                    idx = np.concatenate(
                        [idx, order[: batch_size - len(idx)]])
                at = torch.from_numpy(idx[lo:lo + local]).to(self.device)
                bi, bl = dev_images[at], dev_labels[at]
                if augment:
                    draws = augment_draws(batch_size, h, w, self._aug_rng,
                                          self.device)
                    bi = augment_transform(bi, **{
                        k: v[lo:lo + local] for k, v in draws.items()})
                loss_v, acc = self._train_step(self.opt, bi, bl,
                                               self._dropout_rng)
                losses.append(loss_v)
                accs.append(acc)
                steps_done += 1
            if dp is None:
                losses = torch.stack(losses).tolist()
                accs = torch.stack(accs).tolist()
            else:
                both = torch.stack([torch.stack(losses).float(),
                                    torch.stack(accs).float()])
                dist.all_reduce(both, group=dp.group)
                losses, accs = (both / dp.size).tolist()
            per_class = self.per_class_accuracy(val_images, val_labels,
                                                batch_size)
            worst = float(np.min(per_class)) if len(per_class) else 0.0
            entry = {
                "epoch": epoch,
                "loss": float(np.mean(losses)) if losses else 0.0,
                "acc": float(np.mean(accs)) if accs else 0.0,
                "val_worst": worst,
                "val_mean": float(np.mean(per_class)) if len(per_class) else 0.0,
            }
            if uniqueness_fn is not None:
                u = uniqueness_fn()
                entry["uniqueness"] = u
                result.uniqueness_history.append(u)
            result.history.append(entry)
            result.per_class_accuracy = per_class
            result.best_worst_accuracy = max(result.best_worst_accuracy,
                                             worst)
            result.epochs = epoch + 1
            if callbacks:
                callbacks(epoch, entry)
            worst_backlog.append(worst)
            # reference ValidationCallback (visual_recognition_torch.py
            # :607): stop when the WORST class accuracy stayed above
            # 0.97 for `patience` consecutive epochs, or instantly at
            # worst >= 0.99 (an instantaneous all-classes check stops
            # one lucky epoch too early)
            backlog = worst_backlog[-patience:]
            if steps_done >= min_iterations and (
                    (len(backlog) >= patience
                     and all(v > accuracy_stop_all for v in backlog))
                    or worst >= accuracy_stop_worst):
                result.stopped_early = True
                break
        return result

    # ------------------------------------------------------------------
    @torch.no_grad()
    def predict(self, images: np.ndarray, batch_size: int = 512) -> np.ndarray:
        """Softmax probabilities (N, num_classes) of NHWC images (uint8
        or float); the tail batch is padded with zeros to `batch_size`.
        Data parallel, each rank computes its rows of every batch and
        every rank returns all of them."""
        from ..parallel.distributed import gather_rows

        images = np.asarray(images)
        if images.dtype != np.uint8:
            images = images.astype(np.float32)
        n = len(images)
        dp = self.dp
        per = batch_size if dp is None else -(-batch_size // dp.size)
        rows = per if dp is None else per * dp.size
        lo = 0 if dp is None else dp.rank * per
        out = np.empty((n, self.num_classes), np.float32)
        for s in range(0, n, batch_size):
            chunk = torch.from_numpy(np.ascontiguousarray(
                images[s : s + batch_size]))
            k = len(chunk)
            x = torch.zeros((rows, *chunk.shape[1:]),
                            dtype=chunk.dtype, device=self.device)
            x[:k] = chunk.to(self.device)
            logits = self.model(x[lo:lo + per].permute(0, 3, 1, 2))
            probs = torch.softmax(logits.float(), dim=-1)
            if dp is not None:
                probs = gather_rows(probs, dp.group)
            out[s : s + k] = probs[:k].cpu().numpy()
        return out

    def per_class_accuracy(self, images, labels, batch_size=512) -> np.ndarray:
        if images is None or len(images) == 0:
            return np.zeros(self.num_classes)
        probs = self.predict(images, batch_size)
        pred = probs.argmax(axis=-1)
        acc = np.zeros(self.num_classes)
        for c in range(self.num_classes):
            m = labels == c
            acc[c] = (pred[m] == c).mean() if m.sum() else 0.0
        return acc

    # ------------------------------------------------------------------
    def save_weights(self, path):
        """<filename>_weights.npz layout: flat param arrays + meta.
        Data parallel, rank 0 writes and every rank returns once the
        file is written."""
        if self.dp is None or self.dp.rank == 0:
            arrays = to_flax_arrays(self.model)
            arrays["__meta__"] = np.array([json.dumps({
                "num_classes": self.num_classes,
                "image_shape": self.image_shape,
            })])
            with open(path, "wb") as f:
                np.savez(f, **arrays)
        if self.dp is not None:
            dist.barrier(group=self.dp.group)

    def load_weights(self, path):
        with np.load(path, allow_pickle=False) as data:
            from_flax_arrays(self.model, data)

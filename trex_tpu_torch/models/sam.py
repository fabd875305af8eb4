"""Promptable segmentation model (the SAM architecture) in torch.

The port of ``trex_tpu/models/sam.py``, which backs the sam3 detection
backend (``detect/sam3.py``): a ViT image encoder with windowed attention
and decomposed relative position embeddings, a prompt encoder for points
and boxes, a byte-level text tower for concept prompts, and the two-way
transformer mask decoder with its IoU head. The module tree has the JAX
package's names, so its flax variables carry across by path
(:func:`state_from_flax`); official segment-anything checkpoints map onto
it with :func:`convert_sam_checkpoint`.

Tensors stay (B, H, W, C) inside the encoder's blocks, as the JAX code
and official SAM keep them. Precision is the JAX package's, cast for
cast:

- every ``Dense``, convolution and transposed convolution computes in
  ``dtype`` (bfloat16 by default) from float32 parameters cast to it,
  and adds its bias after the product's rounding;
- every LayerNorm computes in float32 (epsilon 1e-6, flax's default, in
  the decoder too), so a bfloat16 input comes out float32 and the sums
  after it promote (bfloat16 + float32 -> float32);
- the encoder's attention scales ``q`` before ``q @ k^T``, adds the
  relative-position terms in ``dtype`` and takes the softmax in float32;
- the prompt encoder's positional code is a float32 product (TF32 is
  off, ``device.py``), the IoU head and the text tower are float32;
- the MLPs and the upscaling use the exact (erf) GELU, the text tower
  the tanh approximation (flax's ``nn.gelu`` default).

``jax.image.resize(..., "linear")`` of the relative-position tables and
of ``pos_embed`` is :func:`resize_weights`' matrix: the triangle kernel
that ``jax.image.scale_and_translate`` builds, widened (antialiased) when
it shrinks.
"""
from __future__ import annotations

import math
from functools import lru_cache
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .. import device as _device  # noqa: F401  (TF32 off)
from .layers import Conv, Dense, LayerNorm
from .layers import gelu as gelu_tanh
from .yolo import _flat

PIXEL_MEAN = (123.675, 116.28, 103.53)
PIXEL_STD = (58.395, 57.12, 57.375)


# --------------------------------------------------------------------------
# jax.image.resize(..., "linear")
# --------------------------------------------------------------------------

@lru_cache(maxsize=64)
def resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """The (out, in) float32 matrix of ``jax.image.resize`` along one
    axis with the linear (triangle) kernel, antialiased:
    ``compute_weight_mat`` of ``jax/_src/image/scale.py`` in float32."""
    f32 = np.float32
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = f32(max(inv_scale, 1.0))
    sample_f = (np.arange(out_size, dtype=f32) + f32(0.5)) \
        * f32(inv_scale) - f32(0.0) - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None]) \
        / kernel_scale
    w = np.maximum(f32(0), f32(1) - np.abs(x))
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > f32(1000.0 * np.finfo(f32).eps),
                 w / np.where(total != 0, total, f32(1)), f32(0))
    inside = (sample_f >= -0.5) & (sample_f <= f32(in_size - 0.5))
    w = np.where(inside[None, :], w, f32(0)).astype(f32)
    out = np.ascontiguousarray(w.T)
    out.flags.writeable = False
    return out


def resize_axis(x: torch.Tensor, axis: int, size: int) -> torch.Tensor:
    """``jax.image.resize`` of float32 `x` along `axis` to `size`."""
    if x.shape[axis] == size:
        return x
    w = torch.tensor(resize_weights(x.shape[axis], size), device=x.device)
    x = x.movedim(axis, -1)
    return torch.matmul(x, w.T).movedim(-1, axis)


def _rel_pos(q_size: int, k_size: int, rel_pos: torch.Tensor
             ) -> torch.Tensor:
    """Interpolated relative position table lookup (SAM's get_rel_pos):
    (q_size, k_size, head_dim)."""
    max_rel = 2 * max(q_size, k_size) - 1
    rel = resize_axis(rel_pos, 0, max_rel)
    dev = rel_pos.device
    qs = torch.arange(q_size, dtype=torch.float32, device=dev)[:, None] \
        * max(k_size / q_size, 1.0)
    ks = torch.arange(k_size, dtype=torch.float32, device=dev)[None, :] \
        * max(q_size / k_size, 1.0)
    idx = (qs - ks) + (k_size - 1) * max(q_size / k_size, 1.0)
    return rel[idx.to(torch.int64)]


# --------------------------------------------------------------------------
# image encoder
# --------------------------------------------------------------------------

class MLPBlock(nn.Module):
    def __init__(self, dim: int, hidden: int, dtype=torch.bfloat16):
        super().__init__()
        self.lin1 = Dense(dim, hidden, dtype)
        self.lin2 = Dense(hidden, dim, dtype)

    def forward(self, x):
        return self.lin2(F.gelu(self.lin1(x)))


class Attention(nn.Module):
    """Multi-head attention with decomposed relative positions over a
    (B, H, W, C) grid."""

    def __init__(self, dim: int, num_heads: int, input_size: tuple,
                 dtype=torch.bfloat16):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        hd = dim // num_heads
        self.qkv = Dense(dim, 3 * dim, dtype)
        self.proj = Dense(dim, dim, dtype)
        self.rel_pos_h = nn.Parameter(torch.empty(2 * input_size[0] - 1, hd))
        self.rel_pos_w = nn.Parameter(torch.empty(2 * input_size[1] - 1, hd))

    def forward(self, x):
        B, H, W, _ = x.shape
        nh = self.num_heads
        hd = self.dim // nh
        qkv = self.qkv(x).reshape(B, H * W, 3, nh, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        attn = (q * (hd ** -0.5)) @ k.transpose(-2, -1)
        Rh = _rel_pos(H, H, self.rel_pos_h).to(q.dtype)
        Rw = _rel_pos(W, W, self.rel_pos_w).to(q.dtype)
        rq = q.reshape(B, nh, H, W, hd)
        rel_h = torch.einsum("bnhwc,hkc->bnhwk", rq, Rh)
        rel_w = torch.einsum("bnhwc,wkc->bnhwk", rq, Rw)
        attn = attn.reshape(B, nh, H, W, H, W) + rel_h[..., :, None] \
            + rel_w[..., None, :]
        attn = attn.reshape(B, nh, H * W, H * W)
        attn = torch.softmax(attn.float(), dim=-1).to(v.dtype)
        out = (attn @ v).transpose(1, 2).reshape(B, H, W, self.dim)
        return self.proj(out)


def _window_partition(x, ws: int):
    B, H, W, C = x.shape
    ph = (ws - H % ws) % ws
    pw = (ws - W % ws) % ws
    x = F.pad(x, (0, 0, 0, pw, 0, ph))
    Hp, Wp = H + ph, W + pw
    x = x.reshape(B, Hp // ws, ws, Wp // ws, ws, C)
    win = x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws, ws, C)
    return win, (Hp, Wp)


def _window_unpartition(win, ws: int, pad_hw, hw):
    Hp, Wp = pad_hw
    H, W = hw
    B = win.shape[0] // (Hp * Wp // ws // ws)
    x = win.reshape(B, Hp // ws, Wp // ws, ws, ws, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(B, Hp, Wp, -1)
    return x[:, :H, :W]


class ViTBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int = 0,
                 input_size: tuple = (64, 64), dtype=torch.bfloat16):
        super().__init__()
        self.window_size = window_size
        self.norm1 = LayerNorm(dim)
        isize = (window_size, window_size) if window_size > 0 \
            else input_size
        self.attn = Attention(dim, num_heads, isize, dtype)
        self.norm2 = LayerNorm(dim)
        self.mlp = MLPBlock(dim, dim * 4, dtype)

    def forward(self, x):
        shortcut = x
        y = self.norm1(x)
        hw = (y.shape[1], y.shape[2])
        if self.window_size > 0:
            y, pad_hw = _window_partition(y, self.window_size)
        y = self.attn(y)
        if self.window_size > 0:
            y = _window_unpartition(y, self.window_size, pad_hw, hw)
        x = shortcut + y
        return x + self.mlp(self.norm2(x))


def _nchw(conv: nn.Module, x):
    """A convolution over NCHW applied to (B, H, W, C)."""
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class ImageEncoderViT(nn.Module):
    def __init__(self, img_size: int = 1024, patch: int = 16,
                 dim: int = 768, depth: int = 12, num_heads: int = 12,
                 out_chans: int = 256, window_size: int = 14,
                 global_idx: Sequence[int] = (2, 5, 8, 11),
                 dtype=torch.bfloat16):
        super().__init__()
        self.img_size, self.patch, self.depth = img_size, patch, depth
        side = img_size // patch
        self.patch_embed = Conv(3, dim, patch, patch, dtype=dtype)
        self.pos_embed = nn.Parameter(torch.empty(1, side, side, dim))
        for i in range(depth):
            ws = 0 if i in global_idx else window_size
            self.add_module(f"block{i}", ViTBlock(
                dim, num_heads, ws, (side, side), dtype))
        self.neck0 = Conv(dim, out_chans, 1, use_bias=False, dtype=dtype)
        self.neck1 = LayerNorm(out_chans)
        self.neck2 = Conv(out_chans, out_chans, 3, use_bias=False,
                          dtype=dtype)
        self.neck3 = LayerNorm(out_chans)

    def blocks(self):
        return [getattr(self, f"block{i}") for i in range(self.depth)]

    def embed(self, x):
        """Patch embedding plus position: (B, H, W, 3) -> (B, h, w, dim)."""
        x = _nchw(self.patch_embed, x)
        pos = self.pos_embed
        if x.shape[1] != pos.shape[1]:
            pos = resize_axis(resize_axis(pos, 1, x.shape[1]), 2,
                              x.shape[2])
        return x + pos.to(x.dtype)

    def neck(self, x):
        x = self.neck1(_nchw(self.neck0, x))
        return self.neck3(_nchw(self.neck2, x))

    def forward(self, x):
        x = self.embed(x)
        for blk in self.blocks():
            x = blk(x)
        return self.neck(x)


# --------------------------------------------------------------------------
# prompt encoder, text tower
# --------------------------------------------------------------------------

class PromptEncoder(nn.Module):
    """Point/box prompts -> sparse embeddings; the dense no-mask embed."""

    def __init__(self, embed_dim: int = 256, image_size: int = 1024):
        super().__init__()
        self.embed_dim, self.image_size = embed_dim, image_size
        self.pe_gaussian = nn.Parameter(torch.empty(2, embed_dim // 2))
        # 0: neg point, 1: pos point, 2: box tl, 3: box br
        self.point_embeddings = nn.Parameter(torch.empty(4, embed_dim))
        self.not_a_point = nn.Parameter(torch.empty(1, embed_dim))
        self.no_mask_embed = nn.Parameter(torch.empty(1, embed_dim))

    def _pe(self, coords):
        """Random-fourier positional code of [0, 1] coordinates: a
        float32 product (the JAX package's Precision.HIGHEST)."""
        c = coords * 2 - 1
        c = torch.matmul(c, self.pe_gaussian.to(coords.dtype))
        c = 2 * math.pi * c
        return torch.cat([torch.sin(c), torch.cos(c)], dim=-1)

    def encode_points(self, points, labels):
        """points (B, N, 2) in pixels, labels (B, N): 1 pos, 0 neg,
        -1 pad, 2/3 box corners."""
        coords = (points + 0.5) / self.image_size
        pe = self._pe(coords)
        picked = self.point_embeddings[labels.clamp(0, 3).to(torch.int64)]
        return torch.where((labels == -1)[..., None],
                           self.not_a_point[0] + torch.zeros_like(pe),
                           pe + picked)

    def dense_pe(self, h: int, w: int):
        dev = self.pe_gaussian.device
        ys = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h
        xs = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        return self._pe(torch.stack([gx, gy], -1))

    def no_mask(self, b: int, h: int, w: int):
        return self.no_mask_embed.reshape(1, 1, 1, -1).expand(
            b, h, w, self.embed_dim)

    def forward(self, points, labels, h: int, w: int):
        return self.encode_points(points, labels), \
            self.no_mask(points.shape[0], h, w)


class Embed(nn.Module):
    """flax ``nn.Embed`` (float32): an ``embedding`` table lookup."""

    def __init__(self, vocab: int, dim: int):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(vocab, dim))

    def forward(self, ids):
        return self.embedding[ids.to(torch.int64)]


class TextEncoder(nn.Module):
    """The JAX package's concept/text tower: byte-level embedding plus a
    positional code, masked mean pooling and a float32 MLP with the
    tanh GELU -> (B, n_tokens, embed_dim) sparse prompt tokens."""

    def __init__(self, embed_dim: int = 256, vocab: int = 256,
                 n_tokens: int = 2, max_len: int = 32):
        super().__init__()
        self.embed_dim, self.n_tokens = embed_dim, n_tokens
        self.Embed_0 = Embed(vocab, embed_dim)
        self.pos_embed = nn.Parameter(torch.empty(max_len, embed_dim))
        self.Dense_0 = Dense(embed_dim, embed_dim * 2, torch.float32)
        self.Dense_1 = Dense(embed_dim * 2, embed_dim * n_tokens,
                             torch.float32)

    def forward(self, token_ids):
        emb = self.Embed_0(token_ids)
        emb = emb + self.pos_embed[None, :emb.shape[1]]
        mask = (token_ids > 0).to(torch.float32)[..., None]
        pooled = (emb * mask).sum(1) / torch.clamp(mask.sum(1), min=1.0)
        x = self.Dense_1(gelu_tanh(self.Dense_0(pooled)))
        return x.reshape(x.shape[0], self.n_tokens, self.embed_dim)


def tokenize_text(text: str, max_len: int = 32) -> np.ndarray:
    """Byte-level tokenization for TextEncoder (0 = pad)."""
    b = text.strip().lower().encode("utf-8")[:max_len]
    out = np.zeros(max_len, np.int32)
    out[: len(b)] = np.frombuffer(b, np.uint8)
    return out


# --------------------------------------------------------------------------
# mask decoder
# --------------------------------------------------------------------------

class TwoWayAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, downsample: int = 1,
                 dtype=torch.bfloat16):
        super().__init__()
        d = dim // downsample
        self.d, self.num_heads = d, num_heads
        self.q_proj = Dense(dim, d, dtype)
        self.k_proj = Dense(dim, d, dtype)
        self.v_proj = Dense(dim, d, dtype)
        self.out_proj = Dense(d, dim, dtype)

    def forward(self, q, k, v):
        hd = self.d // self.num_heads

        def split(t):
            return t.reshape(t.shape[0], t.shape[1], self.num_heads,
                             hd).transpose(1, 2)

        qh, kh = split(self.q_proj(q)), split(self.k_proj(k))
        vh = split(self.v_proj(v))
        attn = (qh @ kh.transpose(-2, -1)) / math.sqrt(hd)
        attn = torch.softmax(attn.float(), -1).to(vh.dtype)
        out = (attn @ vh).transpose(1, 2)
        return self.out_proj(out.reshape(q.shape[0], q.shape[1], self.d))


class TwoWayBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, skip_first_pe: bool = False,
                 dtype=torch.bfloat16):
        super().__init__()
        self.skip_first_pe = skip_first_pe
        self.self_attn = TwoWayAttention(dim, num_heads, dtype=dtype)
        self.norm1 = LayerNorm(dim)
        self.cross_attn_t2i = TwoWayAttention(dim, num_heads, 2, dtype)
        self.norm2 = LayerNorm(dim)
        self.mlp = MLPBlock(dim, dim * 8, dtype)
        self.norm3 = LayerNorm(dim)
        self.cross_attn_i2t = TwoWayAttention(dim, num_heads, 2, dtype)
        self.norm4 = LayerNorm(dim)

    def forward(self, queries, keys, q_pe, k_pe):
        if self.skip_first_pe:
            # official SAM's first layer REPLACES the queries with the
            # self-attention output (no residual)
            queries = self.self_attn(queries, queries, queries)
        else:
            qq = queries + q_pe
            queries = queries + self.self_attn(qq, qq, queries)
        queries = self.norm1(queries)
        a = self.cross_attn_t2i(queries + q_pe, keys + k_pe, keys)
        queries = self.norm2(queries + a)
        queries = self.norm3(queries + self.mlp(queries))
        a = self.cross_attn_i2t(keys + k_pe, queries + q_pe, queries)
        keys = self.norm4(keys + a)
        return queries, keys


class ConvTranspose(nn.Module):
    """flax ``nn.ConvTranspose(features, (2, 2), strides=(2, 2))`` over
    (B, H, W, C) in ``dtype``: torch's transposed convolution with the
    weight in torch's (in, out, kh, kw) layout (flax's kernel mirrored),
    the bias added after the product's rounding."""

    def __init__(self, c_in: int, features: int, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(c_in, features, 2, 2))
        self.bias = nn.Parameter(torch.empty(features))

    def forward(self, x):
        y = F.conv_transpose2d(x.permute(0, 3, 1, 2).to(self.dtype),
                               self.weight.to(self.dtype), stride=2)
        return y.permute(0, 2, 3, 1) + self.bias.to(self.dtype)


class MaskDecoder(nn.Module):
    def __init__(self, dim: int = 256, num_heads: int = 8,
                 num_multimask: int = 3, dtype=torch.bfloat16):
        super().__init__()
        self.dim, self.dtype = dim, dtype
        self.n_tokens = n = num_multimask + 1
        self.iou_token = nn.Parameter(torch.empty(1, dim))
        self.mask_tokens = nn.Parameter(torch.empty(n, dim))
        for i in range(2):
            self.add_module(f"block{i}", TwoWayBlock(
                dim, num_heads, skip_first_pe=(i == 0), dtype=dtype))
        self.final_attn = TwoWayAttention(dim, num_heads, 2, dtype)
        self.final_norm = LayerNorm(dim)
        self.upscale0 = ConvTranspose(dim, dim // 4, dtype)
        self.upscale_norm = LayerNorm(dim // 4)
        self.upscale1 = ConvTranspose(dim // 4, dim // 8, dtype)
        for t in range(n):
            for li, (a, b) in enumerate([(dim, dim), (dim, dim),
                                         (dim, dim // 8)]):
                self.add_module(f"hyper{t}_{li}", Dense(a, b, dtype))
        for li, (a, b) in enumerate([(dim, dim), (dim, dim), (dim, n)]):
            self.add_module(f"iou{li}", Dense(a, b, torch.float32))

    def forward(self, image_embed, image_pe, sparse, dense):
        B, D, n = sparse.shape[0], self.dim, self.n_tokens
        tokens = torch.cat([self.iou_token.expand(B, 1, D),
                            self.mask_tokens.expand(B, n, D),
                            sparse.float()], 1).to(self.dtype)
        h, w = image_embed.shape[-3:-1]
        src = image_embed[None] if image_embed.dim() == 3 else image_embed
        src = (src.expand(B, h, w, D) + dense).reshape(B, h * w, D)
        pe = image_pe.reshape(1, h * w, D).expand(B, h * w, D).to(src.dtype)

        q, k = tokens, src
        for i in range(2):
            q, k = getattr(self, f"block{i}")(q, k, tokens, pe)
        # official final attention: query = queries + prompt tokens
        # (once); the residual adds onto queries
        attn = self.final_attn(q + tokens, k + pe, k)
        q = self.final_norm(q + attn)

        iou_out = q[:, 0]
        mask_out = q[:, 1:1 + n]
        up = self.upscale0(k.reshape(B, h, w, D))
        up = F.gelu(self.upscale_norm(up))
        up = F.gelu(self.upscale1(up))
        hyper = []
        for t in range(n):
            y = mask_out[:, t]
            for li in range(3):
                y = getattr(self, f"hyper{t}_{li}")(y)
                if li < 2:
                    y = F.relu(y)
            hyper.append(y)
        hyper = torch.stack(hyper, 1)  # (B, n_tokens, dim//8)
        masks = torch.einsum("btc,bhwc->bthw", hyper, up)
        y = iou_out
        for li in range(3):
            y = getattr(self, f"iou{li}")(y)
            if li < 2:
                y = F.relu(y)
        return masks.float(), y


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------

class SAM(nn.Module):
    """The full promptable segmentation model (ViT-B by default)."""

    PIXEL_MEAN = PIXEL_MEAN
    PIXEL_STD = PIXEL_STD

    def __init__(self, img_size: int = 1024, encoder_dim: int = 768,
                 encoder_depth: int = 12, encoder_heads: int = 12,
                 global_idx: Sequence[int] = (2, 5, 8, 11),
                 dtype=torch.bfloat16, with_text: bool = False):
        super().__init__()
        self.img_size, self.dtype, self.with_text = img_size, dtype, \
            with_text
        self.image_encoder = ImageEncoderViT(
            img_size=img_size, dim=encoder_dim, depth=encoder_depth,
            num_heads=encoder_heads, global_idx=global_idx, dtype=dtype)
        self.prompt_encoder = PromptEncoder(image_size=img_size)
        self.mask_decoder = MaskDecoder(dtype=dtype)
        if with_text:
            self.text_encoder = TextEncoder()

    def encode(self, images):
        """images (B, H, W, 3) uint8/float -> (B, h, w, 256) float32."""
        mean = torch.tensor(PIXEL_MEAN, dtype=torch.float32,
                            device=images.device)
        std = torch.tensor(PIXEL_STD, dtype=torch.float32,
                           device=images.device)
        x = (images.to(torch.float32) - mean) / std
        return self.image_encoder(x.to(self.dtype))

    def decode(self, image_embed, points, labels):
        """Prompt (points in pixels + labels) -> (masks, iou)."""
        h, w = image_embed.shape[-3:-1]
        sparse, dense = self.prompt_encoder(points, labels, h, w)
        pe = self.prompt_encoder.dense_pe(h, w)
        return self.mask_decoder(image_embed, pe, sparse.to(self.dtype),
                                 dense.to(self.dtype))

    def decode_text(self, image_embed, token_ids):
        """Text/concept prompt (tokenize_text ids) -> (masks, iou): the
        text tokens take the sparse-prompt slot of the mask decoder."""
        h, w = image_embed.shape[-3:-1]
        sparse = self.text_encoder(token_ids)
        dense = self.prompt_encoder.no_mask(token_ids.shape[0], h, w)
        pe = self.prompt_encoder.dense_pe(h, w)
        return self.mask_decoder(image_embed, pe, sparse.to(self.dtype),
                                 dense.to(self.dtype))

    def forward(self, images, points, labels):
        return self.decode(self.encode(images), points, labels)


def box_to_prompt(box) -> tuple:
    """xyxy box -> (points (1,2,2), labels (1,2)) SAM box prompt."""
    x0, y0, x1, y1 = box
    pts = np.array([[[x0, y0], [x1, y1]]], np.float32)
    lbl = np.array([[2, 3]], np.int32)
    return pts, lbl


# tables whose shapes follow the weights, not the model's sizes: the
# forward resizes them (_rel_pos, ImageEncoderViT.embed)
_TABLES = ("pos_embed", "rel_pos_h", "rel_pos_w")
_WEIGHTED = (Conv, Dense, ConvTranspose)


@torch.no_grad()
def init_weights(model: SAM, generator: torch.Generator) -> SAM:
    """Random weights from `generator`, in the kinds of flax's
    initializers: LeCun-normal kernels (clipped at two deviations),
    zero biases, unit LayerNorms, unit normals for the prompt tables and
    tokens, 0.02 for the text tower's positions. The position tables
    (``pos_embed``, ``rel_pos_*``) get 0.02 too where flax starts them at
    zero, so that they take part. The JAX package initialises from a
    ``PRNGKey``; the port draws its own numbers."""
    for mod in model.modules():
        if isinstance(mod, _WEIGHTED):
            w = mod.weight
            fan_in = w.shape[0] * 4 if isinstance(mod, ConvTranspose) \
                else w[0].numel()
            std = 1.0 / math.sqrt(fan_in) / 0.87962566103423978
            t = torch.empty(w.shape).normal_(generator=generator)
            w.copy_(torch.clamp(t, -2, 2) * std)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, LayerNorm):
            mod.scale.fill_(1.0)
            mod.bias.zero_()
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in _TABLES:
            p.copy_(torch.empty(p.shape).normal_(0.0, 0.02,
                                                 generator=generator))
        elif leaf in ("pe_gaussian", "point_embeddings", "not_a_point",
                      "no_mask_embed", "iou_token", "mask_tokens"):
            p.copy_(torch.empty(p.shape).normal_(generator=generator))
        elif leaf == "embedding":
            p.copy_(torch.empty(p.shape).normal_(
                0.0, 1.0 / math.sqrt(p.shape[1]), generator=generator))
    return model


def load_state(model: SAM, state: dict) -> SAM:
    """Copy a name -> array map into `model`: every parameter must be
    named, and nothing else; the position tables take the shapes they
    come with."""
    own = dict(model.named_parameters())
    missing = sorted(set(own) - set(state))
    extra = sorted(set(state) - set(own))
    if missing or extra:
        raise KeyError(f"SAM state does not fit the model: missing "
                       f"{missing[:5]}, unexpected {extra[:5]}")
    mods = dict(model.named_modules())
    with torch.no_grad():
        for k, p in own.items():
            v = state[k]
            v = v.detach().to(torch.float32) if isinstance(v, torch.Tensor) \
                else torch.from_numpy(np.array(v, np.float32))
            if tuple(v.shape) != tuple(p.shape):
                path, leaf = k.rsplit(".", 1) if "." in k else ("", k)
                if leaf not in _TABLES:
                    raise ValueError(f"{k}: shape {tuple(v.shape)} != "
                                     f"{tuple(p.shape)}")
                setattr(mods[path], leaf, nn.Parameter(
                    v.to(p.device).clone()))
                continue
            p.copy_(v)
    return model


def build(img_size: int = 1024, encoder_dim: int = 768,
          encoder_depth: int = 12, encoder_heads: int = 12,
          global_idx: Sequence[int] = (2, 5, 8, 11), dtype=None,
          with_text: bool = False, state: Optional[dict] = None,
          device=None, generator: Optional[torch.Generator] = None) -> SAM:
    """A SAM in eval mode on `device` with the port's `state` (as
    :func:`convert_sam_checkpoint` or :func:`state_from_flax` give it)
    or, without one, weights drawn from `generator` (seed 0 when none is
    given)."""
    model = SAM(img_size, encoder_dim, encoder_depth, encoder_heads,
                global_idx, torch.bfloat16 if dtype is None else dtype,
                with_text)
    if state is None:
        init_weights(model, generator if generator is not None
                     else torch.Generator().manual_seed(0))
    else:
        load_state(model, state)
    return prepare(model, device)


def prepare(model: SAM, device=None) -> SAM:
    """`model` on `device` in eval mode, each product's weight kept in
    its compute type (flax casts it at every call, to the same
    values)."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, _WEIGHTED) and m.dtype != torch.float32:
                m.weight.data = m.weight.data.to(m.dtype)
    return model.to(device).eval()


# --------------------------------------------------------------------------
# weights from the JAX package and from official checkpoints
# --------------------------------------------------------------------------

def state_from_flax(variables: dict) -> dict:
    """The port's state (name -> float32 array) from the JAX package's
    SAM variables (``{"params": ...}``, as numpy or jax arrays):

    - Dense kernels (in, out) -> weight (out, in); conv kernels HWIO ->
      OIHW;
    - ``upscale0``/``upscale1``: flax's ConvTranspose kernel
      (kh, kw, in, out) applies its taps mirrored against torch's, so it
      is flipped on kh/kw and laid out (in, out, kh, kw);
    - LayerNorm ``scale``/``bias``, the embedding and the raw tables by
      name."""
    params = variables.get("params", variables)
    state = {}
    for key, a in _flat(params).items():
        path, leaf = key.rsplit("/", 1) if "/" in key else ("", key)
        name = path.replace("/", ".")
        a = np.asarray(a, np.float32)
        pre = f"{name}." if name else ""
        if leaf == "kernel" and path.rsplit("/", 1)[-1] in ("upscale0",
                                                            "upscale1"):
            state[pre + "weight"] = np.ascontiguousarray(
                a[::-1, ::-1].transpose(2, 3, 0, 1))
        elif leaf == "kernel" and a.ndim == 4:
            state[pre + "weight"] = np.ascontiguousarray(
                a.transpose(3, 2, 0, 1))
        elif leaf == "kernel":
            state[pre + "weight"] = np.ascontiguousarray(a.T)
        else:
            state[pre + leaf] = a
    return state


def _official_names(depth: int) -> dict:
    """Port name -> official segment-anything name, for every tensor
    that maps one to one (all but ``point_embeddings``)."""
    names = {"image_encoder.patch_embed.weight":
             "image_encoder.patch_embed.proj.weight",
             "image_encoder.patch_embed.bias":
             "image_encoder.patch_embed.proj.bias",
             "image_encoder.pos_embed": "image_encoder.pos_embed"}

    def lin(ours, theirs):
        for leaf in ("weight", "bias"):
            names[f"{ours}.{leaf}"] = f"{theirs}.{leaf}"

    def ln(ours, theirs):
        names[f"{ours}.scale"] = f"{theirs}.weight"
        names[f"{ours}.bias"] = f"{theirs}.bias"

    for i in range(depth):
        p, q = f"image_encoder.block{i}", f"image_encoder.blocks.{i}"
        ln(p + ".norm1", q + ".norm1")
        ln(p + ".norm2", q + ".norm2")
        lin(p + ".attn.qkv", q + ".attn.qkv")
        lin(p + ".attn.proj", q + ".attn.proj")
        for t in ("rel_pos_h", "rel_pos_w"):
            names[f"{p}.attn.{t}"] = f"{q}.attn.{t}"
        lin(p + ".mlp.lin1", q + ".mlp.lin1")
        lin(p + ".mlp.lin2", q + ".mlp.lin2")
    names["image_encoder.neck0.weight"] = "image_encoder.neck.0.weight"
    ln("image_encoder.neck1", "image_encoder.neck.1")
    names["image_encoder.neck2.weight"] = "image_encoder.neck.2.weight"
    ln("image_encoder.neck3", "image_encoder.neck.3")

    pe = "prompt_encoder."
    names[pe + "pe_gaussian"] = \
        pe + "pe_layer.positional_encoding_gaussian_matrix"
    names[pe + "not_a_point"] = pe + "not_a_point_embed.weight"
    names[pe + "no_mask_embed"] = pe + "no_mask_embed.weight"

    md, tr = "mask_decoder.", "mask_decoder.transformer."
    names[md + "iou_token"] = md + "iou_token.weight"
    names[md + "mask_tokens"] = md + "mask_tokens.weight"

    def attn(ours, theirs):
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            lin(f"{ours}.{proj}", f"{theirs}.{proj}")

    for i in range(2):
        p, q = f"{md}block{i}", f"{tr}layers.{i}"
        attn(p + ".self_attn", q + ".self_attn")
        attn(p + ".cross_attn_t2i", q + ".cross_attn_token_to_image")
        attn(p + ".cross_attn_i2t", q + ".cross_attn_image_to_token")
        for nm in ("norm1", "norm2", "norm3", "norm4"):
            ln(f"{p}.{nm}", f"{q}.{nm}")
        lin(p + ".mlp.lin1", q + ".mlp.lin1")
        lin(p + ".mlp.lin2", q + ".mlp.lin2")
    attn(md + "final_attn", tr + "final_attn_token_to_image")
    ln(md + "final_norm", tr + "norm_final_attn")
    # torch's ConvTranspose2d layout is the port's: copied as it is
    lin(md + "upscale0", md + "output_upscaling.0")
    ln(md + "upscale_norm", md + "output_upscaling.1")
    lin(md + "upscale1", md + "output_upscaling.3")
    for t in range(4):
        for li in range(3):
            lin(f"{md}hyper{t}_{li}",
                f"{md}output_hypernetworks_mlps.{t}.layers.{li}")
    for li in range(3):
        lin(f"{md}iou{li}", f"{md}iou_prediction_head.layers.{li}")
    return names


def _official_depth(sd: dict) -> int:
    depth = 0
    while f"image_encoder.blocks.{depth}.norm1.weight" in sd:
        depth += 1
    return depth


def convert_sam_checkpoint(sd: dict) -> dict:
    """Official segment-anything state dict -> the port's state
    (name -> float32 array). The layouts agree but for the names and
    the four point embeddings, which the port stacks into one table;
    tensors the port does not use (``mask_downscaling``) are left."""

    def t(key):
        v = sd[key]
        v = v.detach().cpu().float().numpy() if hasattr(v, "detach") \
            else np.asarray(v, np.float32)
        return np.ascontiguousarray(v, np.float32)

    state = {ours: t(theirs) for ours, theirs in
             _official_names(_official_depth(sd)).items()}
    state["prompt_encoder.point_embeddings"] = np.stack([
        t(f"prompt_encoder.point_embeddings.{i}.weight")[0]
        for i in range(4)])
    return state


def official_state_dict(state: dict) -> dict:
    """The port's state (image encoder, prompt encoder and mask decoder)
    as an official segment-anything state dict of float32 tensors: the
    inverse of :func:`convert_sam_checkpoint`."""

    def t(a):
        a = a.detach().cpu().float() if isinstance(a, torch.Tensor) \
            else torch.from_numpy(np.array(a, np.float32))
        return a.contiguous()

    depth = 0
    while f"image_encoder.block{depth}.norm1.scale" in state:
        depth += 1
    sd = {theirs: t(state[ours])
          for ours, theirs in _official_names(depth).items()}
    pts = t(state["prompt_encoder.point_embeddings"])
    for i in range(4):
        sd[f"prompt_encoder.point_embeddings.{i}.weight"] = \
            pts[i:i + 1].clone()
    return sd

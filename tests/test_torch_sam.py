"""The port's SAM (trex_tpu_torch/models/sam.py) against the JAX
package's flax model, module by module and whole, and its converters.

A tiny SAM (img 128, encoder width 32, depth 2, two heads, block 1
global): the flax model's variables are drawn from a numpy seed in the
shapes of its initializer (``jax.eval_shape``, nothing compiled) and
carried across with `state_from_flax`; both sides get the same inputs.
The float32 cases pin ``jax.default_matmul_precision("float32")``, as
tests/test_sam_torch.py does. Tolerances, as the largest difference over
the largest magnitude of the JAX output (at least 1):

- float32: F32_TOL (2e-5). Both compute the same operations in float32;
  sums run in another order (XLA against oneDNN). Measured: below 2e-6
  on every module and for the whole model.
- bfloat16: ROW_TOL (0.02), module by module on the same input and for
  the whole model. XLA keeps fused elementwise chains (the relative
  position adds, the GELUs, the attention scaling) in float32 where
  torch rounds after each operation, so single activations differ by a
  bfloat16 ulp or two, and the differences grow layer by layer through
  the decoder. Measured: 0.007 for the image encoder, 0.016 for the mask
  decoder, 0.018 for the whole model's masks.

``jax.image.resize`` of the position tables (`resize_weights`) is held
through `_rel_pos` up and down and through the encoder's ``pos_embed``
branch (an image smaller or larger than the model's); flax refuses
variables whose tables do not fit the module, so the port's own
mismatched tables are held through `_rel_pos` as a function."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import trex_tpu.models.sam as J
from sam_torch_ref import Sam as RefSam
from sam_torch_ref import randomize
from trex_tpu_torch.models import sam as P

F32_TOL = 2e-5
ROW_TOL = 0.02
CFG = dict(img_size=128, encoder_dim=32, encoder_depth=2, encoder_heads=2,
           global_idx=(1,))
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def precision(dtype):
    return jax.default_matmul_precision(
        "float32" if dtype == "float32" else "default")


def seeded_variables(model, seed, img, with_text=False):
    """Variables of the flax SAM's shapes for `img`^2 inputs, drawn from
    a numpy seed: kernels LeCun-normal, LayerNorm scales around 1,
    biases, position tables and prompt tables away from zero (flax
    starts the tables at zero, which would hide a layout error)."""
    rng = np.random.default_rng(seed)
    pts = jnp.zeros((1, 2, 2), jnp.float32)
    lbl = jnp.zeros((1, 2), jnp.int32)
    shapes = dict(jax.eval_shape(
        model.init, jax.random.PRNGKey(0),
        jnp.zeros((1, img, img, 3), jnp.float32), pts, lbl)["params"])
    if with_text:
        side = img // 16
        shapes["text_encoder"] = jax.eval_shape(
            lambda k: model.init(k, jnp.zeros((1, side, side, 256)),
                                 jnp.zeros((1, 32), jnp.int32),
                                 method="decode_text"),
            jax.random.PRNGKey(0))["params"]["text_encoder"]

    def draw(path, a):
        name = jax.tree_util.keystr(path)
        if "'kernel'" in name:
            fan_in = int(np.prod(a.shape[:-1]))
            x = rng.normal(0, 1 / np.sqrt(fan_in), a.shape)
        elif "'scale'" in name:
            x = rng.uniform(0.5, 1.5, a.shape)
        elif "'bias'" in name or "rel_pos" in name or "pos_embed" in name:
            x = rng.normal(0, 0.1, a.shape)
        else:
            x = rng.normal(0, 1.0, a.shape)
        return jnp.asarray(x, jnp.float32)

    return {"params": jax.tree_util.tree_map_with_path(draw, shapes)}


def twin(dtype, seed=0, with_text=True, cfg=CFG, img=None):
    if cfg is CFG and img is None:
        return _twin(dtype, seed, with_text)
    return _make_twin(dtype, seed, with_text, cfg, img)


@functools.lru_cache(maxsize=None)
def _twin(dtype, seed, with_text):
    return _make_twin(dtype, seed, with_text, CFG, None)


def _make_twin(dtype, seed, with_text, cfg, img):
    jdt, tdt = DTYPES[dtype]
    jm = J.SAM(**cfg, dtype=jdt, with_text=with_text)
    v = seeded_variables(jm, seed, img or cfg["img_size"], with_text)
    pm = P.build(**cfg, dtype=tdt, with_text=with_text,
                 state=P.state_from_flax(v), device="cpu")
    return jm, v, pm


_JITTED: dict = {}


def apply(model, method="__call__"):
    """`model`'s `method`, jitted once: (variables, *inputs) ->
    outputs."""
    key = (id(model), method)
    if key not in _JITTED:
        _JITTED[key] = (model, jax.jit(
            lambda v, *a: model.apply(v, *a, method=method)))
    return _JITTED[key][1]


def err(want, got) -> float:
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    assert want.shape == got.shape
    return float(np.abs(want - got).max()) / max(1.0,
                                                 float(np.abs(want).max()))


def tol(dtype):
    return F32_TOL if dtype == "float32" else ROW_TOL


def same_input(shape, dtype, seed, scale=1.0):
    """One numpy draw as a JAX and a torch array of `dtype`."""
    jdt, tdt = DTYPES[dtype]
    x = (np.random.default_rng(seed).normal(0, scale, shape)
         .astype(np.float32))
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def _module_case(name, dtype):
    """(flax module, its params, its inputs; the port's module, its
    inputs) for one module of the tiny model."""
    jdt, _ = DTYPES[dtype]
    jm, v, pm = twin(dtype)
    p = v["params"]
    enc, dec = p["image_encoder"], p["mask_decoder"]
    D = CFG["encoder_dim"]
    if name == "mlp":
        jx, px = same_input((2, 5, 7, D), dtype, 1)
        return (J.MLPBlock(D, 4 * D, dtype=jdt), enc["block0"]["mlp"],
                (jx,), pm.image_encoder.block0.mlp, (px,))
    if name == "attention_window":
        jx, px = same_input((4, 14, 14, D), dtype, 2)
        return (J.Attention(D, 2, input_size=(14, 14), dtype=jdt),
                enc["block0"]["attn"], (jx,), pm.image_encoder.block0.attn,
                (px,))
    if name == "attention_global":
        jx, px = same_input((1, 8, 8, D), dtype, 3)
        return (J.Attention(D, 2, input_size=(8, 8), dtype=jdt),
                enc["block1"]["attn"], (jx,), pm.image_encoder.block1.attn,
                (px,))
    if name == "block_window":
        # a 20x20 grid: four 14x14 windows, three of them padded
        jx, px = same_input((1, 20, 20, D), dtype, 4)
        return (J.ViTBlock(D, 2, window_size=14, dtype=jdt), enc["block0"],
                (jx,), pm.image_encoder.block0, (px,))
    if name == "block_global":
        jx, px = same_input((2, 8, 8, D), dtype, 5)
        return (J.ViTBlock(D, 2, window_size=0, input_size=(8, 8),
                           dtype=jdt), enc["block1"], (jx,),
                pm.image_encoder.block1, (px,))
    if name == "image_encoder":
        jx, px = same_input((1, 128, 128, 3), dtype, 6)
        return (J.ImageEncoderViT(img_size=128, dim=D, depth=2, num_heads=2,
                                  global_idx=(1,), dtype=jdt), enc, (jx,),
                pm.image_encoder, (px,))
    if name == "two_way_attention":
        q = same_input((3, 7, 256), dtype, 7)
        k = same_input((3, 64, 256), dtype, 8)
        return (J.TwoWayAttention(256, 8, 2, dtype=jdt),
                dec["block1"]["cross_attn_t2i"], (q[0], k[0], k[0]),
                pm.mask_decoder.block1.cross_attn_t2i, (q[1], k[1], k[1]))
    if name in ("two_way_block_first", "two_way_block"):
        i = int(name == "two_way_block")
        q, k, qpe, kpe = (same_input(s, dtype, 9 + j) for j, s in enumerate(
            [(3, 7, 256), (3, 64, 256), (3, 7, 256), (3, 64, 256)]))
        return (J.TwoWayBlock(256, 8, skip_first_pe=not i, dtype=jdt),
                dec[f"block{i}"], (q[0], k[0], qpe[0], kpe[0]),
                getattr(pm.mask_decoder, f"block{i}"),
                (q[1], k[1], qpe[1], kpe[1]))
    if name == "mask_decoder":
        emb = same_input((8, 8, 256), "float32", 13)
        pe = same_input((8, 8, 256), "float32", 14)
        sp = same_input((3, 2, 256), dtype, 15)
        de = same_input((3, 8, 8, 256), dtype, 16)
        return (J.MaskDecoder(dtype=jdt), dec, (emb[0], pe[0], sp[0], de[0]),
                pm.mask_decoder, (emb[1], pe[1], sp[1], de[1]))
    if name == "text_encoder":
        ids = np.stack([J.tokenize_text(t) for t in ("fish", "A Guppy ",
                                                     "")])
        return (J.TextEncoder(dtype=jdt), p["text_encoder"],
                (jnp.asarray(ids),), pm.text_encoder,
                (torch.from_numpy(ids),))
    raise KeyError(name)


MODULES = ("mlp", "attention_window", "attention_global", "block_window",
           "block_global", "image_encoder", "two_way_attention",
           "two_way_block_first", "two_way_block", "mask_decoder",
           "text_encoder")


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", MODULES)
def test_module_equals_flax(name, dtype):
    jmod, params, jin, pmod, pin = _module_case(name, dtype)
    with precision(dtype):
        want = jax.jit(jmod.apply)({"params": params}, *jin)
    with torch.no_grad():
        got = pmod(*pin)
    if not isinstance(want, tuple):
        want, got = (want,), (got,)
    for w, g in zip(want, got):
        assert g.dtype == {"float32": torch.float32,
                           "bfloat16": torch.bfloat16}[str(w.dtype)]
        assert err(w, g) <= tol(dtype), name


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_prompt_encoder_equals_flax(dtype):
    jm, v, pm = twin(dtype)
    rng = np.random.default_rng(3)
    pts = rng.uniform(-4, 132, (4, 3, 2)).astype(np.float32)
    lbl = np.array([[2, 3, -1], [1, 0, -1], [1, 1, 0], [0, -1, -1]],
                   np.int32)
    pe = v["params"]["prompt_encoder"]
    enc = J.PromptEncoder(image_size=128, dtype=DTYPES[dtype][0])
    with precision(dtype):
        sparse, dense = enc.apply({"params": pe}, jnp.asarray(pts),
                                  jnp.asarray(lbl), 8, 8)
        dpe = enc.apply({"params": pe}, 8, 8, method="dense_pe")
    with torch.no_grad():
        s2, d2 = pm.prompt_encoder(torch.from_numpy(pts),
                                   torch.from_numpy(lbl), 8, 8)
        dpe2 = pm.prompt_encoder.dense_pe(8, 8)
    # the positional code is float32 in both policies
    assert s2.dtype == torch.float32 and dpe2.dtype == torch.float32
    assert err(sparse, s2) <= F32_TOL and err(dpe, dpe2) <= F32_TOL
    assert err(dense, d2) == 0.0


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_sam_encode_decode_and_text_equal_flax(dtype):
    jm, v, pm = twin(dtype)
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (1, 128, 128, 3)).astype(np.uint8)
    pts = rng.uniform(0, 128, (3, 2, 2)).astype(np.float32)
    lbl = np.array([[2, 3], [1, 0], [1, -1]], np.int32)
    ids = np.stack([J.tokenize_text("fish"), J.tokenize_text("a guppy")])
    with precision(dtype):
        je = apply(jm, "encode")(v, jnp.asarray(img))
        jmk, jiou = apply(jm, "decode")(v, je[0], jnp.asarray(pts),
                                        jnp.asarray(lbl))
        jtm, jti = apply(jm, "decode_text")(v, je[0], jnp.asarray(ids))
    with torch.no_grad():
        pe = pm.encode(torch.from_numpy(img))
        pmk, piou = pm.decode(pe[0], torch.from_numpy(pts),
                              torch.from_numpy(lbl))
        ptm, pti = pm.decode_text(pe[0], torch.from_numpy(ids))
        # forward = decode(encode(.)), here on one prompt
        pfm, pfi = pm(torch.from_numpy(img), torch.from_numpy(pts[:1]),
                      torch.from_numpy(lbl[:1]))
    assert pe.dtype == torch.float32 and pmk.dtype == torch.float32
    for w, g in ((je, pe), (jmk, pmk), (jiou, piou), (jtm, ptm),
                 (jti, pti), (jmk[:1], pfm), (jiou[:1], pfi)):
        assert err(w, g) <= tol(dtype)


def test_bfloat16_policy_rounds_like_flax():
    """The bfloat16 model departs from its float32 self as flax's does:
    the policy is not float32 in disguise."""
    img = np.random.default_rng(8).integers(
        0, 256, (1, 128, 128, 3)).astype(np.uint8)
    out = {}
    for dtype in DTYPES:
        jm, v, pm = twin(dtype)
        with precision(dtype):
            je = apply(jm, "encode")(v, jnp.asarray(img))
        with torch.no_grad():
            out[dtype] = (np.asarray(je, np.float32),
                          pm.encode(torch.from_numpy(img)).numpy())
    j = np.abs(out["bfloat16"][0] - out["float32"][0]).mean()
    p = np.abs(out["bfloat16"][1] - out["float32"][1]).mean()
    assert j > 1e-4 and p > 1e-4
    assert p < 1.25 * j and j < 1.25 * p


@pytest.mark.parametrize("q,length", [(8, 7), (8, 31), (8, 15), (5, 4),
                                      (14, 27), (3, 40)])
def test_rel_pos_resizes_like_jax(q, length):
    table = np.random.default_rng(length).normal(
        0, 1, (length, 16)).astype(np.float32)
    with jax.default_matmul_precision("float32"):
        want = J._rel_pos(q, q, jnp.asarray(table))
    got = P._rel_pos(q, q, torch.from_numpy(table))
    assert err(want, got) <= 1e-6


@pytest.mark.parametrize("src,dst", [(5, 13), (13, 5), (64, 32), (7, 7),
                                     (3, 40), (40, 3), (4, 8), (8, 4)])
def test_resize_axis_equals_jax_image_resize(src, dst):
    x = np.random.default_rng(src * 100 + dst).normal(
        0, 1, (2, src, 3)).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), (2, dst, 3), "linear")
    got = P.resize_axis(torch.from_numpy(x), 1, dst)
    assert err(want, got) <= 1e-6


@pytest.mark.parametrize("model_img,image", [(128, 64), (64, 128)])
def test_pos_embed_branch_equals_flax(model_img, image):
    """An image smaller or larger than the model's: ``pos_embed`` is
    resized down or up to the patch grid (the global block's tables are
    made for the grid the image gives, in both packages)."""
    cfg = dict(CFG, img_size=model_img)
    jm, v, pm = twin("float32", with_text=False, cfg=cfg, img=image)
    img = np.random.default_rng(9).integers(
        0, 256, (1, image, image, 3)).astype(np.uint8)
    with jax.default_matmul_precision("float32"):
        want = apply(jm, "encode")(v, jnp.asarray(img))
    with torch.no_grad():
        got = pm.encode(torch.from_numpy(img))
    assert tuple(pm.image_encoder.pos_embed.shape[1:3]) \
        == (model_img // 16,) * 2
    assert err(want, got) <= F32_TOL


def _official(seed=0):
    ref = RefSam(img_size=128, dim=32, depth=2, heads=2, global_idx=(1,))
    randomize(ref, seed)
    return ref.eval(), ref.state_dict()


def test_convert_sam_checkpoint_equals_the_jax_converter():
    """Official names (tests/sam_torch_ref.py) through both converters:
    the port's state equals the JAX package's variables carried across,
    bit for bit, and the port's forward equals the official modules'."""
    ref, sd = _official(3)
    state = P.convert_sam_checkpoint(sd)
    via_jax = P.state_from_flax(J.convert_sam_checkpoint(sd))
    assert sorted(state) == sorted(via_jax)
    for k in state:
        assert np.array_equal(state[k], via_jax[k]), k
    pm = P.build(**CFG, dtype=torch.float32, state=state, device="cpu")
    rng = np.random.default_rng(1)
    img = rng.integers(0, 255, (1, 128, 128, 3)).astype(np.float32)
    pts = np.array([[[40.0, 60.0], [90.0, 30.0]]], np.float32)
    lbl = np.array([[2, 3]], np.int32)
    with torch.no_grad():
        want = ref(torch.from_numpy(img), torch.from_numpy(pts),
                   torch.from_numpy(lbl))
        got = pm(torch.from_numpy(img), torch.from_numpy(pts),
                 torch.from_numpy(lbl))
    # the official decoder's LayerNorms take epsilon 1e-5, the JAX
    # package's (and the port's) 1e-6: tests/test_sam_torch.py's bound
    for w, g in zip(want, got):
        assert err(w.numpy(), g) <= 1e-2


def test_official_state_dict_inverts_the_converter():
    _, sd = _official(4)
    back = P.official_state_dict(P.convert_sam_checkpoint(sd))
    assert set(back) <= set(sd)
    assert not {k for k in set(sd) - set(back)
                if not k.startswith("prompt_encoder.mask_downscaling")}
    for k, t in back.items():
        assert torch.equal(t, sd[k].float()), k


@pytest.mark.parametrize("with_text", [False, True])
def test_state_from_flax_names_every_parameter(with_text):
    jm = J.SAM(**CFG, with_text=with_text)
    state = P.state_from_flax(seeded_variables(jm, 1, 128, with_text))
    pm = P.SAM(**CFG, with_text=with_text)
    assert sorted(state) == sorted(pm.state_dict())
    P.load_state(pm, state)


def test_load_state_takes_the_tables_shapes():
    """A state whose position tables do not fit the model's sizes loads;
    the forward resizes them (flax would refuse such variables)."""
    state = {k: v.numpy() for k, v in P.build(
        **dict(CFG, img_size=64), dtype=torch.float32,
        device="cpu").state_dict().items()}
    pm = P.build(**CFG, dtype=torch.float32, state=state, device="cpu")
    assert tuple(pm.image_encoder.pos_embed.shape) == (1, 4, 4, 32)
    assert tuple(pm.image_encoder.block1.attn.rel_pos_h.shape) == (7, 16)
    with torch.no_grad():
        emb = pm.encode(torch.zeros(1, 128, 128, 3))
    assert emb.shape == (1, 8, 8, 256) and torch.isfinite(emb).all()
    bad = dict(state)
    bad["image_encoder.neck0.weight"] = np.zeros((256, 16, 1, 1))
    with pytest.raises(ValueError, match="neck0"):
        P.build(**CFG, dtype=torch.float32, state=bad, device="cpu")


def test_random_init_is_seeded_and_finite():
    a = P.build(**CFG, with_text=True, device="cpu",
                generator=torch.Generator().manual_seed(3))
    b = P.build(**CFG, with_text=True, device="cpu",
                generator=torch.Generator().manual_seed(3))
    for (ka, ta), (kb, tb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(ta, tb)
    with torch.no_grad():
        emb = a.encode(torch.zeros(1, 128, 128, 3, dtype=torch.uint8))
        masks, iou = a.decode(emb[0], torch.tensor([[[10.0, 10], [50, 60]]]),
                              torch.tensor([[2, 3]], dtype=torch.int32))
    assert masks.shape == (1, 4, 32, 32) and iou.shape == (1, 4)
    assert torch.isfinite(masks).all() and torch.isfinite(iou).all()
    assert next(a.image_encoder.block0.mlp.lin1.parameters()).dtype \
        == torch.bfloat16

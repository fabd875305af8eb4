"""The port's tag network (trex_tpu_torch/ml/tagwork.py: B13 and the tag
training step) held to the JAX package's (trex_tpu/ml/tagwork.py), the
twin of tests/test_tagwork.py: random keras stacks over every supported
layer and option, files written by either package read by the other, the
reference protocol, the weight carriers and training from one seed.

Tolerances: forwards within rtol 1e-4 and atol 1e-3 (tests/
test_tagwork.py's); the decoder's p within 1e-6; the parameters after one
training step within 1e-5 and after 20 within 1e-3."""
import numpy as np
import pytest

import trex_tpu.ml.tagwork as J
import trex_tpu_torch.ml.tagwork as T

RTOL, ATOL = 1e-4, 1e-3


def _conv(rng, name, cin, cout, k=3, **cfg):
    c = {"name": name, "activation": "linear", "padding": "valid",
         "strides": [1, 1], "use_bias": True}
    c.update(cfg)
    w = [rng.normal(0, 0.3, (k, k, cin, cout)).astype(np.float32)]
    if c["use_bias"]:
        w.append(rng.normal(0, 0.1, cout).astype(np.float32))
    return ("Conv2D", c, w)


def _bn(rng, name, ch, scale=True, center=True):
    w = []
    if scale:
        w.append(rng.uniform(0.5, 1.5, ch).astype(np.float32))
    if center:
        w.append(rng.normal(0, 0.2, ch).astype(np.float32))
    w += [rng.normal(0, 0.3, ch).astype(np.float32),
          rng.uniform(0.5, 2.0, ch).astype(np.float32)]
    return ("BatchNormalization", {"name": name, "scale": scale,
                                   "center": center, "epsilon": 1e-3}, w)


def _dense(rng, name, cin, cout, act="linear", bias=True):
    w = [rng.normal(0, 0.1, (cin, cout)).astype(np.float32)]
    if bias:
        w.append(rng.normal(0, 0.1, cout).astype(np.float32))
    return ("Dense", {"name": name, "activation": act, "use_bias": bias}, w)


def _stacks():
    """(name, input shape (H, W, C), layer specs) covering every layer in
    _SUPPORTED and every option of the forward."""
    rng = np.random.default_rng(0)
    out = []
    # valid / same, strides 1 and 2, each activation, BN variants
    for pad in ("valid", "same"):
        for stride in (1, 2):
            for act in ("relu", "sigmoid", "tanh", "linear", "softmax"):
                specs = [
                    ("InputLayer", {"name": "input"}, []),
                    _conv(rng, "c0", 1, 4, padding=pad,
                          strides=[stride, stride], activation=act),
                    _bn(rng, "bn0", 4, scale=stride == 1,
                        center=pad == "valid"),
                    ("MaxPooling2D", {"name": "p0", "pool_size": [2, 2],
                                      "padding": pad}, []),
                    ("Dropout", {"name": "d0", "rate": 0.5}, []),
                    _conv(rng, "c1", 4, 3, k=2, padding=pad,
                          use_bias=False),
                    ("Activation", {"name": "a0", "activation": "relu"},
                     []),
                    ("Flatten", {"name": "f"}, []),
                ]
                side = 13 if stride == 2 else 11
                specs += [_dense(rng, "dense", _flat(specs, side), 5,
                                 act="softmax" if act == "tanh" else
                                 "linear")]
                out.append((f"{pad}-s{stride}-{act}", (side, side, 1),
                            specs))
    # pooling with its own strides and "same"; cropping; spatial
    # dropout; a Dense on a 4-D tensor (keras's last axis); BN without
    # both gamma and beta; a softmax Activation after a convolution
    specs = [
        _conv(rng, "c0", 2, 6, padding="same", activation="relu"),
        ("Cropping2D", {"name": "crop", "cropping": [[1, 2], [0, 1]]}, []),
        ("MaxPooling2D", {"name": "p0", "pool_size": [3, 3],
                          "strides": [2, 2], "padding": "same"}, []),
        ("SpatialDropout2D", {"name": "sd", "rate": 0.2}, []),
        _bn(rng, "bn", 6, scale=False, center=False),
        _dense(rng, "d4", 6, 4, act="relu"),
        ("Activation", {"name": "sm", "activation": "softmax"}, []),
    ]
    out.append(("pool-crop-dense4d", (10, 9, 2), specs))
    specs = [
        _conv(rng, "c0", 1, 3, padding="valid", activation="softmax"),
        ("MaxPooling2D", {"name": "p0", "pool_size": [2, 2],
                          "strides": [1, 1], "padding": "valid"}, []),
        ("Flatten", {"name": "f"}, []),
        _bn(rng, "bn", 3 * 5 * 5, scale=True, center=False),
        _dense(rng, "dense", 75, 4, act="softmax", bias=False),
    ]
    out.append(("softmax-conv-bn1d", (8, 8, 1), specs))
    return out


def _flat(specs, side):
    """The flattened width of a spec stack at input side `side` (read
    from the JAX forward)."""
    layers = [J._Layer(k, c, w) for k, c, w in specs]
    fwd = J._build_forward(layers)
    return int(np.asarray(fwd(np.zeros((1, side, side, 1),
                                       np.float32))).shape[-1])


def _jax_model(specs):
    return J.KerasSequential([J._Layer(k, c, w) for k, c, w in specs])


def _port_model(specs):
    return T.KerasSequential([T._Layer(k, c, w) for k, c, w in specs],
                             device="cpu")


@pytest.mark.parametrize("name,shape,specs", _stacks(),
                         ids=[s[0] for s in _stacks()])
def test_keras_sequential_equals_jax(name, shape, specs):
    rng = np.random.default_rng(1)
    x = rng.uniform(0, 255, (3,) + shape).astype(np.float32)
    want = _jax_model(specs).predict(x)
    got = _port_model(specs).predict(x)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_files_of_either_package_load_in_the_other(tmp_path, writer):
    _name, shape, specs = _stacks()[7]
    path = tmp_path / "m.h5"
    (J if writer == "jax" else T).save_keras_sequential_h5(path, specs)
    x = np.random.default_rng(2).uniform(0, 255, (4,) + shape)
    jm = J.load_keras_sequential_h5(path)
    pm = T.load_keras_sequential_h5(path, device="cpu")
    for a, b in zip(jm.layers, pm.layers):
        assert (a.kind, a.cfg) == (b.kind, b.cfg)
        for wa, wb in zip(a.weights, b.weights):
            np.testing.assert_array_equal(wa, wb)
    np.testing.assert_allclose(pm.predict(x), jm.predict(x),
                               rtol=RTOL, atol=ATOL)


def test_unsupported_layer_and_options_rejected(tmp_path):
    path = tmp_path / "bad.h5"
    T.save_keras_sequential_h5(path, [("LSTM", {"name": "lstm"}, [])])
    with pytest.raises(ValueError, match="unsupported keras layer"):
        T.load_keras_sequential_h5(path, device="cpu")
    rng = np.random.default_rng(0)
    spec = _conv(rng, "c", 1, 2, dilation_rate=[2, 2])
    with pytest.raises(ValueError, match="dilation_rate"):
        _port_model([spec])
    spec = _dense(rng, "d", 3, 2, act="swish")
    with pytest.raises(ValueError, match="unsupported activation"):
        _port_model([spec])


def _write_test_h5(module, path, rng, size=8):
    conv_k = rng.normal(0, 0.5, (3, 3, 1, 4)).astype(np.float32)
    conv_b = rng.normal(0, 0.1, 4).astype(np.float32)
    s = (size - 2) // 2
    dense_w = rng.normal(0, 0.1, (s * s * 4, 5)).astype(np.float32)
    dense_b = rng.normal(0, 0.1, 5).astype(np.float32)
    module.save_keras_sequential_h5(path, [
        ("Conv2D", {"name": "conv2d", "activation": "relu",
                    "padding": "valid", "strides": [1, 1],
                    "use_bias": True}, [conv_k, conv_b]),
        ("MaxPooling2D", {"name": "max_pooling2d", "pool_size": [2, 2],
                          "padding": "valid"}, []),
        ("Flatten", {"name": "flatten"}, []),
        ("Dense", {"name": "dense", "activation": "linear",
                   "use_bias": True}, [dense_w, dense_b]),
    ])


def test_tagwork_predict_equals_jax(tmp_path):
    rng = np.random.default_rng(1)
    path = tmp_path / "m.h5"
    _write_test_h5(T, path, rng)
    jt = J.Tagwork(8, 8, path)
    jt.load()
    pt = T.Tagwork(8, 8, path, device="cpu")
    pt.load()
    imgs = rng.uniform(0, 255, (16, 8, 8)).astype(np.uint8)
    got = pt.predict(imgs)
    assert got.dtype == np.int64 and got.shape == (16,)
    np.testing.assert_array_equal(got, jt.predict(imgs))


def test_decoder_from_settings_equals_jax(tmp_path):
    from trex_tpu.config import reset_global_settings as jreset
    from trex_tpu_torch.config import reset_global_settings as preset

    rng = np.random.default_rng(4)
    path = tmp_path / "m.h5"
    _write_test_h5(J, path, rng)
    decs = []
    for reset, kw in ((jreset, {}), (preset, {"device": "cpu"})):
        s = reset()
        s["tags_recognize"] = True
        s["tags_model_path"] = str(path)
        s["tags_image_size"] = [8, 8]
        mod = J if reset is jreset else T
        decs.append(mod.tag_decoder_from_settings(s, **kw))
    jdec, pdec = decs
    crops = [rng.uniform(0, 255, shp).astype(np.uint8)
             for shp in [(20, 24), (8, 8), (5, 3), (32, 32), (16, 16)]]
    # the batch form decodes a frame's crops in one forward: each id
    # equal and each p within 1e-6 of the JAX decoder's per-image call
    ids, ps = pdec.batch(crops)
    assert ids.dtype == np.int64 and ps.shape == (len(crops),)
    for crop, i, p in zip(crops, ids, ps):
        jid, jp = jdec(crop)
        assert int(i) == jid and abs(float(p) - jp) <= 1e-6
    # the per-image form (track/tags.py's decode_fn) is the batch of one
    for crop in crops:
        jid, jp = jdec(crop)
        pid, pp = pdec(crop)
        assert pid == jid
        assert abs(pp - jp) <= 1e-6
    s = preset()
    s["tags_recognize"] = True
    s["tags_model_path"] = str(tmp_path / "missing.h5")
    assert T.tag_decoder_from_settings(s, device="cpu") is None


def test_probability_outputs_pass_through(tmp_path):
    """A model ending in softmax: p is the largest probability."""
    rng = np.random.default_rng(5)
    specs = [("Flatten", {"name": "f"}, []),
             _dense(rng, "d", 64, 3, act="softmax")]
    path = tmp_path / "sm.h5"
    T.save_keras_sequential_h5(path, specs)
    tw = T.Tagwork(8, 8, path, device="cpu")
    tw.load()
    dec = T.TagDecoder(tw)
    jtw = J.Tagwork(8, 8, path)
    jtw.load()
    imgs = [rng.integers(0, 255, (8, 8), np.uint8) for _ in range(3)]
    i, p = dec(imgs[0])
    out = jtw.model.predict(255.0 - imgs[0][None].astype(np.float64))[0]
    assert i == int(np.argmax(out))
    assert abs(p - float(np.max(out))) <= 1e-6
    # the batch form takes the same branch row by row, held to the JAX
    # model's probabilities within 1e-6
    ids, ps = dec.batch(imgs)
    outs = jtw.model.predict(255.0 - np.stack(imgs).astype(np.float64))
    np.testing.assert_array_equal(ids, np.argmax(outs, axis=1))
    np.testing.assert_allclose(ps, np.max(outs, axis=1), rtol=0, atol=1e-6)


def test_weight_carriers_both_ways():
    jnet = J.TagDecoderNet(7, size=16, seed=3)
    pnet = T.TagDecoderNet(7, size=16, seed=3, device="cpu")
    # the same numpy initialisation from the seed
    for k in jnet.params:
        for a, b in zip(jnet.params[k], pnet.to_params()[k]):
            np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(0)
    params = {k: [rng.normal(size=np.shape(a)).astype(np.float32)
                  for a in v] for k, v in jnet.params.items()}
    net = T.TagDecoderNet.from_params(params, device="cpu")
    assert (net.size, net.n_classes) == (16, 7)
    back = net.to_params()
    for k in params:
        for a, b in zip(params[k], back[k]):
            np.testing.assert_array_equal(a, b)
    import torch

    x = rng.uniform(0, 255, (5, 16, 16, 1)).astype(np.float32)
    want = np.asarray(J.TagDecoderNet.apply(params, x))
    with torch.no_grad():
        got = net(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    # and the .h5 carrier: layer_specs through either package's file
    for k, (a, b) in enumerate(zip(net.layer_specs(),
                                   J.TagDecoderNet(7, 16).layer_specs())):
        assert a[0] == b[0] and a[1] == b[1]


def _quadrants(n_per=50, size=16, seed=2):
    """tests/test_tagwork.py's set: a dark quadrant encodes the id."""
    rng = np.random.default_rng(seed)
    imgs, labels = [], []
    for cls in range(4):
        for _ in range(n_per):
            img = rng.uniform(180, 255, (size, size))
            qy, qx = divmod(cls, 2)
            img[qy * 8:(qy + 1) * 8, qx * 8:(qx + 1) * 8] = \
                rng.uniform(0, 60, (8, 8))
            imgs.append(img)
            labels.append(cls)
    return np.asarray(imgs, np.uint8), np.asarray(labels)


@pytest.mark.parametrize("epochs,n_per,tol", [(1, 16, 1e-5),
                                              (10, 50, 1e-3)],
                         ids=["one-step", "twenty-steps"])
def test_training_equals_jax(epochs, n_per, tol):
    """One step (64 images, one batch) and 20 steps (200 images, two
    batches an epoch, 10 epochs) from the same seed."""
    imgs, labels = _quadrants(n_per=n_per)
    jnet = J.train_tag_decoder(imgs, labels, n_classes=4, epochs=epochs,
                               seed=3)
    pnet = T.train_tag_decoder(imgs, labels, n_classes=4, epochs=epochs,
                               seed=3, device="cpu")
    got = pnet.to_params()
    for k in jnet.params:
        for a, b in zip(jnet.params[k], got[k]):
            np.testing.assert_allclose(b, a, rtol=0, atol=tol)


def test_train_then_export_then_decode(tmp_path):
    imgs, labels = _quadrants()
    net = T.train_tag_decoder(imgs, labels, n_classes=4, epochs=12,
                              seed=3, device="cpu")
    path = tmp_path / "tags.h5"
    T.save_keras_sequential_h5(path, net.layer_specs())
    tw = T.Tagwork(16, 16, path, device="cpu")
    tw.load()
    acc = (tw.predict(imgs) == labels).mean()
    assert acc > 0.95, f"decoder accuracy {acc}"
    # the JAX package decodes the port's file the same way
    jt = J.Tagwork(16, 16, path)
    jt.load()
    np.testing.assert_array_equal(jt.predict(imgs), tw.predict(imgs))

"""The PyTorch port's YOLOv4 oracle against the JAX package, on the CPU.

* Weight loading: the port's `load_darknet_weights` on the numpy golden
  file of tests/test_yolov4.py::TestDarknetGolden (the published
  yolov4.cfg layer table, interpreted in numpy) gives heads within
  rtol=atol=2e-3 of the numpy reference (the JAX test's tolerance) and
  within 1e-4 of JAX's heads on the same file (float32 sums in another
  order through 110 layers); `convert_flax_variables` equals the loader;
  short and over-long files are refused.
* Preprocessing at 1280x720 -> 608 within 1e-4 of JAX (the antialiased
  bilinear downsample; a small frame cannot tell it from a plain one).
* `postprocess` on JAX's raw heads: valid flags and classes equal, boxes
  and scores within 2e-6 relative (the two libraries' exp and sigmoid
  differ by up to one float32 ulp).
* `make_yolo_detector` against JAX's at 64x64, 2 classes, the same
  BoxRecs, and the doubled-width scaling check.
* The cfg executor equals the hand model on cova_tpu/models/cfg/yolov4.cfg,
  and executes the yolov4-tiny features as JAX's does.
"""

import functools
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cova_tpu.models import darknet_cfg as jdk
from cova_tpu.models import yolov4 as jy
from cova_tpu_torch.models import darknet_cfg as tdk
from cova_tpu_torch.models import yolov4 as ty

# The suite runs one test worker per core: keep torch to one thread each.
torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
CFG = REPO / "cova_tpu" / "models" / "cfg" / "yolov4.cfg"
NC = 2
S = 64


def _total_floats(model):
    return sum(p.numel() for k, p in model.state_dict().items()
               if not k.endswith("num_batches_tracked"))


def _write_weights(path, buf):
    with open(path, "wb") as f:
        f.write(np.asarray([0, 2, 5], np.int32).tobytes())  # version
        f.write(np.asarray([0], np.int64).tobytes())  # images seen
        f.write(np.asarray(buf, np.float32).tobytes())
    return str(path)


def _jax_yolov4(num_classes):
    """The Flax YOLOv4 and its variables' structure: shapes only, since
    the darknet loader overwrites every leaf and a real init takes ~25 s.
    The loader walks the params in creation order, which eval_shape's
    output (keys sorted) loses, so the order is read inside the trace."""
    from flax.traverse_util import flatten_dict, unflatten_dict

    model = jy.YOLOv4(num_classes)
    order = {}

    def init():
        v = model.init(jax.random.PRNGKey(0), jnp.zeros((1, S, S, 3)), train=False)
        order.update({c: list(flatten_dict(v[c])) for c in v})
        return v

    shapes = jax.eval_shape(init)
    variables = {
        c: unflatten_dict({k: flatten_dict(shapes[c])[k] for k in keys})
        for c, keys in order.items()
    }
    return model, variables


def _heads_np(outs):
    return [o.detach().numpy() for o in outs]


@functools.lru_cache(maxsize=None)
def _golden_layers():
    spec = importlib.util.spec_from_file_location(
        "jax_test_yolov4", REPO / "tests" / "test_yolov4.py"
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.TestDarknetGolden._cfg_layers()


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    """The numpy golden of TestDarknetGolden (seed 42, 64x64, 80 classes):
    (input, numpy reference heads, weights path, JAX loaded variables,
    JAX heads)."""
    from numpy.lib.stride_tricks import sliding_window_view

    layers = _golden_layers()
    rng = np.random.default_rng(42)
    x0 = rng.uniform(0, 1, (S, S, 3)).astype(np.float32)
    buf, outs, heads = [], [], []

    def np_conv(x, w, stride):
        cout, cin, k, _ = w.shape
        p = k // 2
        sw = sliding_window_view(np.pad(x, ((p, p), (p, p), (0, 0))), (k, k),
                                 axis=(0, 1))[::stride, ::stride]
        ho, wo = sw.shape[:2]
        cols = sw.transpose(0, 1, 3, 4, 2).reshape(ho * wo, k * k * cin)
        return (cols @ w.transpose(2, 3, 1, 0).reshape(k * k * cin, cout)).reshape(
            ho, wo, cout)

    x = x0
    for li, layer in enumerate(layers):
        kind = layer[0]
        if kind == "conv":
            _, f, k, s, act = layer
            cin = x.shape[-1]
            if act == "linear":
                bias = rng.normal(0, 0.1, f).astype(np.float32)
                buf.append(bias)
            else:
                bn_bias = rng.normal(0, 0.1, f).astype(np.float32)
                bn_scale = rng.uniform(0.9, 1.1, f).astype(np.float32)
                bn_mean = rng.normal(0, 0.1, f).astype(np.float32)
                bn_var = rng.uniform(0.8, 1.2, f).astype(np.float32)
                buf += [bn_bias, bn_scale, bn_mean, bn_var]
            w = rng.normal(0, 0.5 * np.sqrt(2.0 / (k * k * cin)),
                           (f, cin, k, k)).astype(np.float32)
            buf.append(w.reshape(-1))
            y = np_conv(x, w, s)
            if act == "linear":
                y = y + bias
            else:
                y = (y - bn_mean) * bn_scale / np.sqrt(bn_var + 1e-5) + bn_bias
            if act == "mish":
                y = y * np.tanh(np.logaddexp(0.0, y))
            elif act == "leaky":
                y = np.where(y > 0, y, 0.1 * y)
            x = y
        elif kind == "route":
            x = np.concatenate([outs[r if r >= 0 else li + r] for r in layer[1]], -1)
        elif kind == "shortcut":
            x = x + outs[li + layer[1]]
        elif kind == "upsample":
            x = x.repeat(2, axis=0).repeat(2, axis=1)
        elif kind == "maxpool":
            p = layer[1] // 2
            xp = np.pad(x, ((p, p), (p, p), (0, 0)), constant_values=-np.inf)
            x = sliding_window_view(xp, (layer[1],) * 2, axis=(0, 1)).max(axis=(-2, -1))
        elif kind == "yolo":
            heads.append(outs[li - 1])
            x = outs[li - 1]
        outs.append(x)

    path = tmp_path_factory.mktemp("golden") / "golden.weights"
    with open(path, "wb") as fh:
        fh.write(np.zeros(5, np.int32).tobytes())
        fh.write(np.concatenate([b.reshape(-1) for b in buf]).tobytes())
    model, variables = _jax_yolov4(80)
    loaded = jy.load_darknet_weights(variables, str(path), num_classes=80)
    jheads = [np.asarray(o)[0] for o in model.apply(loaded, jnp.asarray(x0[None]),
                                                     train=False)]
    return x0, heads, str(path), loaded, jheads


def test_layer_order_matches_cfg():
    """Registration order walks yolov4.cfg (the darknet stream's order):
    the same progression tests/test_yolov4.py pins for the Flax module."""
    couts = [m.conv.out_channels for m in ty.darknet_convs(ty.YOLOv4(NC))]
    assert couts[:17] == [
        32,
        64, 64, 64, 32, 64, 64, 64,
        128, 64, 64, 64, 64, 64, 64, 64, 128,
    ]
    assert len(couts) == 110
    assert [i for i, c in enumerate(couts) if c == 3 * (5 + NC)] == [93, 101, 109]


def test_loader_matches_numpy_golden_and_jax(golden):
    x0, ref, path, _, jheads = golden
    model = ty.load_darknet_weights(ty.create_yolov4(80, device="cpu"), path)
    got = _heads_np(model(torch.from_numpy(x0[None])))
    for ours, r, j, name in zip(got, ref, jheads, ("p3", "p4", "p5")):
        assert ours[0].shape == r.shape == j.shape, name
        np.testing.assert_allclose(ours[0], r, rtol=2e-3, atol=2e-3, err_msg=name)
        np.testing.assert_allclose(ours[0], j, rtol=1e-4, atol=1e-4, err_msg=name)


def test_convert_flax_variables_equals_loader(golden):
    x0, _, path, jvars, _ = golden
    loaded = ty.load_darknet_weights(ty.create_yolov4(80, device="cpu"), path)
    sd = ty.convert_flax_variables(jax.tree_util.tree_map(np.asarray, jvars))
    ref = loaded.state_dict()
    assert sorted(sd) == sorted(ref)
    for k in ref:
        assert torch.equal(sd[k], ref[k]), k
    converted = ty.YOLOv4(80)
    converted.load_state_dict(sd)
    x = torch.from_numpy(x0[None])
    for a, b in zip(converted(x), loaded(x)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("extra,match", [(-7, "too short"), (5, "trailing floats")])
def test_bad_length_files_refused(tmp_path, extra, match):
    model = ty.YOLOv4(NC)
    total = _total_floats(model)
    path = tmp_path / "bad.weights"
    with open(path, "wb") as f:
        f.write(np.zeros(5, np.int32).tobytes())
        f.write(np.ones(total + extra, np.float32).tobytes())
    with pytest.raises(ValueError, match=match):
        ty.load_darknet_weights(model, str(path))
    # The JAX loader refuses the same file with the same message.
    _, variables = _jax_yolov4(NC)
    with pytest.raises(ValueError, match=match):
        jy.load_darknet_weights(variables, str(path), num_classes=NC)


def _frame(rng, h, w):
    """A seeded I420 frame: smooth gradients plus noise and a few flat
    rectangles, so both smooth and sharp content reach the resize."""
    yy, xx = np.mgrid[0:h, 0:w]
    y = (128 + 60 * np.sin(xx / 37.0) * np.cos(yy / 23.0)
         + rng.normal(0, 20, (h, w)))
    for _ in range(6):
        t, l = rng.integers(0, h - 40), rng.integers(0, w - 60)
        y[t : t + 40, l : l + 60] = rng.integers(0, 256)
    u = rng.integers(0, 256, (h // 2, w // 2))
    v = rng.integers(0, 256, (h // 2, w // 2))
    return (np.clip(y, 0, 255).astype(np.uint8), u.astype(np.uint8), v.astype(np.uint8))


@pytest.mark.parametrize("h,w", [(720, 1280), (736, 1280), (96, 128)])
def test_preprocess_matches_jax(h, w):
    y, u, v = _frame(np.random.default_rng(h), h, w)
    ref = np.asarray(jy.preprocess_frames(jnp.asarray(y), jnp.asarray(u), jnp.asarray(v)))
    got = ty.preprocess_frames(torch.from_numpy(y), torch.from_numpy(u),
                               torch.from_numpy(v)).numpy()
    assert got.shape == ref.shape == (1, 608, 608, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


def _raw_heads(rng, nc, size=608, bias=0.0):
    """Seeded raw heads at the network's output shapes."""
    return [
        (rng.normal(0, 2.0, (1, size // s, size // s, 3 * (5 + nc))) + bias).astype(
            np.float32)
        for s in ty.STRIDES
    ]


def _assert_post_equal(got, ref):
    (gb, gs, gc, gv), (rb, rs, rc, rv) = [[np.asarray(a) for a in t] for t in (got, ref)]
    np.testing.assert_array_equal(gv, rv)
    np.testing.assert_array_equal(gc, rc)
    np.testing.assert_allclose(gb, rb, rtol=2e-6, atol=1e-5)
    np.testing.assert_allclose(gs, rs, rtol=2e-6, atol=0)
    assert gc.dtype == np.int32 and gv.dtype == bool


@pytest.mark.parametrize(
    "seed,score_threshold,bias", [(0, 0.25, -2.0), (1, 0.25, 0.0), (2, 0.0, -1.0)]
)
def test_postprocess_on_jax_heads_matches(seed, score_threshold, bias):
    heads = _raw_heads(np.random.default_rng(seed), 80, bias=bias)
    ref = jy.postprocess([jnp.asarray(h) for h in heads], 80, 608,
                         score_threshold=score_threshold)
    got = ty.postprocess([torch.from_numpy(h) for h in heads], 80, 608,
                         score_threshold=score_threshold)
    _assert_post_equal(got, ref)
    assert 0 < int(np.asarray(ref[3]).sum())


def test_decode_head_matches_jax():
    raw = _raw_heads(np.random.default_rng(3), NC, size=64)[0]
    args = (ty.ANCHORS[0], 8, 1.2, NC, 64)
    rb, rs = jy.decode_head(jnp.asarray(raw), *args)
    gb, gs = ty.decode_head(torch.from_numpy(raw), *args)
    np.testing.assert_allclose(gb.numpy(), np.asarray(rb), rtol=2e-6, atol=1e-5)
    np.testing.assert_allclose(gs.numpy(), np.asarray(rs), rtol=2e-6, atol=0)


def _synthetic_file(tmp_path, total, seed=1):
    """tests/test_yolov4.py's recipe: tiny positive floats keep BN
    variances valid and 110 stacked convs finite."""
    buf = np.random.default_rng(seed).uniform(1e-3, 3e-3, total)
    return _write_weights(tmp_path / "synth.weights", buf)


def _recs_equal(got, ref):
    assert len(got) == len(ref) > 0
    for g, r in zip(got, ref):
        assert (g.class_id, g.timestamp, g.track_id) == (r.class_id, r.timestamp, r.track_id)
        for key in ("left", "top", "width", "height", "area", "confidence"):
            assert getattr(g, key) == pytest.approx(getattr(r, key), rel=1e-4, abs=1e-3), key


def test_make_yolo_detector_matches_jax(tmp_path, monkeypatch):
    path = _synthetic_file(tmp_path, _total_floats(ty.YOLOv4(NC)))
    # JAX's factory draws a random init that the weights file then
    # overwrites; the shape-only structure skips the 25 s draw.
    monkeypatch.setattr(jy, "create_yolov4", lambda rng, nc, size: _jax_yolov4(nc))
    kw = dict(num_classes=NC, input_size=S, score_threshold=0.0)
    det = ty.make_yolo_detector(path, device="cpu", **kw)
    jdet = jy.make_yolo_detector(path, **kw)
    rng = np.random.default_rng(5)
    h, w = 96, 128
    y, u, v = _frame(rng, h, w)
    recs = det([(1.5, y, u, v)])
    _recs_equal(recs, jdet([(1.5, y, u, v)]))
    for r in recs:
        assert r.timestamp == 1.5 and 0 <= r.class_id < NC
        assert r.width > 0 and r.height > 0 and r.confidence > 0

    # Scaling: a uniform frame double the width gives the same raw boxes
    # back with doubled x extents.
    flat = [np.full((h, w), 128, np.uint8), np.full((h // 2, w // 2), 128, np.uint8)]
    flat2 = [np.full((h, 2 * w), 128, np.uint8), np.full((h // 2, w), 128, np.uint8)]
    recs1 = det([(1.5, flat[0], flat[1], flat[1])])
    recs2 = det([(1.5, flat2[0], flat2[1], flat2[1])])
    _recs_equal(recs1, jdet([(1.5, flat[0], flat[1], flat[1])]))
    assert len(recs2) == len(recs1)
    assert recs2[0].width == pytest.approx(2 * recs1[0].width, rel=1e-5)
    assert recs2[0].height == pytest.approx(recs1[0].height, rel=1e-5)


def test_cfg_executor_matches_hand_model(tmp_path):
    model_c, heads = tdk.create_darknet(str(CFG), device="cpu")
    model_h = ty.YOLOv4(80)
    total = _total_floats(model_c)
    assert total == _total_floats(model_h)
    path = _synthetic_file(tmp_path, total)
    tdk.load_darknet_weights_cfg(model_c, path)
    ty.load_darknet_weights(model_h, path)
    x = torch.from_numpy(np.random.default_rng(1).uniform(0, 1, (1, S, S, 3)).astype(
        np.float32))
    outs_c, outs_h = model_c(x), model_h(x)
    assert len(outs_c) == len(outs_h) == 3
    for a, b in zip(outs_c, outs_h):
        assert a.shape == b.shape
        assert torch.equal(a, b)  # the same ops in the same order
    assert tuple(h.anchors for h in heads) == ty.ANCHORS
    assert tuple(h.scale_xy for h in heads) == ty.SCALE_XY
    assert all(h.classes == 80 for h in heads)

    # The oracle built through the cfg gives the hand model's detections.
    kw = dict(input_size=S, score_threshold=0.0, device="cpu")
    y, u, v = _frame(np.random.default_rng(2), 96, 128)
    by_cfg = ty.make_yolo_detector(path, cfg_path=str(CFG), **kw)([(0.5, y, u, v)])
    assert by_cfg == ty.make_yolo_detector(path, **kw)([(0.5, y, u, v)])


TINY_CFG = """
[net]
width=31
height=31
channels=3

[convolutional]
batch_normalize=1
filters=8
size=3
stride=1
pad=1
activation=leaky

[route]
layers=-1
groups=2
group_id=1

[maxpool]
size=2
stride=2

[convolutional]
filters=27
size=1
stride=1
pad=1
activation=linear

[yolo]
mask=0,1,2
anchors=10,14, 23,27, 37,58, 81,82, 135,169, 344,319
classes=4
num=6
"""


def test_parser_handles_tiny_variant_features(tmp_path):
    """Grouped routes (yolov4-tiny) and an explicit maxpool stride on an
    odd size, where Flax's "SAME" pads only after: equal to JAX's
    executor on the same weights."""
    model, (head,) = tdk.create_darknet(TINY_CFG, device="cpu")
    total = _total_floats(model)
    path = _synthetic_file(tmp_path, total, seed=3)
    tdk.load_darknet_weights_cfg(model, path)
    x = np.random.default_rng(4).uniform(0, 1, (1, 31, 31, 3)).astype(np.float32)
    (out,) = model(torch.from_numpy(x))
    assert out.shape == (1, 16, 16, 27)  # group halved to 4ch -> pool
    assert head.anchors == ((10, 14), (23, 27), (37, 58)) and head.classes == 4

    jmodel, jvars, _ = jdk.create_darknet(jax.random.PRNGKey(0), TINY_CFG, input_size=31)
    jvars = jdk.load_darknet_weights_cfg(jvars, path)
    (ref,) = jmodel.apply(jvars, jnp.asarray(x), train=False)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("size,k,stride", [(31, 2, 2), (19, 13, 1), (20, 3, 2), (7, 5, 1)])
def test_max_pool_same_matches_flax(size, k, stride):
    import flax.linen as fnn

    x = np.random.default_rng(size).normal(size=(1, size, size, 3)).astype(np.float32)
    ref = np.asarray(fnn.max_pool(jnp.asarray(x), (k, k), strides=(stride, stride),
                                  padding="SAME"))
    got = ty.max_pool_same(torch.from_numpy(x).permute(0, 3, 1, 2), k, stride)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), ref)

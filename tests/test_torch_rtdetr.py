"""RT-DETR (models/rtdetr.py) and its deformable-attention core (K11,
ops/cuda/msda_kernel.py; plain version ops/msda.py).

On the CPU, at a small preset with every kind of block (the vd stem and
its pooled shortcut, AIFI, CSPRepLayer with RepVgg blocks, the valid
mask, query selection, two decoder layers of 3 levels and 4 points, a
128 x 128 input) on seeded random weights:
- the port against the plain reference (tests/rtdetr_plain.py): the
  memory, the token scores and the selection, and the logits and boxes
  against the reference decoder at the port's own tokens;
- the plain core against the reference's grid_sample composition and
  against a direct bilinear sum, with points inside and outside the maps
  and on integer positions;
- the K11 wrapper: its refusals, and no launch on the CPU;
- the post-processing against the reference's, and the detector's
  BoxRecs in frame pixels;
- one CovaPipeline last="full" run of synth_small.mp4 with the RT-DETR
  detector, traced: the model's spans and the oracle's counters;
- the reference's BatchNorm calibration (`calibrated`), which seeded
  weights for the benchmark use;
- bench_port/ref/rtdetr_ref.py byte-equal to tests/rtdetr_plain.py.

On the card (marked `cuda`, skipped without one; run there with
`python -m pytest tests/test_torch_rtdetr.py -m cuda`): K11 against its
plain version at the published shapes (8400 tokens at 80x80, 40x40 and
20x20; 300 queries; 8 heads of 32 channels; 4 points), within 1e-6 of the
plain version's largest output, three times; its refusals; the
published model against the plain reference on a picture.
"""

import dataclasses
import functools
import pathlib
import sys

import numpy as np
import pytest
import torch

from cova_tpu_torch import trace
from cova_tpu_torch.models import rtdetr as R
from cova_tpu_torch.ops import msda
from cova_tpu_torch.ops.cuda.msda_kernel import ms_deform_attn

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tests"))
import rtdetr_plain as P  # noqa: E402

SMALL = REPO / "cova_tpu_torch" / "data" / "synth_small.mp4"
SYNTH = REPO / "artifacts" / "blobnet_synth.npz"
# Every kind of block at a small size: 128 x 128 input (maps 16, 8, 4:
# 336 tokens), one bottleneck a stage (the first with its 1x1 shortcut,
# the others pooled), hidden 64 in 2 heads of 32 channels (K11's), one
# RepVgg block a CSPRepLayer, 30 queries, 2 decoder layers. anchor_eps
# 0.04 masks the 16 x 16 map's border, as 0.01 masks the 80 x 80 map's.
TINY = R.RTDETRConfig(input_size=128, blocks=(1, 1, 1, 1), stem=16, widths=(8, 16, 32, 64),
                      hidden_dim=64, nhead=2, enc_ffn=128, csp_blocks=1, num_queries=30,
                      num_top=30, dec_layers=2, dec_ffn=128, anchor_eps=0.04)
# The port and the reference run the same float32 operations on the CPU
# (the port's core is the plain composition there): equal to rounding.
REL_TOL = 1e-5
# K11 against its plain version: the softmax and the sum over the 12
# samples round in other orders (the sampling coordinates are the same).
KERNEL_REL_TOL = 1e-6


def plain_conf(cfg):
    c = dataclasses.asdict(cfg)
    c["strides"] = list(cfg.strides)
    return c


def seeded_state(cfg, seed):
    """Random weights for every tensor of the model's state dict:
    convolutions and Linear layers near unit gain, norm scales near 1,
    BN statistics and biases near 0."""
    g = torch.Generator().manual_seed(seed)
    model = R.RTDETR(cfg)
    sd = {}
    for name, t in model.state_dict().items():
        leaf = name.rsplit(".", 1)[-1]
        if not t.dtype.is_floating_point:
            sd[name] = t.clone()
        elif leaf == "running_var":
            sd[name] = 0.8 + 0.4 * torch.rand(t.shape, generator=g)
        elif t.dim() == 1 and leaf == "weight":
            sd[name] = 0.9 + 0.2 * torch.rand(t.shape, generator=g)
        elif t.dim() == 1:
            sd[name] = 0.1 * torch.randn(t.shape, generator=g)
        else:
            fan_in = t[0].numel()
            sd[name] = torch.randn(t.shape, generator=g) * (1.0 / fan_in) ** 0.5
    return sd


@functools.lru_cache(maxsize=None)
def tiny_pair(seed=0):
    sd = seeded_state(TINY, seed)
    model = R.RTDETR(TINY).eval()
    model.load_state_dict(sd)
    return model, P.RTDETR(sd, plain_conf(TINY))


def gap(got, ref):
    return float((got - ref).abs().max() / ref.abs().max())


@pytest.mark.parametrize("seed", [0, 1])
def test_port_matches_plain_reference(seed):
    model, ref = tiny_pair(seed)
    x = torch.rand(1, 128, 128, 3, generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        got = model(x)
        memory, shapes = ref.memory(ref.encoder(ref.backbone(x.permute(0, 3, 1, 2).contiguous())))
        sel = ref.select(memory, shapes)
        logits, boxes = ref.decode(memory, shapes, sel, got["indices"])
    assert shapes == TINY.spatial_shapes
    assert got["memory"].shape == (1, 336, 64) and got["indices"].shape == (1, 30)
    assert gap(got["memory"], memory) <= REL_TOL
    assert gap(got["scores"], sel["scores"]) <= REL_TOL
    # The port's tokens are the reference's top 30 (no near-tie here).
    assert sorted(got["indices"][0].tolist()) == sorted(sel["indices"][0].tolist())
    assert gap(got["logits"], logits) <= REL_TOL and gap(got["boxes"], boxes) <= REL_TOL
    # The border of the 16 x 16 map is masked and never selected here.
    valid = model.decoder.valid_mask[0, :, 0]
    assert int((~valid).sum()) == 60 and bool(valid[got["indices"][0]].all())


def test_encode_and_decode_split_the_forward():
    model, _ = tiny_pair()
    x = torch.rand(1, 128, 128, 3, generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        whole = model(x)
        sel = model.encode(model.backbone(x.permute(0, 3, 1, 2).contiguous()))
        logits, boxes = model.decode(sel)
    assert torch.equal(whole["logits"], logits) and torch.equal(whole["boxes"], boxes)
    assert torch.equal(whole["indices"], sel.indices)


def test_parameter_names_are_upstreams():
    names = set(R.RTDETR(TINY).state_dict())
    for name in ("backbone.conv1.conv1_1.conv.weight", "backbone.conv1.conv1_3.norm.running_var",
                 "backbone.res_layers.0.blocks.0.short.conv.weight",
                 "backbone.res_layers.1.blocks.0.short.conv.conv.weight",
                 "backbone.res_layers.3.blocks.0.branch2c.norm.weight",
                 "encoder.input_proj.2.0.weight", "encoder.input_proj.2.1.running_mean",
                 "encoder.encoder.0.layers.0.self_attn.in_proj_weight",
                 "encoder.encoder.0.layers.0.self_attn.out_proj.bias",
                 "encoder.lateral_convs.0.conv.weight",
                 "encoder.fpn_blocks.1.bottlenecks.0.conv2.norm.bias",
                 "encoder.pan_blocks.0.conv1.conv.weight", "encoder.downsample_convs.1.norm.weight",
                 "decoder.input_proj.0.conv.weight", "decoder.input_proj.2.norm.num_batches_tracked",
                 "decoder.decoder.layers.1.cross_attn.sampling_offsets.weight",
                 "decoder.decoder.layers.1.cross_attn.value_proj.bias", "decoder.decoder.layers.0.norm3.weight",
                 "decoder.denoising_class_embed.weight", "decoder.query_pos_head.layers.1.weight",
                 "decoder.enc_output.1.bias", "decoder.enc_score_head.weight",
                 "decoder.enc_bbox_head.layers.2.bias", "decoder.dec_score_head.1.weight",
                 "decoder.dec_bbox_head.1.layers.0.weight"):
        assert name in names, name
    # The anchors, the mask and the position embedding are rebuilt, not loaded.
    assert not any(n.endswith(("anchors", "valid_mask", "pos_embed2")) for n in names)


def test_published_widths_and_parameter_count():
    with torch.device("meta"):
        model = R.RTDETR()
    assert R.R50.feat_channels == (512, 1024, 2048)
    assert R.R50.spatial_shapes == [(80, 80), (40, 40), (20, 20)]
    assert sum(t.numel() for n, t in model.state_dict().items()
               if not n.endswith("num_batches_tracked")) == 43_019_372
    assert model.decoder.anchors.shape == (1, 8400, 4)


def test_valid_mask_of_the_640_grid():
    model = R.RTDETRTransformer(R.R50)
    valid = model.valid_mask[0, :, 0]
    # Only the 80 x 80 map's border lies within 0.01 of the edge.
    assert int((~valid).sum()) == 4 * 80 - 4
    assert bool(valid[6400:].all())
    assert torch.isinf(model.anchors[0, ~valid]).all()


# --- the deformable attention core ----------------------------------------

SHAPES = [(6, 7), (3, 4), (2, 2)]


def core_inputs(seed, b=1, lq=5, heads=2, c=3, points=4, spread=1.0):
    g = torch.Generator().manual_seed(seed)
    lv = sum(h * w for h, w in SHAPES)
    value = torch.randn(b, lv, heads, c, generator=g)
    boxes = torch.rand(b, lq, 4, generator=g)
    offsets = spread * torch.randn(b, lq, heads * len(SHAPES) * points * 2, generator=g)
    logits = torch.randn(b, lq, heads * len(SHAPES) * points, generator=g)
    return value, boxes, offsets, logits


def bilinear_sum(value, boxes, offsets, logits, points, align_corners=False):
    """A direct float64 evaluation: per query, head and sample, the four
    corners inside the map weighted bilinearly, times the softmax weight."""
    b, _, heads, c = value.shape
    lq, levels = boxes.shape[1], len(SHAPES)
    v, bx = value.double(), boxes.double()
    off = offsets.double().reshape(b, lq, heads, levels, points, 2)
    w = torch.softmax(logits.double().reshape(b, lq, heads, -1), -1).reshape(b, lq, heads,
                                                                          levels, points)
    out = torch.zeros(b, lq, heads, c, dtype=torch.float64)
    starts = np.cumsum([0] + [h * w_ for h, w_ in SHAPES])
    for bi in range(b):
        for q in range(lq):
            cx, cy, bw, bh = bx[bi, q].tolist()
            for h in range(heads):
                for lvl, (mh, mw) in enumerate(SHAPES):
                    for p in range(points):
                        lx = cx + off[bi, q, h, lvl, p, 0].item() / points * bw * 0.5
                        ly = cy + off[bi, q, h, lvl, p, 1].item() / points * bh * 0.5
                        if align_corners:
                            x, y = lx * (mw - 1), ly * (mh - 1)
                        else:
                            x, y = lx * mw - 0.5, ly * mh - 0.5
                        x0, y0 = int(np.floor(x)), int(np.floor(y))
                        for xi, yi in ((x0, y0), (x0 + 1, y0), (x0, y0 + 1), (x0 + 1, y0 + 1)):
                            if 0 <= xi < mw and 0 <= yi < mh:
                                k = (1 - abs(x - xi)) * (1 - abs(y - yi))
                                out[bi, q, h] += w[bi, q, h, lvl, p] * k * \
                                    v[bi, starts[lvl] + yi * mw + xi, h]
    return out.reshape(b, lq, heads * c)


@pytest.mark.parametrize("spread", [0.5, 8.0], ids=["inside", "outside"])
@pytest.mark.parametrize("align_corners", [False, True])
def test_plain_core_is_a_bilinear_sum(spread, align_corners):
    value, boxes, offsets, logits = core_inputs(3, spread=spread)
    got = msda.ms_deform_attn_plain(value, SHAPES, boxes, offsets, logits, 3, 4, align_corners)
    ref = bilinear_sum(value, boxes, offsets, logits, 4, align_corners)
    assert got.shape == (1, 5, 6)
    assert float((got.double() - ref).abs().max()) <= 1e-5


def test_plain_core_at_integer_positions_and_off_the_map():
    """Boxes of size 0 put every sample at the box centre: on a cell of
    level 0 (a single corner weighs 1), wholly outside every map (zero),
    and on the top-left corner of the maps."""
    value, _, _, logits = core_inputs(4, lq=3)
    # Level 0 is 7 wide and 6 high: x = loc * 7 - 0.5 is the integer 1 at
    # loc = 1.5 / 7, y = 2 at 2.5 / 6.
    boxes = torch.tensor([[[1.5 / 7, 2.5 / 6, 0.0, 0.0],
                           [-0.5, 1.8, 0.0, 0.0],
                           [0.0, 0.0, 0.0, 0.0]]])
    offsets = torch.randn(1, 3, 2 * len(SHAPES) * 4 * 2)
    got = msda.ms_deform_attn_plain(value, SHAPES, boxes, offsets, logits, 3, 4)
    ref = bilinear_sum(value, boxes, offsets, logits, 4)
    assert float((got.double() - ref).abs().max()) <= 1e-6
    assert torch.equal(got[0, 1], torch.zeros(6))
    # Level 0 alone: the query on cell (1, 2) reads that cell, weighted by
    # the sum of its head's four softmax weights (1).
    one = msda.ms_deform_attn_plain(
        value[:, :42], SHAPES[:1], boxes, offsets.reshape(1, 3, 2, 3, 8)[:, :, :, 0].flatten(2),
        logits.reshape(1, 3, 2, 3, 4)[:, :, :, 0].flatten(2), 1, 4)
    assert torch.allclose(one[0, 0], value[0, 2 * 7 + 1].flatten(), atol=1e-6)


def test_port_cross_attention_is_the_references():
    model, ref = tiny_pair()
    layer = model.decoder.decoder.layers[1].cross_attn
    g = torch.Generator().manual_seed(9)
    query = torch.randn(1, 30, 64, generator=g)
    boxes = torch.rand(1, 30, 4, generator=g)
    memory = torch.randn(1, 336, 64, generator=g)
    with torch.no_grad():
        got = layer(query, boxes, memory, TINY.spatial_shapes)
        want = ref.deformable_attention(query, boxes, memory, TINY.spatial_shapes,
                                        "decoder.decoder.layers.1.cross_attn")
    assert torch.equal(got, want)


# --- the K11 wrapper on the CPU --------------------------------------------


def test_wrapper_runs_the_plain_core_on_the_cpu_without_a_launch():
    value, boxes, offsets, logits = core_inputs(5)
    launches = ms_deform_attn.launches
    got = ms_deform_attn(value, SHAPES, boxes, offsets, logits, 3, 4)
    assert torch.equal(got, msda.ms_deform_attn_plain(value, SHAPES, boxes, offsets, logits, 3, 4))
    model, _ = tiny_pair()
    with torch.no_grad():
        model(torch.rand(1, 128, 128, 3))
    assert ms_deform_attn.launches == launches


@pytest.mark.parametrize("case,said", [
    ("float64", "value must be float32"),
    ("shapes", "the levels hold"),
    ("levels", "3 spatial shapes"),
    ("boxes", "boxes must be"),
    ("offsets", "offsets must be"),
    ("logits", "logits must be"),
    ("grad", "no backward"),
    ("value_dim", "value must be"),
])
def test_wrapper_refusals(case, said):
    value, boxes, offsets, logits = core_inputs(6)
    shapes, levels = SHAPES, 3
    if case == "float64":
        value = value.double()
    elif case == "shapes":
        shapes = [(6, 7), (3, 4), (2, 3)]
    elif case == "levels":
        levels = 2
    elif case == "boxes":
        boxes = boxes[..., :2]
    elif case == "offsets":
        offsets = offsets[..., :-2]
    elif case == "logits":
        logits = logits[:, :-1]
    elif case == "grad":
        value.requires_grad_(True)
    elif case == "value_dim":
        value = value.flatten(2)
    launches = ms_deform_attn.launches
    with pytest.raises(ValueError, match=said):
        ms_deform_attn(value, shapes, boxes, offsets, logits, levels, 4)
    assert ms_deform_attn.launches == launches


# --- post-processing and the detector ---------------------------------------


def test_postprocess_is_the_references():
    g = torch.Generator().manual_seed(11)
    logits = 3 * torch.randn(1, 30, 80, generator=g) - 4
    boxes = torch.rand(1, 30, 4, generator=g) * 0.5 + 0.1
    out = {"logits": logits, "boxes": boxes}
    ltwh, scores, classes, valid = R.postprocess(out, 80, 128, 0.25, 30)
    assert ltwh.shape == (1, 30, 4) and classes.dtype == torch.int32
    assert torch.equal(scores[0], torch.sort(torch.sigmoid(logits).flatten(), descending=True).values[:30])
    ref = P.postprocess(logits[0], boxes[0], (720, 1280), 80, 30, 0.25)
    assert int(valid.sum()) == len(ref) > 0
    sx, sy = 1280 / 128, 720 / 128
    for k, (c, s, x, y, w, h) in enumerate(ref):
        assert int(classes[0, k]) == c and abs(float(scores[0, k]) - s) == 0.0
        l, t, bw, bh = ltwh[0, k].tolist()
        assert max(abs(l * sx - x), abs(t * sy - y), abs(bw * sx - w), abs(bh * sy - h)) < 1e-3
    # Label = flat index mod classes, box of flat index // classes.
    flat = torch.sigmoid(logits[0]).flatten()
    top = int(torch.argmax(flat))
    cx, cy, bw, bh = boxes[0, top // 80].tolist()
    assert int(classes[0, 0]) == top % 80
    assert torch.allclose(ltwh[0, 0], torch.tensor([cx - bw / 2, cy - bh / 2, bw, bh]) * 128,
                          atol=1e-4)


def test_detector_boxes_in_frame_pixels():
    model, ref = tiny_pair()
    det = R.make_rtdetr_detector(cfg=TINY, device="cpu", score_threshold=0.0,
                                 state_dict=model.state_dict())
    rng = np.random.default_rng(2)
    y = rng.integers(0, 256, (96, 160), dtype=np.uint8)
    u = rng.integers(0, 256, (48, 80), dtype=np.uint8)
    v = rng.integers(0, 256, (48, 80), dtype=np.uint8)
    recs = det([(1.5, y, u, v)])
    assert len(recs) == 30 and all(r.timestamp == 1.5 for r in recs)
    x = P.to_input(*(torch.from_numpy(p) for p in (y, u, v)), 128)
    with torch.no_grad():
        want = ref.forward(x)
    dets = P.postprocess(want["logits"][0], want["boxes"][0], y.shape, 80, 30, 0.0)
    got = sorted((r.class_id, r.confidence, r.left, r.top, r.width, r.height) for r in recs)
    assert len(got) == len(dets)
    for a, b in zip(got, sorted(dets)):
        assert a[0] == b[0] and abs(a[1] - b[1]) < 1e-5
        assert max(abs(p - q) for p, q in zip(a[2:], b[2:])) < 1e-3


# --- the pipeline ----------------------------------------------------------


def test_pipeline_to_the_end_with_rtdetr_traced(tmp_path):
    from cova_tpu_torch.config import CompressedStageConfig, CovaConfig, ParallelConfig, SortConfig
    from cova_tpu_torch.models.blobnet import load_artifact
    from cova_tpu_torch.pipeline.cova import CovaPipeline

    model, _ = tiny_pair()
    det = R.make_rtdetr_detector(cfg=TINY, device="cpu", score_threshold=0.0,
                                 state_dict=model.state_dict())
    _, sd, meta = load_artifact(SYNTH, "cpu")
    cfg = CovaConfig(
        parallel=ParallelConfig(num_ranges=2), sort=SortConfig(min_hits=3, max_age=10),
        compressed=CompressedStageConfig(
            cc_threshold=2, mask_threshold=0.6,
            use_nnz_channel=bool(meta.get("use_nnz_channel", False)),
            signed_mv=bool(meta.get("signed_mv", False))),
        last="full")
    trace.disable()
    trace.take()
    trace.enable()
    try:
        res = CovaPipeline(str(SMALL), str(tmp_path / "out"), cfg, sd, detector=det,
                           device="cpu", log=lambda *_: None).run(max_frames=60)
    finally:
        trace.disable()
    rec = trace.take()
    names = [s["name"] for s in rec["spans"]]
    frames = names.count("cova.oracle")
    assert frames == res.pixel_frames > 0
    for name in ("rtdetr.backbone", "rtdetr.encoder", "rtdetr.select", "rtdetr.decoder"):
        assert names.count(name) == frames, name
    by_id = {s["id"]: s for s in rec["spans"]}
    for s in rec["spans"]:
        if s["name"].startswith("rtdetr."):
            parent = by_id[s["parent"]]["name"]
            assert parent in ("cova.oracle.net", "rtdetr.encoder") or \
                (s["name"] == "rtdetr.select" and parent == "cova.oracle.net"), (s["name"], parent)
    (counts,) = rec["counters"].values()
    assert counts["oracle.frames"] == frames
    # 30 boxes a frame at threshold 0; no K11 launch on the CPU.
    assert counts["oracle.detections"] == 30 * frames
    assert "msda.launches" not in counts
    dnn = (tmp_path / "out" / "dnn.csv").read_text().splitlines()
    assert len(dnn) - 1 == 30 * frames


def test_plain_calibration_takes_each_norms_input_statistics():
    sd = seeded_state(TINY, 0)
    size = TINY.input_size
    x = torch.rand(1, 3, size, size, generator=torch.Generator().manual_seed(5))
    cal = P.calibrated(sd, plain_conf(TINY), x)
    assert list(cal) == list(sd)
    # The stem's first norm holds its convolution's statistics on x.
    conv = torch.nn.functional.conv2d(x, sd["backbone.conv1.conv1_1.conv.weight"], stride=2,
                                      padding=1)
    key = "backbone.conv1.conv1_1.norm"
    assert torch.allclose(cal[f"{key}.running_mean"], conv.mean((0, 2, 3)), rtol=1e-5, atol=1e-6)
    assert torch.allclose(cal[f"{key}.running_var"], conv.var((0, 2, 3), unbiased=False),
                          rtol=1e-5, atol=1e-6)
    # Every BatchNorm's statistics are new and nothing else changed; the
    # state dict given is left as it was.
    stats = {k for k in sd if k.endswith((".running_mean", ".running_var"))}
    assert stats and {k for k in sd if not torch.equal(sd[k], cal[k])} == stats
    # The decoder's last input projection now normalises its input on x.
    ref = P.RTDETR(cal, plain_conf(TINY))
    maps = ref.encoder(ref.backbone(x))
    key = f"decoder.input_proj.{len(maps) - 1}"
    pre = torch.nn.functional.conv2d(maps[-1], cal[f"{key}.conv.weight"])
    normed = (pre - cal[f"{key}.norm.running_mean"].reshape(1, -1, 1, 1)) * (
        cal[f"{key}.norm.running_var"].reshape(1, -1, 1, 1) + P.BN_EPS).rsqrt()
    assert float(normed.mean((0, 2, 3)).abs().max()) < 1e-4
    assert float((normed.var((0, 2, 3), unbiased=False) - 1).abs().max()) < 1e-2


def test_reference_copies_are_the_same_file():
    assert (REPO / "bench_port" / "ref" / "rtdetr_ref.py").read_bytes() == \
        (REPO / "tests" / "rtdetr_plain.py").read_bytes()


# --- on the card -----------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: K11 has no CPU build")
    from cova_tpu_torch.pipeline.compressed import exact_float32

    exact_float32("cuda")
    return torch.device("cuda")


def published_inputs(seed, device, spread):
    """K11's inputs at RT-DETR-R50's shapes: value (1, 8400, 8, 32), 300
    boxes, offsets and logits for 8 heads, 3 levels, 4 points."""
    g = torch.Generator(device=device).manual_seed(seed)
    value = torch.randn(1, 8400, 8, 32, device=device, generator=g)
    boxes = torch.rand(1, 300, 4, device=device, generator=g)
    boxes[..., 2:] *= 0.5
    offsets = spread * torch.randn(1, 300, 192, device=device, generator=g)
    logits = torch.randn(1, 300, 96, device=device, generator=g)
    return value, boxes, offsets, logits


@pytest.mark.cuda
@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("spread", [1.0, 4.0, 16.0], ids=["near", "box", "outside"])
def test_cuda_kernel_matches_plain_at_the_published_shapes(cuda_device, spread, align_corners):
    args = published_inputs(int(spread) + align_corners, cuda_device, spread)
    shapes = R.R50.spatial_shapes
    launches = ms_deform_attn.launches
    with torch.no_grad():
        ref = msda.ms_deform_attn_plain(*args[:1], shapes, *args[1:], 3, 4, align_corners)
        for _ in range(3):
            got = ms_deform_attn(args[0], shapes, *args[1:], 3, 4, align_corners)
            torch.cuda.synchronize()
            assert got.shape == (1, 300, 256) and got.is_contiguous()
            err = float((got - ref).abs().max())
            assert err <= KERNEL_REL_TOL * float(ref.abs().max()), err
    assert ms_deform_attn.launches == launches + 3


@pytest.mark.cuda
def test_cuda_kernel_on_integer_positions(cuda_device):
    """Every sample on a cell of its level: one corner weighs 1."""
    value, boxes, offsets, logits = published_inputs(7, cuda_device, 0.0)
    shapes = R.R50.spatial_shapes
    cells = torch.randint(0, 20, (1, 300, 2), device=cuda_device,
                          generator=torch.Generator(device=cuda_device).manual_seed(1))
    boxes = torch.cat([(cells + 0.5) / 20, torch.zeros_like(cells, dtype=torch.float32)], -1)
    with torch.no_grad():
        ref = msda.ms_deform_attn_plain(value, shapes, boxes, offsets, logits, 3, 4)
        got = ms_deform_attn(value, shapes, boxes, offsets, logits, 3, 4)
    torch.cuda.synchronize()
    assert float((got - ref).abs().max()) <= KERNEL_REL_TOL * float(ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("case,said", [("channels", "32 channels"), ("levels", "at most 4 levels"),
                                       ("contiguous", "contiguous"), ("device", "is on")])
def test_cuda_refusals(cuda_device, case, said):
    value, boxes, offsets, logits = published_inputs(8, cuda_device, 1.0)
    shapes, levels, points = R.R50.spatial_shapes, 3, 4
    if case == "channels":
        value = value.reshape(1, 8400, 16, 16)
        offsets = torch.zeros(1, 300, 16 * 24, device=cuda_device)
        logits = torch.zeros(1, 300, 16 * 12, device=cuda_device)
    elif case == "levels":
        points = 11
        offsets = torch.zeros(1, 300, 8 * 33 * 2, device=cuda_device)
        logits = torch.zeros(1, 300, 8 * 33, device=cuda_device)
    elif case == "contiguous":
        offsets = torch.zeros(1, 192, 300, device=cuda_device).transpose(1, 2)
    elif case == "device":
        boxes = boxes.cpu()
    launches = ms_deform_attn.launches
    with pytest.raises(ValueError, match=said):
        ms_deform_attn(value, shapes, boxes, offsets, logits, levels, points)
    assert ms_deform_attn.launches == launches


@pytest.mark.cuda
def test_cuda_published_model_matches_plain_reference(cuda_device):
    """RT-DETR-R50 at 640 on the card (K11 in its six layers) against the
    plain reference on the same state dict and picture."""
    sd = {k: v.to(cuda_device) for k, v in seeded_state(R.R50, 3).items()}
    det = R.make_rtdetr_detector(device=cuda_device, state_dict=sd)
    ref = P.RTDETR(sd, plain_conf(R.R50))
    rng = np.random.default_rng(4)
    y = rng.integers(0, 256, (720, 1280), dtype=np.uint8)
    u = rng.integers(0, 256, (360, 640), dtype=np.uint8)
    v = rng.integers(0, 256, (360, 640), dtype=np.uint8)
    launches = ms_deform_attn.launches
    with torch.no_grad():
        got = det.network(det.preprocess(*det.planes(y, u, v)))
        x = P.to_input(*(torch.from_numpy(p).to(cuda_device) for p in (y, u, v)), 640)
        memory, shapes = ref.memory(ref.encoder(ref.backbone(x)))
        sel = ref.select(memory, shapes)
        logits, boxes = ref.decode(memory, shapes, sel, got["indices"])
    assert ms_deform_attn.launches == launches + 6
    assert gap(got["memory"], memory) <= 5e-5
    assert gap(got["logits"], logits) <= 1e-4 and gap(got["boxes"], boxes) <= 1e-4


def test_run_cova_takes_the_rtdetr_oracle(tmp_path, monkeypatch, capsys):
    """$COVA_RTDETR_WEIGHTS names a state dict in upstream's names; the
    run goes to the end with RT-DETR as its oracle (the small preset here,
    in place of R50), and --trace shows the model's spans."""
    import json

    from cova_tpu_torch import run_cova

    model, _ = tiny_pair()
    weights = tmp_path / "rtdetr.pth"
    torch.save(model.state_dict(), weights)
    monkeypatch.setattr(R, "make_rtdetr_detector",
                        functools.partial(R.make_rtdetr_detector, cfg=TINY))
    monkeypatch.setenv("COVA_RTDETR_WEIGHTS", str(weights))
    monkeypatch.delenv("COVA_YOLO_WEIGHTS", raising=False)
    out = tmp_path / "trace.json"
    run_cova.main([str(SMALL), str(tmp_path / "out"), "--device", "cpu", "--trace", str(out)])
    assert "using RT-DETR-R50 oracle from" in capsys.readouterr().out
    events = [e for e in json.loads(out.read_text())["traceEvents"] if e.get("cat") == "cova"]
    names = [e["name"] for e in events]
    frames = names.count("cova.oracle")
    assert frames > 0
    for name in ("rtdetr.backbone", "rtdetr.encoder", "rtdetr.select", "rtdetr.decoder"):
        assert names.count(name) == frames, name
    (run,) = [e for e in events if e["name"] == "cova.run"]
    assert run["args"]["counters"]["oracle.frames"] == frames
    assert "oracle.detections" in run["args"]["counters"]
    monkeypatch.setenv("COVA_YOLO_WEIGHTS", str(weights))
    with pytest.raises(SystemExit, match="set one oracle"):
        run_cova.main([str(SMALL), str(tmp_path / "out2"), "--device", "cpu"])

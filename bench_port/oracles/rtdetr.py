"""The oracle RT-DETR-R50 at 640 x 640 (arXiv:2304.08069; lyuwenyu/RT-DETR,
rtdetr_pytorch/configs/rtdetr/rtdetr_r50vd_6x_coco.yml).

The program is the port's detector (`cova_tpu_torch.models.rtdetr`:
RTDETR with K11 in its six decoder layers, `make_rtdetr_detector`, which
wraps it in the shared `YoloDetector`) on weights that `seeded_state`
makes on the card from the seed. The reference is the plain RT-DETR
(ref/rtdetr_ref.py) on the same state dict. A frame is compared given
what each layer received:

  memory_gap      the encoder memory (the decoder's projected tokens)
                  against the reference's on the same picture: the widest
                  gap over the largest magnitude
  queries_off     the selected tokens whose reference score lies below
                  the reference's num_queries-th score by more than
                  QUERY_TOL: a near-tie at the last place may go either
                  way, a token that does not belong may not
  output_gap      the final logits and boxes against the reference
                  decoder run on the reference memory at the program's
                  own selected tokens: the wider of the two gaps
  detections_off  the boxes against the plain post-processing of the
                  program's own logits and boxes

`Program.take()` also keeps each K11 launch's boxes and offsets, from
which metrics/msda_roofline_pct.py counts its operations and bytes off the
card (`msda_work`, beside K11's wrapper in the port), and the host windows
of the call and its parts, from which bench_port/windows.py reads their
device time.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import operator
import threading
import time

import torch
from torch.profiler import record_function

from bench_port import check
from bench_port.ref import rtdetr_ref
from cova_tpu_torch.models import rtdetr
from cova_tpu_torch.ops.cuda.msda_kernel import msda_ops, msda_work  # noqa: F401

# Limits, each between the readings of sound runs and of the control
# (PERF.md gives the readings).
LIMITS = {
    # float32 with TF32 off on both sides; the program's backbone, encoder
    # and selection are the reference's operations on the same input, so
    # sound runs read 0 or a few ulps (sums in other orders); the
    # reference in TF32 reads ~1e-3.
    "memory_gap": 5e-5,
    # Tokens selected that the reference ranks below its last selected
    # token by more than QUERY_TOL: none.
    "queries_off": 0,
    # K11 rounds its softmax and its sum over the samples in other orders
    # than the plain composition, and six layers carry that on: sound runs
    # read ~1e-6; the reference in TF32 reads ~1e-3.
    "output_gap": 1e-4,
    # Boxes without a counterpart in the plain post-processing of the
    # program's own logits and boxes: the same outputs give the same boxes.
    "detections_off": 0,
}
FOLD = {"memory_gap": max, "queries_off": operator.add, "output_gap": max,
        "detections_off": operator.add}
# A selected token may score this far (logit units) below the reference's
# last selected one: float32 sums in other orders move a score by a few
# ulps of its size (order 1-10), far less than this; a token out of place
# by a real fault sits far further down.
QUERY_TOL = 1e-4


def config(conf: dict) -> rtdetr.RTDETRConfig:
    """The port's config from the configuration's oracle entry."""
    fields = {f for f in rtdetr.RTDETRConfig.__dataclass_fields__}
    return rtdetr.RTDETRConfig(**{k: tuple(v) if isinstance(v, list) else v
                                  for k, v in conf.items() if k in fields})


@torch.no_grad()
def seeded_state(seed: int, device, cfg: rtdetr.RTDETRConfig, score_bias: float) -> dict:
    """The state dict the program and the reference load, drawn on
    `device` from a torch.Generator seeded with `seed`, tensor by tensor
    in the model's order: BN and LayerNorm scale U(0.9, 1.1), bias
    N(0, 0.1), BN's running statistics calibrated (`_calibrated`); convolutions
    N(0, sqrt(2 / fan_in)), a bottleneck's last one (branch2c) at a fifth
    of that, so that 16 residual blocks keep the scale of their input;
    Linear and attention in-projection weights N(0, sqrt(1 / fan_in)),
    biases N(0, 0.02); the box heads' last layer at a tenth, so that six
    refinements move the boxes and do not saturate them; `enc_output`'s
    Linear bias 0, so that a token the valid mask zeroes leaves it as
    LayerNorm's bias, a small vector, and scores near the class bias, below
    the selected tokens (a trained model ranks them low); the sampling
    offsets' bias upstream's initial directions (head h toward angle 2 pi
    h / 8, point p at p times the unit, `_reset_parameters`); the class
    heads' bias `score_bias`; the denoising embedding N(0, 1)."""
    with torch.device("meta"):
        model = rtdetr.RTDETR(cfg)
    norms = {name for name, m in model.named_modules()
             if isinstance(m, (torch.nn.BatchNorm2d, torch.nn.LayerNorm, rtdetr.FrozenBatchNorm2d))}
    g = torch.Generator(device=device)
    g.manual_seed(seed)

    def normal(shape, std, mean=0.0):
        return mean + std * torch.randn(shape, generator=g, device=device)

    def uniform(shape, a, b):
        return a + (b - a) * torch.rand(shape, generator=g, device=device)

    out = {}
    for name, t in model.state_dict().items():
        owner, leaf = name.rsplit(".", 1)
        shape = t.shape
        if t.dtype == torch.long:  # num_batches_tracked
            out[name] = torch.zeros(shape, dtype=torch.long, device=device)
        elif leaf == "running_var":
            out[name] = uniform(shape, 0.8, 1.2)
        elif leaf == "running_mean":
            out[name] = normal(shape, 0.1)
        elif t.dim() == 4:
            gain = 0.2 if ".branch2c." in name else 1.0
            out[name] = normal(shape, gain * math.sqrt(2.0 / t[0].numel()))
        elif owner in norms:
            out[name] = uniform(shape, 0.9, 1.1) if leaf == "weight" else normal(shape, 0.1)
        elif "denoising_class_embed" in name:
            out[name] = normal(shape, 1.0)
        elif name.endswith("sampling_offsets.bias"):
            out[name] = _offset_directions(cfg).to(device)
        elif name == "decoder.enc_output.0.bias":
            out[name] = torch.zeros(shape, device=device)
        elif "score_head" in name and leaf == "bias":
            out[name] = torch.full(shape, float(score_bias), device=device)
        elif t.dim() == 2:
            last_box = "bbox_head" in name and name.endswith("layers.2.weight")
            out[name] = normal(shape, (0.1 if last_box else 1.0) / math.sqrt(shape[1]))
        else:
            out[name] = normal(shape, 0.02)
    return _calibrated(out, cfg, normal((1, 3, 20, 20), 0.25, 0.5), uniform(
        (1, 3, cfg.input_size, cfg.input_size), -0.1, 0.1))


def _calibrated(state: dict, cfg: rtdetr.RTDETRConfig, coarse, fine) -> dict:
    """`state` with each BatchNorm's running statistics taken by the plain
    reference (rtdetr_ref.calibrated) on one seeded picture: a 20 x 20
    grid of N(0.5, 0.25) upsampled to the input size plus U(-0.1, 0.1)
    noise, clipped to [0, 1]. Without them random per-channel offsets, not
    the picture, decide the scores."""
    size = (cfg.input_size, cfg.input_size)
    x = (torch.nn.functional.interpolate(coarse, size=size, mode="bilinear") + fine).clamp(0, 1)
    conf = dataclasses.asdict(cfg)
    conf["strides"] = list(cfg.strides)
    return rtdetr_ref.calibrated(state, conf, x)


def _offset_directions(cfg: rtdetr.RTDETRConfig) -> torch.Tensor:
    """MSDeformableAttention._reset_parameters' sampling_offsets bias."""
    heads, levels, points = cfg.nhead, len(cfg.strides), cfg.dec_points
    thetas = torch.arange(heads, dtype=torch.float32) * (2.0 * math.pi / heads)
    grid = torch.stack([thetas.cos(), thetas.sin()], -1)
    grid = grid / grid.abs().max(-1, keepdim=True).values
    grid = grid.reshape(heads, 1, 1, 2).tile([1, levels, points, 1])
    grid *= torch.arange(1, points + 1, dtype=torch.float32).reshape(1, 1, -1, 1)
    return grid.flatten()


def flops() -> int:
    """One frame at the published widths, 2 a multiply-add: the
    convolutions, Linear layers and attention products as
    torch.utils.flop_counter counts them, and K11's operations
    (`msda_ops`) in each decoder layer."""
    c = rtdetr.R50
    f = 0

    def conv(cin, cout, k, h):
        return 2 * cin * cout * k * k * h * h

    def linear(tokens, i, o):
        return 2 * tokens * i * o

    def attention(tokens, dim):
        return 4 * linear(tokens, dim, dim) + 2 * 2 * tokens * tokens * dim

    h = c.input_size // 2
    f += conv(3, c.stem // 2, 3, h) + conv(c.stem // 2, c.stem // 2, 3, h) \
        + conv(c.stem // 2, c.stem, 3, h)
    h //= 2
    ch = c.stem
    for i, (n, w) in enumerate(zip(c.blocks, c.widths)):
        s = 1 if i == 0 else 2
        ho = h // s
        f += conv(ch, w, 1, h) + conv(w, w, 3, ho) + conv(w, 4 * w, 1, ho) + conv(ch, 4 * w, 1, ho)
        f += (n - 1) * (conv(4 * w, w, 1, ho) + conv(w, w, 3, ho) + conv(w, 4 * w, 1, ho))
        h, ch = ho, 4 * w
    hd = c.hidden_dim
    sizes = [c.input_size // s for s in c.strides]
    f += sum(conv(ci, hd, 1, s) for ci, s in zip(c.feat_channels, sizes))
    top = sizes[-1] ** 2
    f += attention(top, hd) + 2 * linear(top, hd, c.enc_ffn)

    def csp(s):
        return 2 * conv(2 * hd, hd, 1, s) + c.csp_blocks * (conv(hd, hd, 3, s) + conv(hd, hd, 1, s))

    for s in sizes[1:]:
        f += conv(hd, hd, 1, s)  # lateral, on the map above
    for s in sizes[:-1]:
        f += csp(s)  # top-down
    for s in sizes[1:]:
        f += conv(hd, hd, 3, s) + csp(s)  # bottom-up: downsample to s, then fuse
    tokens = sum(s * s for s in sizes)
    q = c.num_queries

    def box_mlp(n):
        return linear(n, hd, hd) * 2 + linear(n, hd, 4)

    f += sum(conv(hd, hd, 1, s) for s in sizes)
    f += linear(tokens, hd, hd) + linear(tokens, hd, c.num_classes) + box_mlp(tokens)
    samples = c.nhead * len(sizes) * c.dec_points
    per_layer = (linear(q, 4, 2 * hd) + linear(q, 2 * hd, hd) + attention(q, hd)
                 + linear(tokens, hd, hd) + linear(q, hd, 2 * samples) + linear(q, hd, samples)
                 + linear(q, hd, hd) + 2 * linear(q, hd, c.dec_ffn) + box_mlp(q)
                 + msda_ops(q, samples, hd // c.nhead))
    f += c.dec_layers * per_layer + linear(q, hd, c.num_classes)
    return f


class Program:
    """The port's detector, frames -> BoxRecs, on the seeded weights. It
    marks the backbone, the encoder through query selection and the
    decoder with the ranges bench.rtdetr.backbone / .encoder / .decoder,
    and keeps, until `take()`, the outputs of the frame it last ran, its
    K11 launches' inputs, and the window of host time of the call and of
    each of those parts with the calling thread's ids (the profiler
    records ranges only on the thread that started it, and the pipeline
    calls the oracle from its pixel stage's threads; bench_port/windows.py
    reads the device time launched inside a window)."""

    def __init__(self, conf: dict, seed: int, device):
        cfg = config(conf)
        self.weights = seeded_state(seed, device, cfg, conf["score_bias"])
        self.detector = rtdetr.make_rtdetr_detector(cfg=cfg, device=device,
                                                    score_threshold=conf["score_threshold"],
                                                    state_dict=self.weights)
        self.model = self.detector.model
        self._out, self._launches, self._windows = None, [], []
        network = self.detector.network

        def capture_network(x):
            self._out = network(x)
            return self._out

        self.detector.network = capture_network
        for obj, attr, name in ((self.model.backbone, "forward", "bench.rtdetr.backbone"),
                                (self.model, "encode", "bench.rtdetr.encoder"),
                                (self.model, "decode", "bench.rtdetr.decoder")):
            setattr(obj, attr, functools.partial(self._ranged, getattr(obj, attr), name))
        for layer in self.model.decoder.decoder.layers:
            layer.cross_attn.ms_deformable_attn_core = functools.partial(
                self._counted, layer.cross_attn.ms_deformable_attn_core)

    def _counted(self, core, value, shapes, boxes, offsets, logits, levels, points, **kw):
        self._launches.append((tuple(value.shape), list(shapes), boxes, offsets, levels, points))
        return core(value, shapes, boxes, offsets, logits, levels, points, **kw)

    def _ranged(self, fn, name, *a, **kw):
        t0 = time.time_ns()
        with record_function(name):
            out = fn(*a, **kw)
        self._windows.append((name, *_thread_ids(), t0, time.time_ns()))
        return out

    def __call__(self, frames):
        t0 = time.time_ns()
        recs = self.detector(frames)
        self._windows.append(("oracle", *_thread_ids(), t0, time.time_ns()))
        return recs

    def take(self) -> dict:
        """The last frame's outputs on the host (memory, scores, indices,
        logits, boxes, batch dimension dropped), `msda`, each K11 launch's
        inputs that `msda_work` counts from (its boxes and offsets on the
        host), and `windows`, the (part, native thread id, pthread id's
        low 32 bits, start, end in Unix ns) of the call ("oracle") and of
        its marked parts; dropped here, so that the device's peak is the
        program's. The copies go to page-locked memory, so that the card's
        time for them is short and does not wait on the host's CPU; the
        counting waits for the reader, off the card."""
        out, self._out = self._out, None
        launches, self._launches = self._launches, []
        taken = {k: _to_host(out[k][0]) for k in ("memory", "scores", "indices", "logits",
                                                  "boxes")}
        taken["msda"] = [(shape, shapes, _to_host(boxes), _to_host(offsets), levels, points)
                         for shape, shapes, boxes, offsets, levels, points in launches]
        taken["windows"], self._windows = self._windows, []
        return taken


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """A copy of `t` in host memory, page-locked where `t` is on the card."""
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=t.is_cuda)
    out.copy_(t)
    return out


def _thread_ids() -> tuple:
    """The calling thread's ids as a torch.profiler trace may write them:
    its native id, and the low 32 bits of its pthread id."""
    return threading.get_native_id(), threading.get_ident() & 0xFFFFFFFF


def _gap(got, ref) -> float:
    return float((got.float() - ref.float()).abs().max() / ref.abs().max().clamp_min(1e-30))


class Reference:
    """The plain RT-DETR on the program's state dict."""

    def __init__(self, conf: dict, weights: dict, device):
        self.conf, self.device = conf, device
        self.net = rtdetr_ref.RTDETR(weights, conf)

    def outputs(self, y, u, v) -> dict:
        """One picture (numpy I420 planes) through the backbone, the
        encoder and query selection: memory, shapes, selection."""
        planes = [torch.from_numpy(p).to(self.device) for p in (y, u, v)]
        x = rtdetr_ref.to_input(*planes, self.conf["input_size"])
        memory, shapes = self.net.memory(self.net.encoder(self.net.backbone(x)))
        return {"memory": memory, "shapes": shapes, "sel": self.net.select(memory, shapes)}

    def numbers(self, ref: dict, outs: dict, recs, frame_hw) -> dict:
        """One frame's numbers: the program's outputs `outs` (take()'s)
        against the reference's `ref` on its picture."""
        c, dev = self.conf, self.device
        scores = ref["sel"]["scores"][0]
        last = torch.topk(scores, c["num_queries"]).values[-1]
        idx = outs["indices"].to(dev)
        logits, boxes = self.net.decode(ref["memory"], ref["shapes"], ref["sel"], idx[None])
        got_logits, got_boxes = outs["logits"].to(dev), outs["boxes"].to(dev)
        dets = rtdetr_ref.postprocess(got_logits, got_boxes, frame_hw, c["num_classes"],
                                      c["num_top"], c["score_threshold"])
        return {"memory_gap": _gap(outs["memory"].to(dev), ref["memory"][0]),
                "queries_off": int((scores[idx] < last - QUERY_TOL).sum()),
                "output_gap": max(_gap(got_logits, logits[0]), _gap(got_boxes, boxes[0])),
                "detections_off": check.detections_off(recs, dets)}

    def control(self, y, u, v) -> dict:
        """One frame's numbers with this reference in TF32 in the
        program's place, held to itself in float32."""
        ref = self.outputs(y, u, v)
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            low = self.outputs(y, u, v)
            idx = low["sel"]["indices"]
            logits, boxes = self.net.decode(low["memory"], low["shapes"], low["sel"], idx)
        finally:
            rtdetr_ref.exact()
        outs = {"memory": low["memory"][0], "indices": idx[0], "logits": logits[0],
                "boxes": boxes[0]}
        c = self.conf
        recs = [check.Box(*d) for d in rtdetr_ref.postprocess(
            logits[0], boxes[0], y.shape, c["num_classes"], c["num_top"], c["score_threshold"])]
        return self.numbers(ref, outs, recs, y.shape)

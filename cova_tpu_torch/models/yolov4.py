"""YOLOv4 detector in PyTorch: the pixel-domain oracle (port of
cova_tpu/models/yolov4.py, eval mode only).

Replaces the reference's TensorRT YOLOv4-608 engine (reference:
config/dnn/yolov4_b2.txt, weights/cfg from third_parties/tensorrt_demos):
CSPDarknet53 backbone, SPP neck, PANet feature aggregation and three YOLO
heads, the standard yolov4.cfg topology, so released darknet weights load
directly (`load_darknet_weights`).

Public layout is the JAX package's: the network takes (B, S, S, 3) RGB in
[0, 1] and returns three (B, S/s, S/s, 3*(5+C)) raw heads for s = 8, 16,
32. Inside, tensors are NCHW. Convolutions are cuDNN's; decode runs in
plain torch and the class-aware NMS on the card is the hand-written CUDA
kernel (ops/cuda/nms_kernel.py).

Every ConvBN is registered in yolov4.cfg order, including the
head/PAN-bottom-up interleave, so walking the module tree in order walks
the darknet `.weights` stream.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cova_tpu_torch import trace
from cova_tpu_torch.ops.cuda.nms_kernel import nms

# Standard yolov4.cfg anchors/strides (reference: tensorrt_demos yolo cfg).
ANCHORS = (
    ((12, 16), (19, 36), (40, 28)),      # stride 8
    ((36, 75), (76, 55), (72, 146)),     # stride 16
    ((142, 110), (192, 243), (459, 401)),  # stride 32
)
STRIDES = (8, 16, 32)
SCALE_XY = (1.2, 1.1, 1.05)
BN_EPS = 1e-5  # Flax BatchNorm default, same as torch's


def mish(x: torch.Tensor) -> torch.Tensor:
    """x * tanh(softplus(x))."""
    return F.mish(x)


class ConvBN(nn.Module):
    """One darknet [convolutional] layer: a convolution, then BatchNorm
    (bias-free conv) or a conv bias, then the activation. Padding is
    Flax's: "SAME" at stride 1, k // 2 on both sides otherwise."""

    def __init__(self, cin: int, filters: int, kernel: int = 3, stride: int = 1,
                 act: str = "mish", bn: bool | None = None):
        super().__init__()
        if act not in ("mish", "leaky", "linear", "logistic"):
            raise ValueError(f"unsupported activation {act!r}")
        bn = act != "linear" if bn is None else bn
        pad = "same" if stride == 1 else kernel // 2
        self.conv = nn.Conv2d(cin, filters, kernel, stride, padding=pad, bias=not bn)
        self.bn = nn.BatchNorm2d(filters, eps=BN_EPS) if bn else None
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        if self.act == "mish":
            return mish(x)
        if self.act == "leaky":
            return F.leaky_relu(x, 0.1)
        if self.act == "logistic":
            return torch.sigmoid(x)
        return x


class CSPBlock(nn.Module):
    """One CSP stage of CSPDarknet53. `convs` in cfg order: downsample,
    route (split A), main, (1x1, 3x3) per residual block, post,
    transition."""

    def __init__(self, cin: int, filters: int, blocks: int, first: bool = False):
        super().__init__()
        f = filters
        inner = f if first else f // 2
        layers = [ConvBN(cin, f, 3, 2), ConvBN(f, inner, 1), ConvBN(f, inner, 1)]
        for _ in range(blocks):
            layers += [ConvBN(inner, f // 2, 1), ConvBN(f // 2, inner, 3)]
        layers += [ConvBN(inner, inner, 1), ConvBN(2 * inner, f, 1)]
        self.blocks = blocks
        self.convs = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.convs
        x = c[0](x)
        route = c[1](x)
        x = c[2](x)
        for b in range(self.blocks):
            x = x + c[4 + 2 * b](c[3 + 2 * b](x))
        x = c[-2](x)
        return c[-1](torch.cat([x, route], dim=1))


class CSPDarknet53(nn.Module):
    def __init__(self):
        super().__init__()
        self.stem = ConvBN(3, 32, 3)
        self.stages = nn.ModuleList([
            CSPBlock(32, 64, 1, first=True),
            CSPBlock(64, 128, 2),
            CSPBlock(128, 256, 8),
            CSPBlock(256, 512, 8),
            CSPBlock(512, 1024, 4),
        ])

    def forward(self, x: torch.Tensor):
        x = self.stem(x)
        feats = []
        for stage in self.stages:
            x = stage(x)
            feats.append(x)
        return feats[2], feats[3], feats[4]  # strides 8, 16, 32


def max_pool_same(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """Max pool with Flax/XLA "SAME" padding: -inf padding, the odd one
    after, so a stride above 1 or an even size pads as the TPU did."""
    h, w = x.shape[-2:]
    ph = max((-(-h // stride) - 1) * stride + k - h, 0)
    pw = max((-(-w // stride) - 1) * stride + k - w, 0)
    x = F.pad(x, (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2), value=float("-inf"))
    return F.max_pool2d(x, k, stride)


class SPP(nn.Module):
    def __init__(self):
        super().__init__()
        self.convs = nn.ModuleList([
            ConvBN(1024, 512, 1, act="leaky"),
            ConvBN(512, 1024, 3, act="leaky"),
            ConvBN(1024, 512, 1, act="leaky"),
            ConvBN(2048, 512, 1, act="leaky"),
            ConvBN(512, 1024, 3, act="leaky"),
            ConvBN(1024, 512, 1, act="leaky"),
        ])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.convs
        x = c[2](c[1](c[0](x)))
        pools = [x] + [max_pool_same(x, k, 1) for k in (5, 9, 13)]
        x = torch.cat(pools[::-1], dim=1)
        return c[5](c[4](c[3](x)))


def _upsample2(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2, mode="nearest")


class YOLOv4(nn.Module):
    """The yolov4.cfg topology. `convs` holds the neck and heads in cfg
    order (the Flax module's top-level ConvBN_0..31):
      0 u5, 1 c4p, 2-6 conv5 -> p4, 7 u4, 8 c3p, 9-13 conv5 -> p3,
      14 h3, 15 head o3, 16 d3, 17-21 conv5 -> p4', 22 h4, 23 head o4,
      24 d4, 25-29 conv5 -> p5', 30 h5, 31 head o5."""

    def __init__(self, num_classes: int = 80):
        super().__init__()
        self.num_classes = num_classes
        out_ch = 3 * (5 + num_classes)
        self.backbone = CSPDarknet53()
        self.spp = SPP()

        def leaky(cin, f, k, s=1):
            return ConvBN(cin, f, k, s, act="leaky")

        def conv5(cin, f):
            return [leaky(cin, f, 1), leaky(f, 2 * f, 3), leaky(2 * f, f, 1),
                    leaky(f, 2 * f, 3), leaky(2 * f, f, 1)]

        layers = [leaky(512, 256, 1), leaky(512, 256, 1), *conv5(512, 256)]
        layers += [leaky(256, 128, 1), leaky(256, 128, 1), *conv5(256, 128)]
        layers += [leaky(128, 256, 3), ConvBN(256, out_ch, 1, act="linear")]
        layers += [leaky(128, 256, 3, 2), *conv5(512, 256)]
        layers += [leaky(256, 512, 3), ConvBN(512, out_ch, 1, act="linear")]
        layers += [leaky(256, 512, 3, 2), *conv5(1024, 512)]
        layers += [leaky(512, 1024, 3), ConvBN(1024, out_ch, 1, act="linear")]
        self.convs = nn.ModuleList(layers)
        self.eval()

    def forward(self, x: torch.Tensor):
        """x: (B, S, S, 3) float -> three (B, S/s, S/s, 3*(5+C)) raw heads."""
        c = self.convs

        def conv5(x, i):
            for j in range(i, i + 5):
                x = c[j](x)
            return x

        x = x.to(torch.float32).permute(0, 3, 1, 2)
        c3, c4, c5 = self.backbone(x)
        p5 = self.spp(c5)
        # PAN top-down
        u5 = _upsample2(c[0](p5))
        p4 = conv5(torch.cat([c[1](c4), u5], dim=1), 2)
        u4 = _upsample2(c[7](p4))
        p3 = conv5(torch.cat([c[8](c3), u4], dim=1), 9)
        # Heads + PAN bottom-up
        o3 = c[15](c[14](p3))
        p4 = conv5(torch.cat([c[16](p3), p4], dim=1), 17)
        o4 = c[23](c[22](p4))
        p5 = conv5(torch.cat([c[24](p4), p5], dim=1), 25)
        o5 = c[31](c[30](p5))
        return tuple(o.permute(0, 2, 3, 1).contiguous() for o in (o3, o4, o5))


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Random weights drawn from `generator`: conv weights normal with std
    1/sqrt(fan_in), biases zero, BatchNorm identity (the numbers differ
    from the JAX package's PRNGKey init)."""
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            w = m.weight
            w.copy_(torch.randn(w.shape, generator=generator) / w[0].numel() ** 0.5)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()


def create_yolov4(num_classes: int = 80, generator: torch.Generator | None = None,
                  device="cuda") -> YOLOv4:
    """YOLOv4 in eval mode on `device`, weights drawn from `generator`
    (seeded with 0 when None)."""
    model = YOLOv4(num_classes)
    init_weights(model, generator or torch.Generator().manual_seed(0))
    return model.to(device).eval()


def decode_head(raw, anchors, stride, scale_xy, num_classes, input_size):
    """Raw head output (B, H, W, 3*(5+C)) -> (B, H*W*3, 4) ltwh boxes and
    (B, H*W*3, C) scores, in input pixels."""
    b, h, w, _ = raw.shape
    raw = raw.reshape(b, h, w, 3, 5 + num_classes).to(torch.float32)
    gy, gx = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=raw.device),
        torch.arange(w, dtype=torch.float32, device=raw.device),
        indexing="ij",
    )
    grid = torch.stack([gx, gy], dim=-1)[None, :, :, None, :]

    xy = (torch.sigmoid(raw[..., 0:2]) * scale_xy - 0.5 * (scale_xy - 1) + grid) * stride
    anchors_t = torch.tensor(anchors, dtype=torch.float32, device=raw.device)
    wh = torch.exp(torch.clamp(raw[..., 2:4], -20.0, 8.0)) * anchors_t[None, None, None]
    obj = torch.sigmoid(raw[..., 4:5])
    cls = torch.sigmoid(raw[..., 5:])
    scores = obj * cls  # (B, H, W, 3, C)

    ltwh = torch.cat([xy - wh / 2.0, wh], dim=-1)
    n = h * w * 3
    return ltwh.reshape(b, n, 4), scores.reshape(b, n, num_classes)


def select_and_nms(boxes, scores, score_threshold, nms_iou, max_detections,
                   pre_nms_top):
    """Best class per candidate (first maximum), the pre_nms_top best
    candidates (descending, lower index first on ties, as lax.top_k),
    then class-aware NMS: the CUDA kernel on the card."""
    best, cls = scores.max(dim=-1).values, scores.argmax(dim=-1).to(torch.int32)
    k = min(pre_nms_top, best.shape[1])
    top = torch.sort(best, dim=1, descending=True, stable=True).indices[:, :k]
    bx = torch.gather(boxes, 1, top[..., None].expand(-1, -1, 4))
    return nms(
        bx.contiguous(), torch.gather(best, 1, top).contiguous(),
        torch.gather(cls, 1, top).contiguous(), nms_iou, score_threshold,
        max_detections,
    )


def postprocess(
    outputs,
    num_classes: int = 80,
    input_size: int = 608,
    score_threshold: float = 0.25,
    nms_iou: float = 0.2,
    max_detections: int = 64,
    pre_nms_top: int = 512,
):
    """Decode all heads and run class-aware NMS (nms-iou 0.2 per reference
    config/dnn/yolov4_b2.txt). Returns (ltwh (B, K, 4), scores (B, K),
    classes (B, K) int32, valid (B, K) bool), K = max_detections."""
    boxes_all, scores_all = [], []
    for raw, anc, stride, sxy in zip(outputs, ANCHORS, STRIDES, SCALE_XY):
        bx, sc = decode_head(raw, anc, stride, sxy, num_classes, input_size)
        boxes_all.append(bx)
        scores_all.append(sc)
    return select_and_nms(
        torch.cat(boxes_all, dim=1), torch.cat(scores_all, dim=1),
        score_threshold, nms_iou, max_detections, pre_nms_top,
    )


def preprocess_frames(y, u, v, input_size: int = 608):
    """I420 planes (uint8 tensors on the target device) -> (1, S, S, 3) RGB
    in [0, 1] (the reference uses nvvideoconvert + net-scale-factor
    1/255). The final resize antialiases when it shrinks, as
    jax.image.resize does."""
    yf = y.to(torch.float32)
    h, w = yf.shape

    def up(c):
        return F.interpolate(c.to(torch.float32)[None, None], size=(h, w),
                             mode="nearest-exact")[0, 0]

    uf, vf = up(u), up(v)
    yy = yf - 16.0
    uu = uf - 128.0
    vv = vf - 128.0
    r = 1.164 * yy + 1.596 * vv
    g = 1.164 * yy - 0.392 * uu - 0.813 * vv
    b = 1.164 * yy + 2.017 * uu
    rgb = torch.stack([r, g, b], dim=0) / 255.0
    rgb = torch.clamp(rgb, 0.0, 1.0)
    rgb = F.interpolate(rgb[None], size=(input_size, input_size), mode="bilinear",
                        align_corners=False, antialias=True)
    return rgb.permute(0, 2, 3, 1)


def darknet_convs(model: nn.Module):
    """The model's ConvBN layers in registration (= darknet cfg) order."""
    return [m for m in model.modules() if isinstance(m, ConvBN)]


@torch.no_grad()
def load_darknet_weights(model: nn.Module, path) -> nn.Module:
    """Load darknet `.weights` (yolov4.weights) into `model`, in place.

    After a 20-byte header, the file is [bn_bias, bn_scale, bn_mean,
    bn_var, conv_w] per conv-bn layer and [bias, conv_w] per linear head
    conv, in cfg order, which is the order `darknet_convs` walks. Darknet
    stores conv weights OIHW, torch's layout. A short or over-long file
    is refused (accuracy against released weights is unverified here: the
    file is not in the repository)."""
    buf = np.fromfile(path, dtype=np.float32, offset=20)
    pos = 0

    def take(param):
        nonlocal pos
        n = param.numel()
        if pos + n > len(buf):
            raise ValueError(
                f"darknet weights file too short: need {pos + n} floats, "
                f"have {len(buf)}"
            )
        param.copy_(torch.from_numpy(buf[pos : pos + n]).reshape(param.shape))
        pos += n

    for m in darknet_convs(model):
        if m.bn is None:
            take(m.conv.bias)
        else:
            for p in (m.bn.bias, m.bn.weight, m.bn.running_mean, m.bn.running_var):
                take(p)
        take(m.conv.weight)

    if pos != len(buf):
        raise ValueError(
            f"darknet weights file has {len(buf) - pos} trailing floats "
            f"(expected exactly {pos})"
        )
    return model


def _torch_prefix(scope: str) -> str:
    """Flax module scope of a YOLOv4 ConvBN -> the port's module path."""
    parts = scope.split("/")
    idx = [p.rsplit("_", 1)[1] for p in parts]
    if parts[0].startswith("CSPDarknet53"):
        if parts[1].startswith("CSPBlock"):
            return f"backbone.stages.{idx[1]}.convs.{idx[2]}"
        return "backbone.stem"
    if parts[0].startswith("SPP"):
        return f"spp.convs.{idx[1]}"
    return f"convs.{idx[0]}"


def convert_flax_variables(variables) -> dict:
    """The JAX package's Flax YOLOv4 variables ({"params": ...,
    "batch_stats": ...}, nested dicts of arrays) -> a YOLOv4 state_dict:
    conv kernels HWIO -> OIHW, BatchNorm scale/bias/mean/var."""

    def flat(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict) or hasattr(v, "items"):
                yield from flat(v, f"{prefix}{k}/")
            else:
                yield f"{prefix}{k}", np.asarray(v, dtype=np.float32)

    params = dict(flat(variables["params"]))
    stats = dict(flat(variables["batch_stats"]))
    sd = {}
    for key, kernel in params.items():
        if not key.endswith("/Conv_0/kernel"):
            continue
        scope = key[: -len("/Conv_0/kernel")]
        dst = _torch_prefix(scope)
        sd[f"{dst}.conv.weight"] = torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy())
        if f"{scope}/Conv_0/bias" in params:
            sd[f"{dst}.conv.bias"] = torch.from_numpy(params[f"{scope}/Conv_0/bias"])
        else:
            bn = f"{scope}/BatchNorm_0"
            sd[f"{dst}.bn.weight"] = torch.from_numpy(params[f"{bn}/scale"])
            sd[f"{dst}.bn.bias"] = torch.from_numpy(params[f"{bn}/bias"])
            sd[f"{dst}.bn.running_mean"] = torch.from_numpy(stats[f"{bn}/mean"])
            sd[f"{dst}.bn.running_var"] = torch.from_numpy(stats[f"{bn}/var"])
            sd[f"{dst}.bn.num_batches_tracked"] = torch.tensor(0)
    return sd


class YoloDetector:
    """The oracle callable: frames [(ts_seconds, y, u, v), ...] (numpy
    I420 planes) -> list[BoxRec] in original-frame pixel units, one frame
    per network call (the reference's nvinfer YOLOv4 engine + nvdsbbox
    extraction, config/dnn/yolov4_b2.txt). Its stages are exposed for
    timing: `preprocess`, `network`, `postprocess`. The wrapper is the
    oracles': models/rtdetr.py builds RT-DETR's detector on it too."""

    def __init__(self, model: nn.Module, postprocess_fn, input_size: int, device):
        self.model = model
        self.postprocess = postprocess_fn
        self.input_size = input_size
        self.device = torch.device(device)

    def planes(self, y, u, v):
        """numpy planes -> uint8 tensors on the detector's device."""
        return tuple(
            torch.from_numpy(np.ascontiguousarray(p)).to(self.device) for p in (y, u, v)
        )

    def preprocess(self, y, u, v) -> torch.Tensor:
        return preprocess_frames(y, u, v, self.input_size)

    @torch.no_grad()
    def network(self, x: torch.Tensor):
        return self.model(x)

    @torch.no_grad()
    def infer(self, y, u, v):
        """numpy planes -> (ltwh, scores, classes, valid) of the frame, as
        numpy arrays in network-input pixels."""
        with trace.span("cova.oracle.pre"):
            x = self.preprocess(*self.planes(y, u, v))
        with trace.span("cova.oracle.net"):
            heads = self.network(x)
        with trace.span("cova.oracle.post"):
            return tuple(a[0].cpu().numpy() for a in self.postprocess(heads))

    def boxrecs(self, ts, frame_shape, ltwh, scores, classes, valid) -> list:
        """One frame's NMS outputs (numpy, network-input pixels) -> its
        BoxRecs in the pixels of a frame of `frame_shape` (h, w)."""
        from cova_tpu_torch.aggregator import BoxRec

        h, w = frame_shape
        sx, sy = w / self.input_size, h / self.input_size
        recs = []
        for k in range(len(valid)):
            if not valid[k]:
                continue
            l, t, bw, bh = ltwh[k]
            recs.append(
                BoxRec(
                    left=float(l) * sx,
                    top=float(t) * sy,
                    width=float(bw) * sx,
                    height=float(bh) * sy,
                    area=float(bw) * sx * float(bh) * sy,
                    track_id=None,
                    timestamp=float(ts),
                    class_id=int(classes[k]),
                    confidence=float(scores[k]),
                )
            )
        return recs

    def __call__(self, frames):
        """BoxRecs of the frames; the boxes kept count in the tracer's
        `oracle.detections`."""
        recs = []
        for ts, y, u, v in frames:
            got = self.boxrecs(ts, y.shape, *self.infer(y, u, v))
            trace.count("oracle.detections", len(got))
            recs += got
        return recs


def make_yolo_detector(
    weights_path,
    num_classes: int = 80,
    input_size: int = 608,
    score_threshold: float = 0.25,
    nms_iou: float = 0.2,
    cfg_path=None,
    device="cuda",
) -> YoloDetector:
    """Build a CovaPipeline-compatible oracle from darknet `.weights` on
    `device`. On CUDA, TF32 is turned off process wide
    (pipeline.compressed.exact_float32).

    cfg_path builds the topology from the darknet cfg file the weights
    were trained for (models/darknet_cfg.py, which also loads non-yolov4
    variants; the class count then comes from the cfg); None uses the
    hand-written yolov4 topology, which the tests hold equal to
    cova_tpu/models/cfg/yolov4.cfg."""
    from cova_tpu_torch.pipeline.compressed import exact_float32

    exact_float32(device)
    # Built and loaded in host memory, then moved to `device` whole.
    if cfg_path:
        from cova_tpu_torch.models.darknet_cfg import (
            create_darknet,
            load_darknet_weights_cfg,
            postprocess_darknet,
        )

        model, heads = create_darknet(cfg_path, device="cpu")
        load_darknet_weights_cfg(model, weights_path)

        def post(outs):
            return postprocess_darknet(outs, heads, input_size,
                                       score_threshold=score_threshold, nms_iou=nms_iou)
    else:
        model = load_darknet_weights(create_yolov4(num_classes, device="cpu"),
                                     weights_path)

        def post(outs):
            return postprocess(outs, num_classes, input_size,
                               score_threshold=score_threshold, nms_iou=nms_iou)

    return YoloDetector(model.to(device).eval(), post, input_size, device)

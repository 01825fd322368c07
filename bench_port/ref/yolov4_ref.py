"""The plain reference of the oracle: YOLOv4 as AlexeyAB darknet's
cfg/yolov4.cfg (a copy lies beside this file) describes it, built by a
small interpreter of the cfg's sections, the frame's conversion to the
network's input, the heads' decoding and class-aware greedy NMS, in plain
torch operations. Nothing of the program is imported.

The weights are a flat float32 buffer in darknet order (per
convolution, in cfg order: [bias, scale, mean, variance] with BatchNorm,
[bias] without, then the OIHW kernel), the layout of darknet's
`.weights` after its header.
"""

from __future__ import annotations

import pathlib

import numpy as np
import torch
import torch.nn.functional as F

CFG = pathlib.Path(__file__).with_name("yolov4.cfg")
EPS = 1e-5
PRE_NMS_TOP = 512
MAX_OUT = 64


def parse(path=CFG) -> list[dict]:
    sections = []
    for raw in pathlib.Path(path).read_text().splitlines():
        line = raw.split("#", 1)[0].strip()
        if not line:
            continue
        if line.startswith("["):
            sections.append({"type": line.strip("[]")})
        else:
            k, v = line.split("=", 1)
            sections[-1][k.strip()] = v.strip()
    return sections


def conv_shapes(path=CFG) -> list[tuple[int, int, int, int, bool]]:
    """(filters, in channels, size, stride, batch_normalize) of every
    convolution, in cfg order."""
    net, *layers = parse(path)
    chans = [int(net["channels"])]
    out, convs = [], []
    for s in layers:
        c = chans[-1] if not out else out[-1][0]
        t = s["type"]
        if t == "convolutional":
            f = int(s["filters"])
            convs.append((f, c, int(s["size"]), int(s.get("stride", 1)),
                          bool(int(s.get("batch_normalize", 0)))))
            out.append((f,))
        elif t == "route":
            idx = [int(v) for v in s["layers"].split(",")]
            out.append((sum(out[i if i >= 0 else len(out) + i][0] for i in idx),))
        else:
            out.append((c,))
    return convs


def num_weights(path=CFG) -> int:
    return sum((f if not bn else 4 * f) + f * c * k * k for f, c, k, _, bn in conv_shapes(path))


class Yolo:
    """The network over a flat weight buffer (a float32 tensor)."""

    def __init__(self, flat: torch.Tensor, path=CFG):
        net, *self.layers = parse(path)
        self.size = int(net["width"])
        self.params = []
        pos = 0
        for f, c, k, _, bn in conv_shapes(path):
            parts = {}
            for name in (("bias", "scale", "mean", "var") if bn else ("bias",)):
                parts[name] = flat[pos : pos + f]
                pos += f
            parts["w"] = flat[pos : pos + f * c * k * k].reshape(f, c, k, k)
            pos += f * c * k * k
            self.params.append(parts)
        if pos != flat.numel():
            raise ValueError(f"weights hold {flat.numel()} floats, the cfg needs {pos}")

    @torch.no_grad()
    def heads(self, x: torch.Tensor) -> list[torch.Tensor]:
        """(B, 3, S, S) -> the yolo layers' inputs, (B, H, W, 3*(5+C))."""
        outs, heads, ci = [], [], 0
        for s in self.layers:
            t = s["type"]
            if t == "convolutional":
                p = self.params[ci]
                ci += 1
                k = int(s["size"])
                pad = k // 2 if int(s.get("pad", 0)) else 0
                x = F.conv2d(x, p["w"], None if "scale" in p else p["bias"],
                             stride=int(s.get("stride", 1)), padding=pad)
                if "scale" in p:
                    x = ((x - p["mean"][:, None, None])
                         / torch.sqrt(p["var"][:, None, None] + EPS)
                         * p["scale"][:, None, None] + p["bias"][:, None, None])
                act = s.get("activation", "linear")
                if act == "mish":
                    x = x * torch.tanh(F.softplus(x))
                elif act == "leaky":
                    x = torch.where(x > 0, x, 0.1 * x)
                elif act != "linear":
                    raise ValueError(act)
            elif t == "shortcut":
                x = x + outs[int(s["from"])]
            elif t == "route":
                idx = [int(v) for v in s["layers"].split(",")]
                x = torch.cat([outs[i] for i in idx], 1)
            elif t == "maxpool":
                k = int(s["size"])
                x = F.max_pool2d(x, k, int(s.get("stride", 1)), k // 2)
            elif t == "upsample":
                x = x.repeat_interleave(int(s["stride"]), 2).repeat_interleave(
                    int(s["stride"]), 3)
            elif t == "yolo":
                heads.append(x.permute(0, 2, 3, 1).contiguous())
            else:
                raise ValueError(t)
            outs.append(x)
        return heads

    def yolo_layers(self) -> list[dict]:
        return [s for s in self.layers if s["type"] == "yolo"]


def to_input(y, u, v, size: int) -> torch.Tensor:
    """I420 planes (uint8 tensors) -> (1, 3, size, size) RGB in [0, 1]:
    chroma repeated to full size, BT.601 limited range, clipped, then
    resized bilinearly with antialiasing."""
    h, w = y.shape
    uf = u.float().repeat_interleave(2, 0).repeat_interleave(2, 1)[:h, :w] - 128.0
    vf = v.float().repeat_interleave(2, 0).repeat_interleave(2, 1)[:h, :w] - 128.0
    yf = y.float() - 16.0
    rgb = torch.stack([1.164 * yf + 1.596 * vf,
                       1.164 * yf - 0.392 * uf - 0.813 * vf,
                       1.164 * yf + 2.017 * uf]) / 255.0
    rgb = rgb.clamp(0.0, 1.0)
    return F.interpolate(rgb[None], size=(size, size), mode="bilinear",
                         align_corners=False, antialias=True)


def decode(heads, yolo_layers, size: int):
    """Heads -> (N, 4) ltwh boxes and (N, C) scores, in input pixels."""
    boxes, scores = [], []
    for raw, s in zip(heads, yolo_layers):
        anchors = [float(a) for a in s["anchors"].split(",")]
        mask = [int(m) for m in s["mask"].split(",")]
        anc = torch.tensor([[anchors[2 * m], anchors[2 * m + 1]] for m in mask],
                           device=raw.device)
        sxy = float(s.get("scale_x_y", 1.0))
        nc = int(s["classes"])
        h, w = raw.shape[1:3]
        stride = size // h
        r = raw[0].reshape(h, w, len(mask), 5 + nc)
        gy, gx = torch.meshgrid(torch.arange(h, device=raw.device, dtype=torch.float32),
                                torch.arange(w, device=raw.device, dtype=torch.float32),
                                indexing="ij")
        grid = torch.stack([gx, gy], -1)[:, :, None, :]
        xy = (torch.sigmoid(r[..., 0:2]) * sxy - 0.5 * (sxy - 1) + grid) * stride
        wh = torch.exp(r[..., 2:4].clamp(-20.0, 8.0)) * anc
        sc = torch.sigmoid(r[..., 4:5]) * torch.sigmoid(r[..., 5:])
        boxes.append(torch.cat([xy - wh / 2.0, wh], -1).reshape(-1, 4))
        scores.append(sc.reshape(-1, nc))
    return torch.cat(boxes), torch.cat(scores)


def nms(boxes, scores, score_threshold: float, iou_threshold: float):
    """The PRE_NMS_TOP best candidates by their best class (first maximum;
    ties by index), then greedy class-aware NMS in score order (ties by
    rank): at most MAX_OUT survivors as (ltwh, score, class), best first."""
    best, cls = scores.max(-1).values, scores.argmax(-1)
    top = torch.sort(best, descending=True, stable=True).indices[:PRE_NMS_TOP]
    b = boxes[top].cpu().numpy().astype(np.float32)
    s = best[top].cpu().numpy().astype(np.float32)
    c = cls[top].cpu().numpy()
    order = np.argsort(-s, kind="stable")
    b, s, c = b[order], s[order], c[order]
    alive = s > np.float32(score_threshold)
    x2, y2 = b[:, 0] + b[:, 2], b[:, 1] + b[:, 3]
    area = b[:, 2] * b[:, 3]
    for i in range(len(s)):
        if not alive[i]:
            continue
        ix = np.clip(np.minimum(x2[i], x2) - np.maximum(b[i, 0], b[:, 0]), 0, None)
        iy = np.clip(np.minimum(y2[i], y2) - np.maximum(b[i, 1], b[:, 1]), 0, None)
        inter = ix * iy
        union = area[i] + area - inter
        iou = np.where(union > 0, inter / np.maximum(union, np.float32(1e-12)), 0)
        kill = (iou > np.float32(iou_threshold)) & (c == c[i])
        kill[: i + 1] = False
        alive &= ~kill
    keep = np.nonzero(alive)[0][:MAX_OUT]
    return b[keep], s[keep], c[keep]


def detections(heads, yolo_layers, size, frame_hw, score_threshold, iou_threshold):
    """One frame's detections as (class, score, left, top, width, height)
    in the frame's pixels."""
    b, s, c = nms(*decode(heads, yolo_layers, size), score_threshold, iou_threshold)
    h, w = frame_hw
    sx, sy = w / size, h / size
    return [(int(c[k]), float(s[k]), float(b[k, 0]) * sx, float(b[k, 1]) * sy,
             float(b[k, 2]) * sx, float(b[k, 3]) * sy) for k in range(len(s))]

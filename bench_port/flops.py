"""The models' floating-point operations, counted from the published layer
shapes (2 a multiply-add, convolutions and the temporal mixes alone, as
torch.utils.flop_counter counts them), so that a share of the chip's peak
does not depend on what implements the layers."""

from __future__ import annotations

from bench_port.ref import yolov4_ref

ENCODER = (16, 32, 64, 128)
DECODER = (64, 32, 16, 16)


def blobnet_window(h: int, w: int, in_ch: int = 4, t: int = 4) -> int:
    """One window of T frames at an h x w macroblock grid."""
    flops, c, sizes = 0, in_ch, []
    for ch in ENCODER:
        flops += 2 * c * ch * 9 * h * w * t  # 3x3 conv, each timestep
        h, w = -(-h // 2), -(-w // 2)  # pooled, padded to the odd size
        flops += 2 * 2 * t * t * ch * h * w  # two T x T mixes
        sizes.append((ch, h, w))
        c = ch
    skips = list(reversed(sizes))
    c, h, w = skips[0]
    targets = [s[1:] for s in skips[1:]]
    for i, ch in enumerate(DECODER):
        flops += 2 * c * ch * 16 * h * w  # 4x4 transposed conv over its input
        if i < len(targets):
            h, w = targets[i]
            c = ch + skips[i + 1][0]
        else:
            h, w, c = None, None, ch
    return flops


def blobnet_head(h: int, w: int) -> int:
    return 2 * DECODER[-1] * h * w


def blobnet(h: int, w: int, in_ch: int = 4, t: int = 4) -> int:
    return blobnet_window(h, w, in_ch, t) + blobnet_head(h, w)


def yolo(path=yolov4_ref.CFG) -> int:
    """One frame through the cfg's network at its input size."""
    net, *layers = yolov4_ref.parse(path)
    h = w = int(net["width"])
    c = int(net["channels"])
    outs, flops = [], 0
    for s in layers:
        t = s["type"]
        if t == "convolutional":
            k, st, f = int(s["size"]), int(s.get("stride", 1)), int(s["filters"])
            pad = k // 2 if int(s.get("pad", 0)) else 0
            h, w = (h + 2 * pad - k) // st + 1, (w + 2 * pad - k) // st + 1
            flops += 2 * c * f * k * k * h * w
            c = f
        elif t == "route":
            idx = [int(v) for v in s["layers"].split(",")]
            picked = [outs[i] for i in idx]
            c = sum(p[0] for p in picked)
            h, w = picked[0][1:]
        elif t == "upsample":
            h, w = h * int(s["stride"]), w * int(s["stride"])
        outs.append((c, h, w))
    return flops

"""The oracle's weights, made on the device from the seed.

The recipe of the port's smoke test (`_yolo_weights`), which keeps 110
stacked convolutions finite and the heads following the frame: per
convolution in darknet cfg order, biases N(0, 0.1); with BatchNorm, scale
U(0.9, 1.1), mean N(0, 0.1), variance U(0.8, 1.2); kernels N(0, gain *
sqrt(2 / fan_in)), gain 0.8. The numbers come from a torch.Generator on
the card in two large draws (one normal, one uniform), scaled segment by
segment; the result is one flat float32 buffer in darknet's `.weights`
order, which the program's model and the plain reference both load.
"""

from __future__ import annotations

import torch

from bench_port.ref import yolov4_ref


def segments(gain: float):
    """(length, kind, a, b) per stretch of the flat buffer: kind 0 is
    N(a, b), kind 1 is U(a, b)."""
    out = []
    for f, c, k, _, bn in yolov4_ref.conv_shapes():
        if bn:
            out += [(f, 0, 0.0, 0.1), (f, 1, 0.9, 1.1), (f, 0, 0.0, 0.1), (f, 1, 0.8, 1.2)]
        else:
            out.append((f, 0, 0.0, 0.1))
        out.append((f * c * k * k, 0, 0.0, gain * (2.0 / (k * k * c)) ** 0.5))
    return out


@torch.no_grad()
def seeded_flat(seed: int, device, gain: float = 0.8) -> torch.Tensor:
    segs = segments(gain)
    n = sum(s[0] for s in segs)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    normal = torch.randn(n, generator=g, device=device)
    uniform = torch.rand(n, generator=g, device=device)
    lens = torch.tensor([s[0] for s in segs], device=device)
    rep = lambda i: torch.repeat_interleave(
        torch.tensor([s[i] for s in segs], dtype=torch.float32, device=device), lens)
    kind, a, b = rep(1), rep(2), rep(3)
    return torch.where(kind > 0, a + (b - a) * uniform, a + b * normal)


@torch.no_grad()
def load_into(model, convs, flat: torch.Tensor) -> None:
    """Copy the flat buffer into the program's model, whose ConvBN layers
    `convs` walk the cfg's order."""
    pos = 0
    for m in convs:
        params = ([m.conv.bias] if m.bn is None else
                  [m.bn.bias, m.bn.weight, m.bn.running_mean, m.bn.running_var])
        for p in params + [m.conv.weight]:
            p.copy_(flat[pos : pos + p.numel()].reshape(p.shape))
            pos += p.numel()
    if pos != flat.numel():
        raise ValueError(f"model takes {pos} weights, the buffer holds {flat.numel()}")

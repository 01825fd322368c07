"""BlobNet — the compressed-domain foreground segmentation CNN, in
PyTorch (port of cova_tpu/models/blobnet.py, eval mode only).

* encoder: 4 stages; each = 3x3 Conv2D per timestep (channels
  [16, 32, 64, 128]) + relu + BatchNorm + MaxPool 2x2, zero-padded
  top/left when the pooled dim was odd, + a residual point-wise temporal
  block (two TxT mixes over the T axis with relu, residual add, relu);
* decoder: first temporal slice of each encoder output (reversed),
  4 ConvTranspose(4x4, stride 2, VALID) upsample blocks (channels
  [64, 32, 16, 16]), each preceded by relu and followed by a center
  crop/pad to the skip shape, BatchNorm and skip concat (except the
  last), then a 1x1 conv + sigmoid in float32.

Public layout is the JAX package's: input (B, T, H, W, C) float, output
(B, H, W) probabilities. Inside, tensors are NCHW with T folded into the
batch axis. Dropout is identity in eval mode and is not modelled.

Weights come from the committed Flax artifacts (artifacts/*.npz) through
`convert_flax_variables`: conv kernels HWIO -> OIHW; Flax ConvTranspose
(transpose_kernel=False) is a dilated convolution with the kernel NOT
flipped, so its torch weight is the spatially flipped kernel in
(in, out, kh, kw) order.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-5  # Flax BatchNorm default, same as torch's


@dataclasses.dataclass(frozen=True)
class BlobNetConfig:
    encoder_channels: Sequence[int] = (16, 32, 64, 128)
    decoder_channels: Sequence[int] = (64, 32, 16, 16)
    temporal_layers: int = 2  # TxT mixes in the point-wise block
    timestep: int = 4
    # 3 = [mb_class, mv_x, mv_y]; 4 adds the residual nnz channel (the
    # shipped artifacts use 4 with signed MVs).
    in_channels: int = 3


class PointWiseTemporal(nn.Module):
    """Residual temporal-mixing block: x (B, T, C, H, W); each layer is
    the einsum `btchw,ts->bschw` with a (T, T) matrix, then relu; the
    block ends with relu(h + x)."""

    def __init__(self, layers: int, timestep: int):
        super().__init__()
        self.mix = nn.ParameterList(
            [nn.Parameter(torch.empty(timestep, timestep)) for _ in range(layers)]
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for w in self.mix:
            h = F.relu(torch.einsum("btchw,ts->bschw", h, w))
        return F.relu(h + x)


def _pool_pad(x: torch.Tensor) -> torch.Tensor:
    """MaxPool 2x2 (floor) over H, W of (N, C, H, W), then zero-pad
    top/left where the unpooled dim was odd."""
    h, w = x.shape[-2:]
    if h >= 2 and w >= 2:
        y = F.max_pool2d(x, 2)
    else:  # a size-1 dim pools to size 0 (torch refuses that) and pads to 1
        y = x.new_zeros(x.shape[:-2] + (h // 2, w // 2))
    return F.pad(y, (w % 2, 0, h % 2, 0))


def _crop_or_pad_center(x: torch.Tensor, th: int, tw: int) -> torch.Tensor:
    """Center crop/pad the last two dims to (th, tw); the extra element
    goes first."""
    h, w = x.shape[-2:]
    dh, dw = h - th, w - tw
    if dh > 0:
        x = x[..., dh // 2 + dh % 2 : h - dh // 2, :]
    elif dh < 0:
        d = -dh
        x = F.pad(x, (0, 0, d // 2 + d % 2, d // 2))
    if dw > 0:
        x = x[..., dw // 2 + dw % 2 : w - dw // 2]
    elif dw < 0:
        d = -dw
        x = F.pad(x, (d // 2 + d % 2, d // 2))
    return x


class BlobNet(nn.Module):
    def __init__(self, config: BlobNetConfig = BlobNetConfig()):
        super().__init__()
        self.config = config
        cin = config.in_channels
        self.enc_conv = nn.ModuleList()
        self.enc_bn = nn.ModuleList()
        self.enc_pwt = nn.ModuleList()
        for ch in config.encoder_channels:
            self.enc_conv.append(nn.Conv2d(cin, ch, 3, padding=1))
            self.enc_bn.append(nn.BatchNorm2d(ch, eps=BN_EPS))
            self.enc_pwt.append(
                PointWiseTemporal(config.temporal_layers, config.timestep)
            )
            cin = ch
        skip_ch = list(reversed(config.encoder_channels))
        self.dec_convt = nn.ModuleList()
        self.dec_bn = nn.ModuleList()
        cin = skip_ch[0]
        n_dec = len(config.decoder_channels)
        for i, ch in enumerate(config.decoder_channels):
            self.dec_convt.append(nn.ConvTranspose2d(cin, ch, 4, stride=2))
            if i < n_dec - 1:
                self.dec_bn.append(nn.BatchNorm2d(ch, eps=BN_EPS))
                cin = ch + skip_ch[i + 1]
            else:
                cin = ch
        self.head = nn.Conv2d(cin, 1, 1)
        self.eval()

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Random initialisation drawn from `generator` (the counterpart of
        the JAX package's PRNGKey(0) init; the numbers differ): weights
        normal with std 1/sqrt(fan_in), biases zero, BatchNorm identity."""
        for name, p in self.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            elif name.startswith(("enc_bn", "dec_bn")):
                p.fill_(1.0)
            else:
                fan_in = p[0].numel() if p.dim() > 1 else p.numel()
                if name.startswith("dec_convt"):
                    fan_in = p.shape[0] * p.shape[2] * p.shape[3]
                std = 1.0 / max(fan_in, 1) ** 0.5
                p.copy_(torch.randn(p.shape, generator=generator) * std)
        for m in self.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.reset_running_stats()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, T, H, W, C) float -> (B, H, W) float32 probabilities."""
        b, t, h0, w0, c = x.shape
        x = x.to(torch.float32).permute(0, 1, 4, 2, 3)  # (B, T, C, H, W)
        skips = []
        for conv, bn, pwt in zip(self.enc_conv, self.enc_bn, self.enc_pwt):
            y = x.reshape((b * t,) + x.shape[2:])
            y = bn(F.relu(conv(y)))
            y = _pool_pad(y)
            x = pwt(y.reshape((b, t) + y.shape[1:]))
            skips.append(x)

        feats = [s[:, 0] for s in reversed(skips)]  # (B, C, H, W) each
        targets = [f.shape[-2:] for f in feats[1:]] + [(h0, w0)]
        x = feats[0]
        for i, convt in enumerate(self.dec_convt):
            x = convt(F.relu(x))
            x = _crop_or_pad_center(x, *targets[i])
            if i < len(self.dec_bn):
                x = torch.cat([self.dec_bn[i](x), feats[i + 1]], dim=1)
        return torch.sigmoid(self.head(x).to(torch.float32))[:, 0]


def convert_flax_variables(arrays: dict) -> dict:
    """Flax variables, flattened as in the committed npz artifacts
    ("params/Conv_0/kernel", "batch_stats/BatchNorm_0/mean", ...), to a
    BlobNet state_dict. `__meta__` and other non-weight keys are ignored.

    Flax numbering follows creation order: Conv_0..3 / BatchNorm_0..3 /
    PointWiseTemporal_0..3 are the encoder, ConvTranspose_0..3 and
    BatchNorm_4.. the decoder, and the last Conv the 1x1 head."""
    n_enc = sum(1 for k in arrays if k.startswith("params/PointWiseTemporal_")
                and k.endswith("/mix_0"))
    n_dec = sum(1 for k in arrays if k.startswith("params/ConvTranspose_")
                and k.endswith("/kernel"))

    def t(key):
        return torch.from_numpy(np.array(arrays[key], dtype=np.float32))

    def conv(key):  # HWIO -> OIHW
        return t(key).permute(3, 2, 0, 1).contiguous()

    def bn(dst, i):
        return {
            f"{dst}.weight": t(f"params/BatchNorm_{i}/scale"),
            f"{dst}.bias": t(f"params/BatchNorm_{i}/bias"),
            f"{dst}.running_mean": t(f"batch_stats/BatchNorm_{i}/mean"),
            f"{dst}.running_var": t(f"batch_stats/BatchNorm_{i}/var"),
            f"{dst}.num_batches_tracked": torch.tensor(0),
        }

    sd = {}
    for i in range(n_enc):
        sd[f"enc_conv.{i}.weight"] = conv(f"params/Conv_{i}/kernel")
        sd[f"enc_conv.{i}.bias"] = t(f"params/Conv_{i}/bias")
        sd.update(bn(f"enc_bn.{i}", i))
        j = 0
        while f"params/PointWiseTemporal_{i}/mix_{j}" in arrays:
            sd[f"enc_pwt.{i}.mix.{j}"] = t(f"params/PointWiseTemporal_{i}/mix_{j}")
            j += 1
    for i in range(n_dec):
        # (kh, kw, in, out), unflipped -> (in, out, kh, kw), flipped.
        k = t(f"params/ConvTranspose_{i}/kernel")
        sd[f"dec_convt.{i}.weight"] = k.flip(0, 1).permute(2, 3, 0, 1).contiguous()
        sd[f"dec_convt.{i}.bias"] = t(f"params/ConvTranspose_{i}/bias")
        if i < n_dec - 1:
            sd.update(bn(f"dec_bn.{i}", n_enc + i))
    sd["head.weight"] = conv(f"params/Conv_{n_enc}/kernel")
    sd["head.bias"] = t(f"params/Conv_{n_enc}/bias")
    return sd


def load_artifact(path, device="cuda"):
    """(model, state_dict, meta) from a committed npz weight artifact; the
    architecture's input channels come from its stored `__meta__`, whose
    `signed_mv` / `use_nnz_channel` tell the caller which metadata
    packing the weights expect. The model is on `device`, in eval mode,
    with the weights loaded."""
    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files}
    meta = {}
    if "__meta__" in arrays:
        meta = json.loads(bytes(arrays["__meta__"]).decode())
    cfg = BlobNetConfig(in_channels=int(meta.get("in_channels", 3)))
    sd = convert_flax_variables(arrays)
    model = BlobNet(cfg)
    model.load_state_dict(sd)
    return model.to(device).eval(), sd, meta

"""BlobNet — the compressed-domain foreground segmentation CNN, in
PyTorch (port of cova_tpu/models/blobnet.py).

* encoder: 4 stages; each = 3x3 Conv2D per timestep (channels
  [16, 32, 64, 128]) + relu + BatchNorm + MaxPool 2x2, zero-padded
  top/left when the pooled dim was odd, + a residual point-wise temporal
  block (two TxT mixes over the T axis, each with relu and dropout,
  residual add, relu); in eval mode on the card everything after the
  convolution is one launch of K4 (ops/cuda/blob_stage.py);
* decoder: first temporal slice of each encoder output (reversed),
  4 ConvTranspose(4x4, stride 2, VALID) upsample blocks (channels
  [64, 32, 16, 16]), each preceded by relu and dropout and followed by a
  center crop/pad to the skip shape, BatchNorm and skip concat (except
  the last), then a 1x1 conv + sigmoid in float32; in eval mode on the
  card each block, the head and sigmoid in the last, is one launch of
  K12 (ops/cuda/blob_up.py), which reads the skip in place.

Public layout is the JAX package's: input (B, T, H, W, C) float, output
(B, H, W) probabilities. Inside, tensors are NCHW with T folded into the
batch axis.

Train mode (`model.train()`) follows Flax, not torch: BatchNorm
normalizes with the biased batch variance (E[x^2] - E[x]^2, Flax's
`use_fast_variance`) and updates the running statistics as
0.99 * running + 0.01 * batch, the variance biased too; dropout draws its
masks from the `torch.Generator` handed to `forward`. In eval mode both
are what the artifacts were exported for: running statistics, no
dropout.

Weights come from the committed Flax artifacts (artifacts/*.npz) through
`convert_flax_variables`: conv kernels HWIO -> OIHW; Flax ConvTranspose
(transpose_kernel=False) is a dilated convolution with the kernel NOT
flipped, so its torch weight is the spatially flipped kernel in
(in, out, kh, kw) order. `to_flax_arrays` is its exact inverse, and
`save_params_npz` writes the JAX package's flat npz layout, so each
package loads the other's weights.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import pathlib
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cova_tpu_torch import trace
from cova_tpu_torch.ops.batch_norm import BN_MOMENTUM, batch_norm  # noqa: F401
from cova_tpu_torch.ops.cuda.blob_stage import blob_stage, blob_stage_plain
from cova_tpu_torch.ops.cuda.blob_up import blob_up, blob_up_plain

BN_EPS = 1e-5  # Flax BatchNorm default, same as torch's
# Flax's lecun_normal draws a normal truncated at +-2 standard deviations
# and scales it so the variance stays 1/fan_in: the truncated unit
# normal's standard deviation is 0.8796...
TRUNC_STD = 0.87962566103423978


@dataclasses.dataclass(frozen=True)
class BlobNetConfig:
    encoder_channels: Sequence[int] = (16, 32, 64, 128)
    decoder_channels: Sequence[int] = (64, 32, 16, 16)
    temporal_layers: int = 2  # TxT mixes in the point-wise block
    timestep: int = 4
    dropout: float = 0.2
    # 3 = [mb_class, mv_x, mv_y]; 4 adds the residual nnz channel (the
    # shipped artifacts use 4 with signed MVs).
    in_channels: int = 3


def _dropout(x: torch.Tensor, p: float, generator) -> torch.Tensor:
    """Flax's dropout: keep each element with probability 1 - p, scaled
    by 1 / (1 - p); the mask comes from `generator` (on x's device)."""
    if generator is None:
        raise ValueError("dropout in train mode needs a torch.Generator")
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype, device=x.device))


class PointWiseTemporal(nn.Module):
    """Residual temporal-mixing block: x (B, T, C, H, W); each layer is
    the einsum `btchw,ts->bschw` with a (T, T) matrix, then relu and (in
    train mode) dropout; the block ends with relu(h + x)."""

    def __init__(self, layers: int, timestep: int, dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.mix = nn.ParameterList(
            [nn.Parameter(torch.empty(timestep, timestep)) for _ in range(layers)]
        )

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        h = x
        for w in self.mix:
            h = F.relu(torch.einsum("btchw,ts->bschw", h, w))
            if self.training and self.dropout > 0.0:
                h = _dropout(h, self.dropout, generator)
        return F.relu(h + x)


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
                PointWiseTemporal(config.temporal_layers, config.timestep, config.dropout)
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
        """Random initialisation drawn from `generator`, on its device, by
        Flax's defaults (the counterpart of the JAX package's PRNGKey
        init; the numbers differ): weights lecun_normal, i.e. a normal
        truncated at +-2 standard deviations with variance 1/fan_in;
        biases zero; BatchNorm identity."""
        for name, p in self.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            elif name.startswith(("enc_bn", "dec_bn")):
                p.fill_(1.0)
            else:
                fan_in = p[0].numel() if p.dim() > 1 else p.numel()
                if name.startswith("dec_convt"):
                    fan_in = p.shape[0] * p.shape[2] * p.shape[3]
                std = 1.0 / max(fan_in, 1) ** 0.5 / TRUNC_STD
                w = torch.empty(p.shape, device=generator.device)
                nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                      generator=generator)
                p.copy_(w)
        for m in self.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.reset_running_stats()

    def forward(self, x: torch.Tensor, generator=None, process_group=None) -> torch.Tensor:
        """x: (B, T, H, W, C) float -> (B, H, W) float32 probabilities.
        In train mode with dropout, `generator` (on x's device) draws the
        masks; with `process_group`, BatchNorm's batch statistics are
        those of the group's global batch (`batch_norm`).

        Each encoder stage's tail after its convolution runs as one launch
        of K4 (ops/cuda/blob_stage.py) in eval mode on CUDA, which raises
        on what the kernel does not take (a gradient asked for: run the
        eval forward under torch.no_grad()); in train mode and on the CPU
        as `blob_stage_plain`. Each decoder block likewise runs as one
        launch of K12 (ops/cuda/blob_up.py: the transposed convolution at
        the kept positions, then BatchNorm, or in the last block, the one
        without a BatchNorm, the head and the sigmoid), or as
        `blob_up_plain`. The counters `blobnet.stages` and
        `blobnet.stages_fused` count the stages run and those sent to K4,
        `blobnet.up_blocks` and `blobnet.up_fused` the decoder blocks run
        and those sent to K12."""
        b, t, h0, w0, c = x.shape
        drop = self.training and self.config.dropout > 0.0
        x = x.to(torch.float32).permute(0, 1, 4, 2, 3)  # (B, T, C, H, W)
        skips = []
        for conv, bn, pwt in zip(self.enc_conv, self.enc_bn, self.enc_pwt):
            y = conv(x.reshape((b * t,) + x.shape[2:]))
            trace.count("blobnet.stages")
            if self.training or not y.is_cuda:
                norm = functools.partial(batch_norm, bn, process_group=process_group)
                x = blob_stage_plain(y, norm, pwt, b, generator)
            else:
                trace.count("blobnet.stages_fused")
                x = blob_stage(y, bn, pwt, b)
            skips.append(x)
            del y  # the convolution's output, a stage's largest tensor, dies with its tail

        feats = [s[:, 0] for s in reversed(skips)]  # (B, C, H, W) each
        targets = [f.shape[-2:] for f in feats[1:]] + [(h0, w0)]
        dropout = (lambda t, g: _dropout(t, self.config.dropout, g)) if drop else None
        x, skip = feats[0], None
        for i, convt in enumerate(self.dec_convt):
            # The last block, the one without a BatchNorm, ends in the head.
            bn = self.dec_bn[i] if i < len(self.dec_bn) else None
            head = self.head if bn is None else None
            trace.count("blobnet.up_blocks")
            if self.training or not x.is_cuda:
                x = blob_up_plain(x, skip, convt, bn, head, targets[i], dropout, generator,
                                  process_group)
            else:
                trace.count("blobnet.up_fused")
                x = blob_up(x, skip, convt, bn, head, targets[i])
            skip = None if bn is None else feats[i + 1]
        return x


def create_blobnet(generator: torch.Generator, config: BlobNetConfig = BlobNetConfig(),
                   device="cuda"):
    """Init helper returning (model, state_dict) (the counterpart of the
    JAX package's `create_blobnet(rng, config)`): the weights drawn from
    `generator` by `BlobNet.reset_parameters`, the model moved to
    `device`, in eval mode."""
    model = BlobNet(config)
    model.reset_parameters(generator)
    model = model.to(device).eval()
    return model, model.state_dict()


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


def to_flax_arrays(state_dict) -> dict:
    """A BlobNet state_dict to the flat Flax variables of the npz
    artifacts (float32 numpy arrays): the exact inverse of
    `convert_flax_variables` (OIHW -> HWIO; the ConvTranspose weight
    permuted back to (kh, kw, in, out) and un-flipped; BatchNorm's
    `num_batches_tracked` has no Flax counterpart and is dropped)."""
    n_enc = sum(1 for k in state_dict if k.startswith("enc_conv.") and k.endswith(".weight"))
    n_dec = sum(1 for k in state_dict if k.startswith("dec_convt.") and k.endswith(".weight"))

    def a(key):
        return state_dict[key].detach().to("cpu", torch.float32)

    def conv(key):  # OIHW -> HWIO
        return a(key).permute(2, 3, 1, 0)

    def bn(src, i):
        return {
            f"params/BatchNorm_{i}/scale": a(f"{src}.weight"),
            f"params/BatchNorm_{i}/bias": a(f"{src}.bias"),
            f"batch_stats/BatchNorm_{i}/mean": a(f"{src}.running_mean"),
            f"batch_stats/BatchNorm_{i}/var": a(f"{src}.running_var"),
        }

    out = {}
    for i in range(n_enc):
        out[f"params/Conv_{i}/kernel"] = conv(f"enc_conv.{i}.weight")
        out[f"params/Conv_{i}/bias"] = a(f"enc_conv.{i}.bias")
        out.update(bn(f"enc_bn.{i}", i))
        j = 0
        while f"enc_pwt.{i}.mix.{j}" in state_dict:
            out[f"params/PointWiseTemporal_{i}/mix_{j}"] = a(f"enc_pwt.{i}.mix.{j}")
            j += 1
    for i in range(n_dec):
        # (in, out, kh, kw), flipped -> (kh, kw, in, out), unflipped.
        w = a(f"dec_convt.{i}.weight").permute(2, 3, 0, 1).flip(0, 1)
        out[f"params/ConvTranspose_{i}/kernel"] = w
        out[f"params/ConvTranspose_{i}/bias"] = a(f"dec_convt.{i}.bias")
        if i < n_dec - 1:
            out.update(bn(f"dec_bn.{i}", n_enc + i))
    out[f"params/Conv_{n_enc}/kernel"] = conv("head.weight")
    out[f"params/Conv_{n_enc}/bias"] = a("head.bias")
    return {k: np.ascontiguousarray(v.numpy()) for k, v in out.items()}


def save_params_npz(path, state_dict, meta: dict | None = None) -> None:
    """Persist a BlobNet state_dict as one flat .npz file in the JAX
    package's layout (`cova_tpu/models/blobnet.py::save_params_npz`):
    the Flax keys of `to_flax_arrays`, and `meta`, a JSON dict describing
    the input contract (in_channels, signed_mv, ...), under "__meta__".
    The JAX package's `load_artifact` reads the file, and so does this
    module's."""
    arrays = to_flax_arrays(state_dict)
    if meta:
        arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    pathlib.Path(path).parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **arrays)


def load_meta_npz(path) -> dict:
    """Input-contract metadata stored by save_params_npz ({} if none)."""
    with np.load(path) as data:
        if "__meta__" not in data:
            return {}
        return json.loads(bytes(data["__meta__"]).decode())


def load_artifact(path, device="cuda"):
    """(model, state_dict, meta) from a committed npz weight artifact; the
    architecture's input channels come from its stored `__meta__`, whose
    `signed_mv` / `use_nnz_channel` tell the caller which metadata
    packing the weights expect. The model is on `device`, in eval mode,
    with the weights loaded."""
    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files if k != "__meta__"}
    meta = load_meta_npz(path)
    cfg = BlobNetConfig(in_channels=int(meta.get("in_channels", 3)))
    sd = convert_flax_variables(arrays)
    model = BlobNet(cfg)
    model.load_state_dict(sd)
    return model.to(device).eval(), sd, meta

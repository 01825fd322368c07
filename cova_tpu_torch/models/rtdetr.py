"""RT-DETR in PyTorch: a transformer pixel-domain oracle beside YOLOv4
(eval mode only).

RT-DETR-R50 at 640 x 640 ("DETRs Beat YOLOs on Real-time Object
Detection", arXiv:2304.08069; lyuwenyu/RT-DETR,
rtdetr_pytorch/configs/rtdetr/rtdetr_r50vd_6x_coco.yml, modules in
src/nn/backbone/presnet.py and src/zoo/rtdetr/{hybrid_encoder,
rtdetr_decoder, rtdetr_postprocessor, utils}.py):

  backbone  PResNet-50-vd: a stem of three 3x3 conv-BN-ReLU (3->32 at
            stride 2, 32->32, 32->64), a 3x3 max pool at stride 2,
            bottleneck stages of [3, 4, 6, 3] blocks with the stride on
            the 3x3 conv and, where the stride changes, a 2x2 average pool
            (ceil mode) before the shortcut's 1x1 conv-BN; frozen BN;
            the 512, 1024 and 2048 channel maps at strides 8, 16, 32
  encoder   the hybrid encoder at width 256: 1x1 conv-BN projections;
            AIFI, one post-norm transformer layer (8 heads, FFN 1024,
            GELU, a 2-D sin-cos position embedding) on the stride-32 map;
            CCFM, a top-down then a bottom-up pass of 1x1 lateral
            conv-BN-SiLU, nearest x2 upsampling, 3x3 stride-2
            conv-BN-SiLU and CSPRepLayers (two 1x1 branches, 3
            RepVggBlocks of a 3x3 and a 1x1 conv-BN summed, then SiLU)
  select    the decoder's 1x1 conv-BN projections flattened to 8400
            tokens; anchors for the 640 grid (grid size 0.05, valid where
            every coordinate lies in (0.01, 0.99)); the memory times the
            valid mask through `enc_output` (Linear, LayerNorm), the
            class head and the box MLP; the 300 tokens of largest class
            logit (torch.topk) become the queries
  decoder   6 post-norm layers: self-attention (8 heads), multi-scale
            deformable cross-attention (3 levels, 8 heads, 4 points; its
            core is K11, ops/cuda/msda_kernel.py), FFN 1024 with ReLU;
            boxes refined through inverse_sigmoid a layer; the query
            position MLP 4->512->256; the last layer's heads only
  post      RTDETRPostProcessor with focal loss: sigmoid over the 300 x 80
            logits, the top 300 of them, label = index mod 80, boxes from
            cx cy w h to pixels; no NMS

Left out, as inference leaves them out: the denoising queries (training
only; `denoising_class_embed` is kept so that a released state dict
loads), the auxiliary heads. Frozen BN is the affine map upstream's
FrozenBatchNorm2d computes. Parameter names are upstream's (`backbone.*`,
`encoder.*`, `decoder.*`), so its state dict loads by name.

The network takes the shared oracle wrapper's input, (B, S, S, 3) RGB in
[0, 1] (models/yolov4.py `preprocess_frames`: a plain resize, no
letterbox, no mean or std, as RT-DETR takes it), and returns the
frame's encoder memory, token scores, selected indices and the last
layer's logits and boxes. `make_rtdetr_detector` wraps it in
`YoloDetector`, the oracle wrapper CovaPipeline calls.
"""

from __future__ import annotations

import dataclasses
import math
from collections import OrderedDict
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from cova_tpu_torch import trace
from cova_tpu_torch.ops.cuda import msda_kernel


@dataclasses.dataclass(frozen=True)
class RTDETRConfig:
    """The widths and counts of the yml (defaults: RT-DETR-R50 at 640)."""

    input_size: int = 640
    num_classes: int = 80
    blocks: tuple = (3, 4, 6, 3)  # bottlenecks a stage (depth 50)
    stem: int = 64  # the stem's output; its first two convs take half
    widths: tuple = (64, 128, 256, 512)  # bottleneck widths; outputs are 4x
    hidden_dim: int = 256
    nhead: int = 8
    enc_ffn: int = 1024
    pe_temperature: float = 10000.0
    csp_blocks: int = 3  # round(3 * depth_mult)
    expansion: float = 1.0
    num_queries: int = 300
    num_top: int = 300  # RTDETRPostProcessor's num_top_queries
    dec_layers: int = 6
    dec_points: int = 4
    dec_ffn: int = 1024
    eval_idx: int = -1
    anchor_eps: float = 1e-2
    grid_size: float = 0.05
    strides: tuple = (8, 16, 32)

    @property
    def feat_channels(self) -> tuple:
        return tuple(4 * w for w in self.widths[1:])

    @property
    def spatial_shapes(self) -> list:
        return [(self.input_size // s, self.input_size // s) for s in self.strides]


R50 = RTDETRConfig()


def get_activation(act: str | None) -> nn.Module:
    if act is None:
        return nn.Identity()
    return {"relu": nn.ReLU(), "silu": nn.SiLU(), "gelu": nn.GELU()}[act]


# --- backbone: PResNet-50-vd (presnet.py) --------------------------------


class FrozenBatchNorm2d(nn.Module):
    """BatchNorm with fixed statistics and affine, as the affine map
    x * scale + (bias - mean * scale), scale = weight / sqrt(var + eps)."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        for name, init in (("weight", torch.ones), ("bias", torch.zeros),
                           ("running_mean", torch.zeros), ("running_var", torch.ones)):
            self.register_buffer(name, init(num_features))
        self.eps = eps

    def forward(self, x):
        scale = self.weight.reshape(1, -1, 1, 1) * (
            self.running_var.reshape(1, -1, 1, 1) + self.eps).rsqrt()
        bias = self.bias.reshape(1, -1, 1, 1) - self.running_mean.reshape(1, -1, 1, 1) * scale
        return x * scale + bias


class ConvNormLayer(nn.Module):
    """Conv (padding (k - 1) // 2 unless given), norm, activation."""

    def __init__(self, ch_in, ch_out, kernel_size, stride, padding=None, bias=False, act=None,
                 frozen=False):
        super().__init__()
        pad = (kernel_size - 1) // 2 if padding is None else padding
        self.conv = nn.Conv2d(ch_in, ch_out, kernel_size, stride, padding=pad, bias=bias)
        self.norm = FrozenBatchNorm2d(ch_out) if frozen else nn.BatchNorm2d(ch_out)
        self.act = get_activation(act)

    def forward(self, x):
        return self.act(self.norm(self.conv(x)))


class BottleNeck(nn.Module):
    """Variant d: the stride on the 3x3 conv; a strided shortcut pools
    2x2 (ceil mode) before its 1x1 conv."""

    expansion = 4

    def __init__(self, ch_in, ch_out, stride, shortcut):
        super().__init__()
        self.branch2a = ConvNormLayer(ch_in, ch_out, 1, 1, act="relu", frozen=True)
        self.branch2b = ConvNormLayer(ch_out, ch_out, 3, stride, act="relu", frozen=True)
        self.branch2c = ConvNormLayer(ch_out, ch_out * self.expansion, 1, 1, frozen=True)
        self.shortcut = shortcut
        if not shortcut:
            conv = ConvNormLayer(ch_in, ch_out * self.expansion, 1, 1, frozen=True)
            self.short = (nn.Sequential(OrderedDict([
                ("pool", nn.AvgPool2d(2, 2, 0, ceil_mode=True)), ("conv", conv)]))
                if stride == 2 else conv)

    def forward(self, x):
        out = self.branch2c(self.branch2b(self.branch2a(x)))
        short = x if self.shortcut else self.short(x)
        return F.relu(out + short)


class Blocks(nn.Module):
    def __init__(self, ch_in, ch_out, count, stage_num):
        super().__init__()
        self.blocks = nn.ModuleList()
        for i in range(count):
            self.blocks.append(BottleNeck(ch_in, ch_out, 2 if i == 0 and stage_num != 2 else 1,
                                          shortcut=i != 0))
            ch_in = ch_out * BottleNeck.expansion

    def forward(self, x):
        for block in self.blocks:
            x = block(x)
        return x


class PResNet(nn.Module):
    """The stem, the max pool and four stages; returns stages 2-4 (return_idx
    [1, 2, 3]): strides 8, 16, 32."""

    def __init__(self, cfg: RTDETRConfig = R50):
        super().__init__()
        c = cfg.stem
        self.conv1 = nn.Sequential(OrderedDict([
            (name, ConvNormLayer(i, o, 3, s, act="relu", frozen=True))
            for i, o, s, name in ((3, c // 2, 2, "conv1_1"), (c // 2, c // 2, 1, "conv1_2"),
                                  (c // 2, c, 1, "conv1_3"))]))
        self.res_layers = nn.ModuleList()
        ch_in = c
        for i, (count, width) in enumerate(zip(cfg.blocks, cfg.widths)):
            self.res_layers.append(Blocks(ch_in, width, count, i + 2))
            ch_in = width * BottleNeck.expansion

    def forward(self, x):
        x = F.max_pool2d(self.conv1(x), kernel_size=3, stride=2, padding=1)
        outs = []
        for idx, stage in enumerate(self.res_layers):
            x = stage(x)
            if idx >= 1:
                outs.append(x)
        return outs


# --- hybrid encoder (hybrid_encoder.py) -----------------------------------


class MultiheadAttention(nn.Module):
    """nn.MultiheadAttention's parameters and its explicit path
    (need_weights=True, batch first, no dropout): packed in-projection, q
    scaled by 1 / sqrt(head_dim), softmax(q k^T) v, out-projection."""

    def __init__(self, embed_dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim))
        self.out_proj = nn.Linear(embed_dim, embed_dim)

    def forward(self, query, key, value):
        b, lq, e = query.shape
        hd = e // self.num_heads
        wq, wk, wv = self.in_proj_weight.chunk(3)
        bq, bk, bv = self.in_proj_bias.chunk(3)

        def heads(x, w, bias):
            return F.linear(x, w, bias).reshape(b, -1, self.num_heads, hd).transpose(1, 2)

        q, k, v = heads(query, wq, bq), heads(key, wk, bk), heads(value, wv, bv)
        attn = torch.softmax((q * math.sqrt(1.0 / hd)) @ k.transpose(-2, -1), dim=-1)
        out = (attn @ v).transpose(1, 2).reshape(b, lq, e)
        return self.out_proj(out)


class TransformerEncoderLayer(nn.Module):
    """Post-norm: x + attn(x + pos, x + pos, x), norm; + FFN, norm."""

    def __init__(self, d_model, nhead, dim_feedforward, activation):
        super().__init__()
        self.self_attn = MultiheadAttention(d_model, nhead)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm1 = nn.LayerNorm(d_model)
        self.norm2 = nn.LayerNorm(d_model)
        self.activation = get_activation(activation)

    def forward(self, src, pos_embed):
        q = k = src + pos_embed
        src = self.norm1(src + self.self_attn(q, k, src))
        return self.norm2(src + self.linear2(self.activation(self.linear1(src))))


class TransformerEncoder(nn.Module):
    def __init__(self, layer_args, num_layers):
        super().__init__()
        self.layers = nn.ModuleList([TransformerEncoderLayer(*layer_args)
                                     for _ in range(num_layers)])

    def forward(self, src, pos_embed):
        for layer in self.layers:
            src = layer(src, pos_embed)
        return src


class RepVggBlock(nn.Module):
    def __init__(self, ch_in, ch_out, act="silu"):
        super().__init__()
        self.conv1 = ConvNormLayer(ch_in, ch_out, 3, 1, padding=1)
        self.conv2 = ConvNormLayer(ch_in, ch_out, 1, 1, padding=0)
        self.act = get_activation(act)

    def forward(self, x):
        return self.act(self.conv1(x) + self.conv2(x))


class CSPRepLayer(nn.Module):
    def __init__(self, in_channels, out_channels, num_blocks=3, expansion=1.0, act="silu"):
        super().__init__()
        hidden = int(out_channels * expansion)
        self.conv1 = ConvNormLayer(in_channels, hidden, 1, 1, act=act)
        self.conv2 = ConvNormLayer(in_channels, hidden, 1, 1, act=act)
        self.bottlenecks = nn.Sequential(*[RepVggBlock(hidden, hidden, act) for _ in range(num_blocks)])
        self.conv3 = (ConvNormLayer(hidden, out_channels, 1, 1, act=act)
                      if hidden != out_channels else nn.Identity())

    def forward(self, x):
        return self.conv3(self.bottlenecks(self.conv1(x)) + self.conv2(x))


def sincos_position_embedding(w: int, h: int, embed_dim: int, temperature: float):
    """upstream's build_2d_sincos_position_embedding, (1, w * h, embed_dim)
    (its meshgrid walks w first)."""
    grid_w, grid_h = torch.meshgrid(torch.arange(int(w), dtype=torch.float32),
                                    torch.arange(int(h), dtype=torch.float32), indexing="ij")
    pos_dim = embed_dim // 4
    omega = 1.0 / (temperature ** (torch.arange(pos_dim, dtype=torch.float32) / pos_dim))
    out_w = grid_w.flatten()[..., None] @ omega[None]
    out_h = grid_h.flatten()[..., None] @ omega[None]
    return torch.concat([out_w.sin(), out_w.cos(), out_h.sin(), out_h.cos()], dim=1)[None]


class HybridEncoder(nn.Module):
    """AIFI on the stride-32 map (use_encoder_idx [2], one layer), then
    CCFM's top-down and bottom-up fusion; three maps of hidden_dim."""

    def __init__(self, cfg: RTDETRConfig = R50):
        super().__init__()
        hd = cfg.hidden_dim
        self.input_proj = nn.ModuleList([
            nn.Sequential(nn.Conv2d(c, hd, kernel_size=1, bias=False), nn.BatchNorm2d(hd))
            for c in cfg.feat_channels])
        self.encoder = nn.ModuleList([
            TransformerEncoder((hd, cfg.nhead, cfg.enc_ffn, "gelu"), 1)])
        n = len(cfg.feat_channels)
        self.lateral_convs = nn.ModuleList([ConvNormLayer(hd, hd, 1, 1, act="silu")
                                            for _ in range(n - 1)])
        self.fpn_blocks = nn.ModuleList([
            CSPRepLayer(2 * hd, hd, cfg.csp_blocks, cfg.expansion) for _ in range(n - 1)])
        self.downsample_convs = nn.ModuleList([ConvNormLayer(hd, hd, 3, 2, act="silu")
                                               for _ in range(n - 1)])
        self.pan_blocks = nn.ModuleList([
            CSPRepLayer(2 * hd, hd, cfg.csp_blocks, cfg.expansion) for _ in range(n - 1)])
        s = cfg.input_size // cfg.strides[-1]
        self.register_buffer("pos_embed2", sincos_position_embedding(
            s, s, hd, cfg.pe_temperature), persistent=False)
        self.hidden_dim = hd

    def forward(self, feats):
        proj = [p(f) for p, f in zip(self.input_proj, feats)]
        h, w = proj[-1].shape[2:]
        memory = self.encoder[0](proj[-1].flatten(2).permute(0, 2, 1), self.pos_embed2)
        proj[-1] = memory.permute(0, 2, 1).reshape(-1, self.hidden_dim, h, w).contiguous()
        n = len(proj)
        inner = [proj[-1]]
        for idx in range(n - 1, 0, -1):
            high = self.lateral_convs[n - 1 - idx](inner[0])
            inner[0] = high
            up = F.interpolate(high, scale_factor=2.0, mode="nearest")
            inner.insert(0, self.fpn_blocks[n - 1 - idx](torch.concat([up, proj[idx - 1]], dim=1)))
        outs = [inner[0]]
        for idx in range(n - 1):
            down = self.downsample_convs[idx](outs[-1])
            outs.append(self.pan_blocks[idx](torch.concat([down, inner[idx + 1]], dim=1)))
        return outs


# --- decoder (rtdetr_decoder.py) ------------------------------------------


class MLP(nn.Module):
    def __init__(self, input_dim, hidden_dim, output_dim, num_layers):
        super().__init__()
        h = [hidden_dim] * (num_layers - 1)
        self.layers = nn.ModuleList(nn.Linear(n, k) for n, k in zip([input_dim] + h, h + [output_dim]))

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = F.relu(layer(x)) if i < len(self.layers) - 1 else layer(x)
        return x


class MSDeformableAttention(nn.Module):
    """Offsets and attention logits from the query, the value projected
    from the memory, the core (K11 on the card, `ms_deformable_attn_core`),
    the output projection."""

    def __init__(self, embed_dim=256, num_heads=8, num_levels=3, num_points=4):
        super().__init__()
        self.num_heads, self.num_levels, self.num_points = num_heads, num_levels, num_points
        total = num_heads * num_levels * num_points
        self.sampling_offsets = nn.Linear(embed_dim, total * 2)
        self.attention_weights = nn.Linear(embed_dim, total)
        self.value_proj = nn.Linear(embed_dim, embed_dim)
        self.output_proj = nn.Linear(embed_dim, embed_dim)
        self.ms_deformable_attn_core = msda_kernel.ms_deform_attn

    def forward(self, query, reference_boxes, value, spatial_shapes):
        b, lv = value.shape[:2]
        value = self.value_proj(value).reshape(b, lv, self.num_heads, -1)
        out = self.ms_deformable_attn_core(
            value, spatial_shapes, reference_boxes, self.sampling_offsets(query),
            self.attention_weights(query), self.num_levels, self.num_points)
        return self.output_proj(out)


class TransformerDecoderLayer(nn.Module):
    def __init__(self, d_model, n_head, dim_feedforward, n_levels, n_points):
        super().__init__()
        self.self_attn = MultiheadAttention(d_model, n_head)
        self.norm1 = nn.LayerNorm(d_model)
        self.cross_attn = MSDeformableAttention(d_model, n_head, n_levels, n_points)
        self.norm2 = nn.LayerNorm(d_model)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm3 = nn.LayerNorm(d_model)

    def forward(self, tgt, reference_boxes, memory, spatial_shapes, query_pos_embed):
        q = k = tgt + query_pos_embed
        tgt = self.norm1(tgt + self.self_attn(q, k, tgt))
        tgt = self.norm2(tgt + self.cross_attn(tgt + query_pos_embed, reference_boxes, memory,
                                               spatial_shapes))
        return self.norm3(tgt + self.linear2(F.relu(self.linear1(tgt))))


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x = x.clip(min=0.0, max=1.0)
    return torch.log(x.clip(min=eps) / (1 - x).clip(min=eps))


class TransformerDecoder(nn.Module):
    def __init__(self, layer_args, num_layers, eval_idx=-1):
        super().__init__()
        self.layers = nn.ModuleList([TransformerDecoderLayer(*layer_args)
                                     for _ in range(num_layers)])
        self.eval_idx = eval_idx if eval_idx >= 0 else num_layers + eval_idx

    def forward(self, tgt, ref_points_unact, memory, spatial_shapes, bbox_head, score_head,
                query_pos_head):
        """The eval path: (logits, boxes) of layer eval_idx."""
        output = tgt
        ref = torch.sigmoid(ref_points_unact)
        for i, layer in enumerate(self.layers):
            output = layer(output, ref, memory, spatial_shapes, query_pos_head(ref))
            ref = torch.sigmoid(bbox_head[i](output) + inverse_sigmoid(ref))
            if i == self.eval_idx:
                return score_head[i](output), ref
        raise ValueError(f"eval_idx {self.eval_idx} outside {len(self.layers)} layers")


class Selection(NamedTuple):
    """What query selection hands the decoder, and what it ranked."""

    memory: torch.Tensor  # (B, Lv, hidden): the decoder's value source
    spatial_shapes: list  # [(h, w)] a level
    target: torch.Tensor  # (B, Q, hidden): the selected tokens of enc_output
    ref_unact: torch.Tensor  # (B, Q, 4): their boxes before the sigmoid
    scores: torch.Tensor  # (B, Lv): each token's largest class logit
    indices: torch.Tensor  # (B, Q): the tokens selected


class RTDETRTransformer(nn.Module):
    """The decoder's input projections, query selection (`select`) and the
    decoder (`decode`), at the configured input size (the anchors, the
    valid mask and AIFI's position embedding are built for it)."""

    def __init__(self, cfg: RTDETRConfig = R50):
        super().__init__()
        hd, nc = cfg.hidden_dim, cfg.num_classes
        self.num_queries = cfg.num_queries
        self.anchor_eps = cfg.anchor_eps
        self.grid_size = cfg.grid_size
        self.input_proj = nn.ModuleList([
            nn.Sequential(OrderedDict([("conv", nn.Conv2d(hd, hd, 1, bias=False)),
                                       ("norm", nn.BatchNorm2d(hd))]))
            for _ in cfg.strides])
        self.decoder = TransformerDecoder(
            (hd, cfg.nhead, cfg.dec_ffn, len(cfg.strides), cfg.dec_points), cfg.dec_layers,
            cfg.eval_idx)
        self.denoising_class_embed = nn.Embedding(nc + 1, hd, padding_idx=nc)
        self.query_pos_head = MLP(4, 2 * hd, hd, num_layers=2)
        self.enc_output = nn.Sequential(nn.Linear(hd, hd), nn.LayerNorm(hd))
        self.enc_score_head = nn.Linear(hd, nc)
        self.enc_bbox_head = MLP(hd, hd, 4, num_layers=3)
        self.dec_score_head = nn.ModuleList([nn.Linear(hd, nc) for _ in range(cfg.dec_layers)])
        self.dec_bbox_head = nn.ModuleList([MLP(hd, hd, 4, num_layers=3)
                                            for _ in range(cfg.dec_layers)])
        anchors, valid = self.generate_anchors(cfg.spatial_shapes)
        self.register_buffer("anchors", anchors, persistent=False)
        self.register_buffer("valid_mask", valid, persistent=False)

    def generate_anchors(self, spatial_shapes):
        """(1, Lv, 4) anchors in logit space (inf where not valid) and the
        (1, Lv, 1) valid mask."""
        anchors = []
        for lvl, (h, w) in enumerate(spatial_shapes):
            gy, gx = torch.meshgrid(torch.arange(end=h, dtype=torch.float32),
                                    torch.arange(end=w, dtype=torch.float32), indexing="ij")
            xy = (torch.stack([gx, gy], -1).unsqueeze(0) + 0.5) / torch.tensor([w, h],
                                                                             dtype=torch.float32)
            wh = torch.ones_like(xy) * self.grid_size * (2.0 ** lvl)
            anchors.append(torch.concat([xy, wh], -1).reshape(-1, h * w, 4))
        anchors = torch.concat(anchors, 1)
        eps = self.anchor_eps
        valid = ((anchors > eps) * (anchors < 1 - eps)).all(-1, keepdim=True)
        anchors = torch.log(anchors / (1 - anchors))
        return torch.where(valid, anchors, torch.inf), valid

    def select(self, feats) -> Selection:
        proj = [p(f) for p, f in zip(self.input_proj, feats)]
        shapes = [tuple(f.shape[2:]) for f in proj]
        memory = torch.concat([f.flatten(2).permute(0, 2, 1) for f in proj], 1)
        output_memory = self.enc_output(self.valid_mask.to(memory.dtype) * memory)
        enc_class = self.enc_score_head(output_memory)
        coord_unact = self.enc_bbox_head(output_memory) + self.anchors
        scores = enc_class.max(-1).values
        _, idx = torch.topk(scores, self.num_queries, dim=1)
        ref_unact = coord_unact.gather(1, idx.unsqueeze(-1).repeat(1, 1, coord_unact.shape[-1]))
        target = output_memory.gather(1, idx.unsqueeze(-1).repeat(1, 1, output_memory.shape[-1]))
        return Selection(memory, shapes, target, ref_unact, scores, idx)

    def decode(self, sel: Selection):
        return self.decoder(sel.target, sel.ref_unact, sel.memory, sel.spatial_shapes,
                            self.dec_bbox_head, self.dec_score_head, self.query_pos_head)


class RTDETR(nn.Module):
    """backbone -> encoder -> decoder, with the tracer's spans
    `rtdetr.backbone`, `.encoder`, `.select`, `.decoder`.

    forward takes (B, S, S, 3) RGB in [0, 1] and returns a dict: memory
    (B, Lv, hidden), scores (B, Lv), indices (B, Q), logits (B, Q,
    classes), boxes (B, Q, 4) cx cy w h in [0, 1]."""

    def __init__(self, cfg: RTDETRConfig = R50):
        super().__init__()
        self.cfg = cfg
        self.backbone = PResNet(cfg)
        self.encoder = HybridEncoder(cfg)
        self.decoder = RTDETRTransformer(cfg)

    def encode(self, feats) -> Selection:
        """The hybrid encoder through query selection."""
        with trace.span("rtdetr.encoder"):
            feats = self.encoder(feats)
        with trace.span("rtdetr.select"):
            return self.decoder.select(feats)

    def decode(self, sel: Selection):
        """The decoder's layers: (logits, boxes) of the last."""
        with trace.span("rtdetr.decoder"):
            return self.decoder.decode(sel)

    def forward(self, x):
        x = x.permute(0, 3, 1, 2).contiguous()
        with trace.span("rtdetr.backbone"):
            feats = self.backbone(x)
        sel = self.encode(feats)
        logits, boxes = self.decode(sel)
        return {"memory": sel.memory, "scores": sel.scores, "indices": sel.indices,
                "logits": logits, "boxes": boxes}


def postprocess(outputs, num_classes: int = 80, input_size: int = 640,
                score_threshold: float = 0.25, num_top: int = 300):
    """RTDETRPostProcessor (focal loss) in network-input pixels: sigmoid
    over the logits, the top `num_top` of the flattened scores, label =
    index mod classes, the query's box from cx cy w h to x1 y1 x2 y2 times
    the input size. Returns (ltwh (B, K, 4), scores (B, K), classes (B,
    K) int32, valid (B, K) bool: score > score_threshold), K = num_top
    (or every score, where fewer), as YoloDetector.boxrecs takes them."""
    logits, boxes = outputs["logits"], outputs["boxes"]
    cx, cy, w, h = boxes.unbind(-1)
    xyxy = torch.stack([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w, cy + 0.5 * h], -1) * input_size
    flat = torch.sigmoid(logits).flatten(1)
    scores, index = torch.topk(flat, min(num_top, flat.shape[1]), dim=-1)
    labels = index % num_classes
    picked = xyxy.gather(1, (index // num_classes).unsqueeze(-1).repeat(1, 1, 4))
    ltwh = torch.concat([picked[..., :2], picked[..., 2:] - picked[..., :2]], -1)
    return ltwh, scores, labels.to(torch.int32), scores > score_threshold


def make_rtdetr_detector(weights_path=None, cfg: RTDETRConfig = R50,
                         score_threshold: float = 0.25, device="cuda", state_dict=None):
    """A CovaPipeline oracle: RT-DETR on `device` in the shared wrapper
    (models/yolov4.py `YoloDetector`: the planes' upload, preprocess_frames
    to cfg.input_size, the network, `postprocess`, BoxRecs in frame
    pixels). Weights from a state dict file `weights_path` or the
    `state_dict` given (upstream's names); with neither, the model's
    PyTorch initialisation. On CUDA, TF32 is turned off process wide
    (pipeline.compressed.exact_float32)."""
    from cova_tpu_torch.models.yolov4 import YoloDetector
    from cova_tpu_torch.pipeline.compressed import exact_float32

    exact_float32(device)
    model = RTDETR(cfg)
    if weights_path is not None:
        state_dict = torch.load(weights_path, map_location="cpu", weights_only=True)
    if state_dict is not None:
        model.load_state_dict(state_dict)

    def post(outs):
        return postprocess(outs, cfg.num_classes, cfg.input_size, score_threshold, cfg.num_top)

    return YoloDetector(model.to(device).eval(), post, cfg.input_size, device)

"""The plain reference of RT-DETR (arXiv:2304.08069; lyuwenyu/RT-DETR,
rtdetr_pytorch/configs/rtdetr/rtdetr_r50vd_6x_coco.yml): the eval
forward of PResNet-vd, HybridEncoder and RTDETRTransformer, and
RTDETRPostProcessor with focal loss, as plain torch functions over a
state dict in upstream's parameter names, in float32. It imports nothing
of the program; the same file lies in tests/ and in bench_port/ref/.

Widths come from the state dict's shapes; the counts that shapes do not
give (heads, points, queries, input size, the anchors' grid and eps, the
position embedding's temperature, the strides) from `conf`, a dict with
the keys of the configuration's `oracle` entry.

It follows the published modules, with these departures:
- no denoising queries and no auxiliary heads (training only): the
  decoder stops at eval_idx, the last layer;
- frozen BN (the backbone) is FrozenBatchNorm2d's affine map; the
  encoder's and the decoder's BatchNorm2d use their running statistics
  (eval mode);
- nn.MultiheadAttention is written out as its explicit path (packed
  in-projection, q scaled by 1 / sqrt(head_dim), softmax, out-projection);
- the frame's conversion: BT.601 limited-range YUV to RGB in [0, 1],
  chroma repeated, then an antialiased bilinear resize to the square
  input, no letterbox and no mean or std (the CoVA oracle's
  preprocessing; upstream's transforms resize the same way);
- the query selection can be given its tokens (`decode(..., indices)`),
  so that a decoder is compared given what it received;
- `calibrated` sets BatchNorm's running statistics from one picture, for
  seeded weights that stand in for a trained state dict.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

BN_EPS = 1e-5


def exact() -> None:
    """float32 matrix products and convolutions in full float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def to_input(y, u, v, size: int) -> torch.Tensor:
    """I420 planes (uint8 tensors) -> (1, 3, size, size) RGB in [0, 1]."""
    h, w = y.shape
    uf = u.float().repeat_interleave(2, 0).repeat_interleave(2, 1)[:h, :w] - 128.0
    vf = v.float().repeat_interleave(2, 0).repeat_interleave(2, 1)[:h, :w] - 128.0
    yf = y.float() - 16.0
    rgb = torch.stack([1.164 * yf + 1.596 * vf,
                       1.164 * yf - 0.392 * uf - 0.813 * vf,
                       1.164 * yf + 2.017 * uf]) / 255.0
    rgb = rgb.clamp(0.0, 1.0)
    return F.interpolate(rgb[None], size=(size, size), mode="bilinear", align_corners=False,
                         antialias=True)


class RTDETR:
    def __init__(self, sd: dict, conf: dict):
        exact()
        self.p = sd
        self.conf = conf
        self.nhead = conf["nhead"]
        self.points = conf["dec_points"]
        self.levels = len(conf["strides"])

    # --- layers -----------------------------------------------------------

    def conv_norm(self, x, key, stride=1, padding=None, act=None, frozen=False):
        w = self.p[f"{key}.conv.weight"]
        k = w.shape[-1]
        x = F.conv2d(x, w, self.p.get(f"{key}.conv.bias"), stride,
                     (k - 1) // 2 if padding is None else padding)
        x = self.frozen_bn(x, f"{key}.norm") if frozen else self.bn(x, f"{key}.norm")
        return {"relu": F.relu, "silu": F.silu, None: lambda t: t}[act](x)

    def frozen_bn(self, x, key):
        scale = self.p[f"{key}.weight"].reshape(1, -1, 1, 1) * (
            self.p[f"{key}.running_var"].reshape(1, -1, 1, 1) + BN_EPS).rsqrt()
        bias = self.p[f"{key}.bias"].reshape(1, -1, 1, 1) - \
            self.p[f"{key}.running_mean"].reshape(1, -1, 1, 1) * scale
        return x * scale + bias

    def bn(self, x, key):
        return F.batch_norm(x, self.p[f"{key}.running_mean"], self.p[f"{key}.running_var"],
                            self.p[f"{key}.weight"], self.p[f"{key}.bias"], False, 0.0, BN_EPS)

    def linear(self, x, key):
        return F.linear(x, self.p[f"{key}.weight"], self.p[f"{key}.bias"])

    def layer_norm(self, x, key):
        return F.layer_norm(x, x.shape[-1:], self.p[f"{key}.weight"], self.p[f"{key}.bias"])

    def mlp(self, x, key):
        n = sum(1 for k in self.p if k.startswith(f"{key}.layers.") and k.endswith(".weight"))
        for i in range(n):
            x = self.linear(x, f"{key}.layers.{i}")
            if i < n - 1:
                x = F.relu(x)
        return x

    def attention(self, q, k, v, key):
        b, lq, e = q.shape
        hd = e // self.nhead
        wq, wk, wv = self.p[f"{key}.in_proj_weight"].chunk(3)
        bq, bk, bv = self.p[f"{key}.in_proj_bias"].chunk(3)

        def heads(x, w, bias):
            return F.linear(x, w, bias).reshape(b, -1, self.nhead, hd).transpose(1, 2)

        q, k, v = heads(q, wq, bq), heads(k, wk, bk), heads(v, wv, bv)
        attn = torch.softmax((q * math.sqrt(1.0 / hd)) @ k.transpose(-2, -1), dim=-1)
        return self.linear((attn @ v).transpose(1, 2).reshape(b, lq, e), f"{key}.out_proj")

    # --- backbone: PResNet-vd ---------------------------------------------

    def backbone(self, x):
        for name in ("conv1_1", "conv1_2", "conv1_3"):
            x = self.conv_norm(x, f"backbone.conv1.{name}", 2 if name == "conv1_1" else 1,
                               act="relu", frozen=True)
        x = F.max_pool2d(x, kernel_size=3, stride=2, padding=1)
        outs = []
        for stage in range(4):
            b = 0
            while f"backbone.res_layers.{stage}.blocks.{b}.branch2a.conv.weight" in self.p:
                key = f"backbone.res_layers.{stage}.blocks.{b}"
                stride = 2 if b == 0 and stage != 0 else 1
                out = self.conv_norm(x, f"{key}.branch2a", act="relu", frozen=True)
                out = self.conv_norm(out, f"{key}.branch2b", stride, act="relu", frozen=True)
                out = self.conv_norm(out, f"{key}.branch2c", frozen=True)
                if b == 0 and stride == 2:
                    short = self.conv_norm(F.avg_pool2d(x, 2, 2, 0, ceil_mode=True),
                                           f"{key}.short.conv", frozen=True)
                elif b == 0:
                    short = self.conv_norm(x, f"{key}.short", frozen=True)
                else:
                    short = x
                x = F.relu(out + short)
                b += 1
            if stage >= 1:
                outs.append(x)
        return outs

    # --- hybrid encoder ---------------------------------------------------

    def pos_embed(self, w, h, dim):
        grid_w, grid_h = torch.meshgrid(torch.arange(int(w), dtype=torch.float32),
                                        torch.arange(int(h), dtype=torch.float32),
                                        indexing="ij")
        pos_dim = dim // 4
        omega = 1.0 / (self.conf["pe_temperature"] **
                       (torch.arange(pos_dim, dtype=torch.float32) / pos_dim))
        out_w = grid_w.flatten()[..., None] @ omega[None]
        out_h = grid_h.flatten()[..., None] @ omega[None]
        return torch.concat([out_w.sin(), out_w.cos(), out_h.sin(), out_h.cos()], dim=1)[None]

    def csp_rep(self, x, key):
        x1 = self.conv_norm(x, f"{key}.conv1", act="silu")
        b = 0
        while f"{key}.bottlenecks.{b}.conv1.conv.weight" in self.p:
            k = f"{key}.bottlenecks.{b}"
            x1 = F.silu(self.conv_norm(x1, f"{k}.conv1", padding=1) +
                        self.conv_norm(x1, f"{k}.conv2", padding=0))
            b += 1
        out = x1 + self.conv_norm(x, f"{key}.conv2", act="silu")
        if f"{key}.conv3.conv.weight" in self.p:
            out = self.conv_norm(out, f"{key}.conv3", act="silu")
        return out

    def encoder(self, feats):
        proj = []
        for i, f in enumerate(feats):
            x = F.conv2d(f, self.p[f"encoder.input_proj.{i}.0.weight"])
            proj.append(self.bn(x, f"encoder.input_proj.{i}.1"))
        dim, h, w = proj[-1].shape[1:]
        src = proj[-1].flatten(2).permute(0, 2, 1)
        q = k = src + self.pos_embed(w, h, dim).to(src.device)
        key = "encoder.encoder.0.layers.0"
        src = self.layer_norm(src + self.attention(q, k, src, f"{key}.self_attn"), f"{key}.norm1")
        ffn = self.linear(F.gelu(self.linear(src, f"{key}.linear1")), f"{key}.linear2")
        src = self.layer_norm(src + ffn, f"{key}.norm2")
        proj[-1] = src.permute(0, 2, 1).reshape(-1, dim, h, w).contiguous()
        n = len(proj)
        inner = [proj[-1]]
        for idx in range(n - 1, 0, -1):
            high = self.conv_norm(inner[0], f"encoder.lateral_convs.{n - 1 - idx}", act="silu")
            inner[0] = high
            up = F.interpolate(high, scale_factor=2.0, mode="nearest")
            inner.insert(0, self.csp_rep(torch.concat([up, proj[idx - 1]], 1),
                                         f"encoder.fpn_blocks.{n - 1 - idx}"))
        outs = [inner[0]]
        for idx in range(n - 1):
            down = self.conv_norm(outs[-1], f"encoder.downsample_convs.{idx}", 2, act="silu")
            outs.append(self.csp_rep(torch.concat([down, inner[idx + 1]], 1),
                                     f"encoder.pan_blocks.{idx}"))
        return outs

    # --- query selection and decoder --------------------------------------

    def memory(self, maps):
        """(1, Lv, hidden) tokens of the decoder's projected maps, and
        their (h, w) a level."""
        flat, shapes = [], []
        for i, m in enumerate(maps):
            x = F.conv2d(m, self.p[f"decoder.input_proj.{i}.conv.weight"])
            x = self.bn(x, f"decoder.input_proj.{i}.norm")
            shapes.append(tuple(x.shape[2:]))
            flat.append(x.flatten(2).permute(0, 2, 1))
        return torch.concat(flat, 1), shapes

    def anchors(self, shapes, device):
        out = []
        for lvl, (h, w) in enumerate(shapes):
            gy, gx = torch.meshgrid(torch.arange(end=h, dtype=torch.float32),
                                    torch.arange(end=w, dtype=torch.float32), indexing="ij")
            xy = (torch.stack([gx, gy], -1).unsqueeze(0) + 0.5) / torch.tensor(
                [w, h], dtype=torch.float32)
            wh = torch.ones_like(xy) * self.conf["grid_size"] * (2.0 ** lvl)
            out.append(torch.concat([xy, wh], -1).reshape(-1, h * w, 4))
        anchors = torch.concat(out, 1)
        eps = self.conf["anchor_eps"]
        valid = ((anchors > eps) * (anchors < 1 - eps)).all(-1, keepdim=True)
        anchors = torch.log(anchors / (1 - anchors))
        return torch.where(valid, anchors, torch.inf).to(device), valid.to(device)

    def select(self, memory, shapes):
        """enc_output over the valid tokens, the heads, and the top
        num_queries by largest class logit: a dict of output_memory,
        coord_unact, scores (1, Lv), indices (1, Q)."""
        anchors, valid = self.anchors(shapes, memory.device)
        out_mem = self.layer_norm(self.linear(valid.to(memory.dtype) * memory,
                                              "decoder.enc_output.0"), "decoder.enc_output.1")
        scores = self.linear(out_mem, "decoder.enc_score_head").max(-1).values
        coord = self.mlp(out_mem, "decoder.enc_bbox_head") + anchors
        _, idx = torch.topk(scores, self.conf["num_queries"], dim=1)
        return {"output_memory": out_mem, "coord_unact": coord, "scores": scores, "indices": idx}

    def deformable_attention(self, query, boxes, memory, shapes, key):
        b, lv = memory.shape[:2]
        lq = query.shape[1]
        h, nl, npt = self.nhead, self.levels, self.points
        value = self.linear(memory, f"{key}.value_proj").reshape(b, lv, h, -1)
        offsets = self.linear(query, f"{key}.sampling_offsets").reshape(b, lq, h, nl, npt, 2)
        weights = F.softmax(self.linear(query, f"{key}.attention_weights").reshape(
            b, lq, h, nl * npt), dim=-1).reshape(b, lq, h, nl, npt)
        ref = boxes[:, :, None, :]
        loc = ref[:, :, None, :, None, :2] + offsets / npt * ref[:, :, None, :, None, 2:] * 0.5
        # utils.deformable_attention_core_func
        c = value.shape[-1]
        values = value.split([hh * ww for hh, ww in shapes], dim=1)
        grids = 2 * loc - 1
        sampled = []
        for level, (hh, ww) in enumerate(shapes):
            v = values[level].flatten(2).permute(0, 2, 1).reshape(b * h, c, hh, ww)
            g = grids[:, :, :, level].permute(0, 2, 1, 3, 4).flatten(0, 1)
            sampled.append(F.grid_sample(v, g, mode="bilinear", padding_mode="zeros",
                                         align_corners=False))
        weights = weights.permute(0, 2, 1, 3, 4).reshape(b * h, 1, lq, nl * npt)
        out = (torch.stack(sampled, dim=-2).flatten(-2) * weights).sum(-1)
        out = out.reshape(b, h * c, lq).permute(0, 2, 1)
        return self.linear(out, f"{key}.output_proj")

    def decode(self, memory, shapes, sel, indices):
        """The decoder from the queries at `indices` (1, Q) of the
        selection `sel`: the last layer's (logits, boxes)."""
        idx = indices.unsqueeze(-1)
        target = sel["output_memory"].gather(1, idx.repeat(1, 1, sel["output_memory"].shape[-1]))
        ref = torch.sigmoid(sel["coord_unact"].gather(1, idx.repeat(1, 1, 4)))
        n = sum(1 for k in self.p if k.startswith("decoder.dec_score_head.") and
                k.endswith(".weight"))
        out = target
        for i in range(n):
            key = f"decoder.decoder.layers.{i}"
            pos = self.mlp(ref, "decoder.query_pos_head")
            q = k = out + pos
            out = self.layer_norm(out + self.attention(q, k, out, f"{key}.self_attn"),
                                  f"{key}.norm1")
            out = self.layer_norm(out + self.deformable_attention(out + pos, ref, memory, shapes,
                                                                  f"{key}.cross_attn"),
                                  f"{key}.norm2")
            ffn = self.linear(F.relu(self.linear(out, f"{key}.linear1")), f"{key}.linear2")
            out = self.layer_norm(out + ffn, f"{key}.norm3")
            x = torch.clip(ref, 0.0, 1.0)
            inv = torch.log(x.clip(min=1e-5) / (1 - x).clip(min=1e-5))
            ref = torch.sigmoid(self.mlp(out, f"decoder.dec_bbox_head.{i}") + inv)
        return self.linear(out, f"decoder.dec_score_head.{n - 1}"), ref

    def forward(self, x):
        """The whole eval forward of (1, 3, S, S): a dict of memory,
        scores, indices, logits, boxes."""
        memory, shapes = self.memory(self.encoder(self.backbone(x)))
        sel = self.select(memory, shapes)
        logits, boxes = self.decode(memory, shapes, sel, sel["indices"])
        return {"memory": memory, "scores": sel["scores"], "indices": sel["indices"],
                "logits": logits, "boxes": boxes}


class _Calibration(RTDETR):
    """RTDETR whose BatchNorms first take their input's statistics."""

    def _take(self, x, key):
        self.p[f"{key}.running_mean"] = x.mean((0, 2, 3))
        self.p[f"{key}.running_var"] = x.var((0, 2, 3), unbiased=False)

    def frozen_bn(self, x, key):
        self._take(x, key)
        return super().frozen_bn(x, key)

    def bn(self, x, key):
        self._take(x, key)
        return super().bn(x, key)


@torch.no_grad()
def calibrated(sd: dict, conf: dict, x) -> dict:
    """A copy of `sd` whose BatchNorms' running mean and variance are, in
    the order the forward reaches them, the per-channel mean and (biased)
    variance of their input on the picture `x` (1, 3, S, S), in float32:
    the statistics a trained network's BN holds are its data's. The
    backbone, the encoder and the decoder's input projections run; no
    BatchNorm lies past them."""
    net = _Calibration(dict(sd), conf)
    net.memory(net.encoder(net.backbone(x)))
    return net.p


def postprocess(logits, boxes, frame_hw, num_classes: int, num_top: int,
                score_threshold: float) -> list:
    """RTDETRPostProcessor (focal loss) on one frame's (Q, classes) logits
    and (Q, 4) cx cy w h boxes: sigmoid, the top num_top of the flattened
    scores, label = index mod classes, boxes to frame pixels; kept where
    the score exceeds the threshold. [(class, score, left, top, width,
    height)] in descending score order."""
    h, w = frame_hw
    cx, cy, bw, bh = boxes.unbind(-1)
    xyxy = torch.stack([cx - 0.5 * bw, cy - 0.5 * bh, cx + 0.5 * bw, cy + 0.5 * bh], -1)
    flat = torch.sigmoid(logits).flatten()
    scores, index = torch.topk(flat, min(num_top, flat.numel()))
    labels = index % num_classes
    picked = xyxy[index // num_classes].double().cpu() * torch.tensor([w, h, w, h],
                                                                       dtype=torch.float64)
    out = []
    for s, c, (x1, y1, x2, y2) in zip(scores.tolist(), labels.tolist(), picked.tolist()):
        if s > score_threshold:
            out.append((int(c), float(s), x1, y1, x2 - x1, y2 - y1))
    return out

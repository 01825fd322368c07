"""Darknet .cfg parser + generic graph executor in PyTorch (port of
cova_tpu/models/darknet_cfg.py).

The reference builds its YOLOv4 TensorRT engine from the darknet
cfg/weights pair (reference: config/dnn/yolov4_b2.txt engine built by
third_parties/tensorrt_demos' yolo_to_onnx, which parses yolov4.cfg).
Executing the cfg's layer list directly removes the risk of a silent
drift between the hand-written topology (models/yolov4.py YOLOv4) and the
file the released weights were trained for, and makes other darknet
variants (yolov4-tiny, yolov3, custom) loadable.

Supported sections: [net], [convolutional], [route] (multi-input
concat + groups/group_id), [shortcut], [maxpool], [upsample], [yolo].
The model's layout is the JAX package's: (B, S, S, C) in, raw heads
(B, H, W, 3*(5+C)) out. The cfg files themselves are shared with the JAX
package by path (cova_tpu/models/cfg/).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from cova_tpu_torch.models.yolov4 import (
    ConvBN,
    decode_head,
    init_weights,
    load_darknet_weights,
    max_pool_same,
    select_and_nms,
)


def parse_cfg(path_or_text: str) -> list[dict]:
    """Parse a darknet cfg into a list of {type, **options} dicts (the
    [net] section first, then layers in execution order)."""
    if "\n" in path_or_text or "[" == path_or_text.strip()[:1]:
        text = path_or_text
    else:
        with open(path_or_text) as f:
            text = f.read()
    sections: list[dict] = []
    for raw in text.splitlines():
        line = raw.split("#")[0].split(";")[0].strip()
        if not line:
            continue
        if line.startswith("["):
            sections.append({"type": line.strip("[]").strip()})
        elif "=" in line and sections:
            k, v = line.split("=", 1)
            sections[-1][k.strip()] = v.strip()
    return sections


def _ints(s: str) -> list[int]:
    return [int(x) for x in s.replace(",", " ").split()]


@dataclasses.dataclass(frozen=True)
class YoloHead:
    """One [yolo] section's decode parameters."""

    anchors: tuple  # ((w, h), ...) for this head's mask
    scale_xy: float
    classes: int
    layer_index: int  # which model output this head decodes


class DarknetModel(nn.Module):
    """Executes a parsed darknet cfg. Returns the raw outputs of the
    layers feeding each [yolo] section, in cfg order (the contract of
    YOLOv4.forward: decode with models.yolov4.decode_head). `convs` holds
    one ConvBN per [convolutional] section, in cfg order."""

    def __init__(self, sections: list[dict]):
        super().__init__()
        if not sections or sections[0]["type"] not in ("net", "network"):
            raise ValueError("cfg must start with a [net] section")
        self.sections = [dict(s) for s in sections]
        cur = int(self.sections[0].get("channels", 3))
        chans: list[int] = []  # output channels per darknet layer
        convs = []
        for s in self.sections[1:]:
            t = s["type"]
            if t == "convolutional":
                f = int(s["filters"])
                convs.append(ConvBN(
                    cur, f, int(s.get("size", 1)), int(s.get("stride", 1)),
                    act=s.get("activation", "linear"),
                    bn=int(s.get("batch_normalize", 0)) == 1,
                ))
                cur = f
            elif t == "route":
                idxs = _ints(s["layers"])
                cur = sum(chans[i if i >= 0 else len(chans) + i] for i in idxs)
                cur //= int(s.get("groups", 1))
            elif t == "shortcut":
                if s.get("activation", "linear") not in ("linear", "leaky"):
                    raise ValueError(f"unsupported shortcut act {s['activation']!r}")
            elif t not in ("maxpool", "upsample", "yolo"):
                raise ValueError(f"unsupported section [{t}]")
            chans.append(cur)
        self.convs = nn.ModuleList(convs)
        self.eval()

    @staticmethod
    def from_cfg(path_or_text: str) -> "DarknetModel":
        return DarknetModel(parse_cfg(path_or_text))

    def heads(self) -> list[YoloHead]:
        out = []
        for s in self.sections[1:]:
            if s["type"] != "yolo":
                continue
            anchors = _ints(s["anchors"])
            mask = _ints(s["mask"])
            pairs = [(anchors[2 * m], anchors[2 * m + 1]) for m in mask]
            out.append(
                YoloHead(
                    anchors=tuple(pairs),
                    scale_xy=float(s.get("scale_x_y", 1.0)),
                    classes=int(s.get("classes", 80)),
                    layer_index=len(out),
                )
            )
        return out

    def forward(self, x: torch.Tensor):
        x = x.to(torch.float32).permute(0, 3, 1, 2)
        outputs: list = []  # per darknet layer index
        yolo_outputs: list = []
        ci = 0
        for s in self.sections[1:]:
            t = s["type"]
            if t == "convolutional":
                x = self.convs[ci](x)
                ci += 1
            elif t == "route":
                idxs = _ints(s["layers"])
                srcs = [outputs[i if i >= 0 else len(outputs) + i] for i in idxs]
                x = srcs[0] if len(srcs) == 1 else torch.cat(srcs, dim=1)
                groups = int(s.get("groups", 1))
                if groups > 1:
                    gid = int(s.get("group_id", 0))
                    step = x.shape[1] // groups
                    x = x[:, gid * step : (gid + 1) * step]
            elif t == "shortcut":
                i = int(s["from"])
                x = x + outputs[i if i >= 0 else len(outputs) + i]
                if s.get("activation", "linear") == "leaky":
                    x = F.leaky_relu(x, 0.1)
            elif t == "maxpool":
                k = int(s.get("size", 2))
                x = max_pool_same(x, k, int(s.get("stride", k)))
            elif t == "upsample":
                x = F.interpolate(x, scale_factor=int(s.get("stride", 2)), mode="nearest")
            elif t == "yolo":
                yolo_outputs.append(x.permute(0, 2, 3, 1).contiguous())
            outputs.append(x)  # darknet indexes yolo layers too
        return tuple(yolo_outputs)


def create_darknet(cfg_path: str, generator: torch.Generator | None = None,
                   device="cuda"):
    """(model, heads) from a cfg file (or its text), in eval mode on
    `device`, weights drawn from `generator` (seeded with 0 when None)."""
    model = DarknetModel.from_cfg(cfg_path)
    init_weights(model, generator or torch.Generator().manual_seed(0))
    return model.to(device).eval(), model.heads()


def postprocess_darknet(
    outputs,
    heads: list[YoloHead],
    input_size: int,
    score_threshold: float = 0.25,
    nms_iou: float = 0.2,
    max_detections: int = 64,
    pre_nms_top: int = 512,
):
    """Decode cfg-declared heads + class-aware NMS (anchors, strides and
    scale_x_y all come from the cfg, not hardcoded tables)."""
    boxes_all, scores_all = [], []
    for raw, head in zip(outputs, heads):
        stride = input_size // raw.shape[1]
        bx, sc = decode_head(
            raw, head.anchors, stride, head.scale_xy, head.classes, input_size
        )
        boxes_all.append(bx)
        scores_all.append(sc)
    return select_and_nms(
        torch.cat(boxes_all, dim=1), torch.cat(scores_all, dim=1),
        score_threshold, nms_iou, max_detections, pre_nms_top,
    )


def load_darknet_weights_cfg(model: DarknetModel, path) -> DarknetModel:
    """Load darknet .weights into a DarknetModel, in place: the order
    contract of models.yolov4.load_darknet_weights ([bn_bias, bn_scale,
    mean, var, kernel] per BN conv; [bias, kernel] per linear conv) over
    the cfg's conv order."""
    return load_darknet_weights(model, path)

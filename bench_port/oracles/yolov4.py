"""The oracle YOLOv4-608 (AlexeyAB darknet cfg/yolov4.cfg; a copy lies in
ref/yolov4.cfg).

The program is the port's detector (`cova_tpu_torch.models.yolov4`:
YOLOv4, `postprocess` with K5's NMS, `YoloDetector`) on darknet-order
weights that weights.py makes on the card from the seed. The reference
is the plain YOLOv4 (ref/yolov4_ref.py) on the same weights. A frame is
compared by its heads (the yolo layers' inputs) against the reference's
on the same picture, and by its boxes against the plain decode and NMS of
the program's own heads.
"""

from __future__ import annotations

import operator

import torch

from bench_port import check
from bench_port import flops as counts
from bench_port import weights
from bench_port.ref import yolov4_ref

# Limits, each between the readings of sound runs and of the control
# (PERF.md gives the readings).
LIMITS = {
    # The heads' widest gap over their largest magnitude: float32 with TF32
    # off on both sides reads 1.65e-6-2.52e-6 (sums in other orders), the
    # reference in TF32 7.61e-4-9.28e-4.
    "head_gap": 5e-5,
    # Boxes without a counterpart in the plain decode and NMS of the
    # program's own heads: the same heads give the same boxes.
    "detections_off": 0,
}
FOLD = {"head_gap": max, "detections_off": operator.add}


def flops() -> int:
    """One frame through the cfg's network at 608 x 608."""
    return counts.yolo()


class Program:
    """The port's detector, frames -> BoxRecs, on the seeded weights; it
    keeps the heads of the frame it last ran."""

    def __init__(self, conf: dict, seed: int, device):
        from cova_tpu_torch.models.yolov4 import YOLOv4, YoloDetector, darknet_convs, postprocess

        self.weights = weights.seeded_flat(seed, device, conf["weight_gain"])
        with torch.device(device):
            model = YOLOv4(conf["num_classes"])
        weights.load_into(model, darknet_convs(model), self.weights)

        def post(outs):
            return postprocess(outs, conf["num_classes"], conf["input_size"],
                               score_threshold=conf["score_threshold"], nms_iou=conf["nms_iou"])

        self.detector = YoloDetector(model.eval(), post, conf["input_size"], device)
        self._heads = None
        network = self.detector.network

        def capture_network(x):
            self._heads = network(x)
            return self._heads

        self.detector.network = capture_network

    def __call__(self, frames):
        return self.detector(frames)

    def take(self) -> tuple:
        """The last frame's heads, moved to the host and dropped here, so
        that the device's peak is the program's."""
        heads, self._heads = self._heads, None
        return tuple(h.to("cpu") for h in heads)


class Reference:
    """The plain YOLOv4 on the seeded weights (weights.py's buffer, which
    the program loads as well)."""

    def __init__(self, conf: dict, flat: torch.Tensor, device):
        self.conf, self.device = conf, device
        self.net = yolov4_ref.Yolo(flat)

    def outputs(self, y, u, v) -> list:
        """The heads of one picture (numpy I420 planes)."""
        planes = [torch.from_numpy(p).to(self.device) for p in (y, u, v)]
        return self.net.heads(yolov4_ref.to_input(*planes, self.conf["input_size"]))

    def detections(self, heads, frame_hw) -> list:
        c = self.conf
        return yolov4_ref.detections(heads, self.net.yolo_layers(), c["input_size"], frame_hw,
                                     c["score_threshold"], c["nms_iou"])

    def numbers(self, ref_heads, heads, recs, frame_hw) -> dict:
        """One frame: the program's heads against the reference's, its
        boxes against the plain decode and NMS of those heads."""
        got = [h.to(self.device) for h in heads]
        return {"head_gap": check.head_gap(got, ref_heads),
                "detections_off": check.detections_off(recs, self.detections(got, frame_hw))}

    def control(self, y, u, v) -> dict:
        """One frame's numbers with this reference in TF32 in the
        program's place, held to itself in float32."""
        heads = {}
        for tf32 in (False, True):
            torch.backends.cudnn.allow_tf32 = tf32
            torch.backends.cuda.matmul.allow_tf32 = tf32
            heads[tf32] = self.outputs(y, u, v)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        got = [check.Box(*d) for d in self.detections(heads[True], y.shape)]
        return {"head_gap": check.head_gap(heads[True], heads[False]),
                "detections_off": check.detections_off(got, self.detections(heads[False],
                                                                            y.shape))}

"""The harness's operation counts against torch's FLOP counter (CPU)."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from bench_port import flops
from bench_port.ref import yolov4_ref


@pytest.mark.parametrize("h,w,expected", [(45, 80, 157_934_080), (68, 120, 350_223_360)])
def test_blobnet_count(h, w, expected):
    from cova_tpu_torch.models.blobnet import BlobNet, BlobNetConfig

    model = BlobNet(BlobNetConfig(in_channels=4)).eval()
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        model(torch.rand(1, 4, h, w, 4))
    assert fc.get_total_flops() == flops.blobnet(h, w) == expected


def test_yolo_count():
    net = yolov4_ref.Yolo(torch.zeros(yolov4_ref.num_weights()))
    with FlopCounterMode(display=False) as fc:
        net.heads(torch.rand(1, 3, 608, 608))
    assert fc.get_total_flops() == flops.yolo() == 128_389_482_496

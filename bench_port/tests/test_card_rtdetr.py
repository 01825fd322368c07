"""On the card, for the cell synth720rtdetr.full: a sound cycle of jobs is
correct; each planted fault of the RT-DETR oracle (a dropped decoder
layer, the valid mask skipped, K11 reading its locations with
align_corners True) is not; the control (the reference in TF32) reads
above the limits the program reads below.

    python3 -m pytest -q bench_port/tests/test_card_rtdetr.py

Each case builds the cell, warms it up once, runs one cycle of jobs as a
window does and compares (bench_port/tests/test_card.py's scheme). The
tests skip without a CUDA device.
"""

import functools

import numpy as np
import pytest
import torch

from bench_port import check, control, run
from bench_port.tests.test_card import card, cell_of  # noqa: F401


def _layers(cell):
    return cell.detector.model.decoder.decoder.layers


def drop_a_decoder_layer(monkeypatch, cell):
    monkeypatch.setattr(_layers(cell)[3], "forward", lambda tgt, *a: tgt)


def skip_the_valid_mask(monkeypatch, cell):
    decoder = cell.detector.model.decoder
    monkeypatch.setattr(decoder, "valid_mask", torch.ones_like(decoder.valid_mask))


def k11_with_align_corners(monkeypatch, cell):
    for layer in _layers(cell):
        attn = layer.cross_attn
        monkeypatch.setattr(attn, "ms_deformable_attn_core",
                            functools.partial(attn.ms_deformable_attn_core, align_corners=True))


RTDETR_FAULTS = [drop_a_decoder_layer, skip_the_valid_mask, k11_with_align_corners]
CELLS = ("synth720rtdetr.full",)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(card, name):
    cell = cell_of(name)
    jobs, _ = run.window(cell, 0)
    numbers = run.compare(cell, jobs)
    assert check.verdict(numbers, cell.limits), numbers


@pytest.mark.parametrize("fault", RTDETR_FAULTS, ids=[f.__name__ for f in RTDETR_FAULTS])
def test_rtdetr_fault_is_not_correct(card, monkeypatch, fault):
    cell = cell_of("synth720rtdetr.full")
    fault(monkeypatch, cell)
    jobs, _ = run.window(cell, 0)
    numbers = run.compare(cell, jobs)
    assert not check.verdict(numbers, cell.limits), numbers


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(card, name):
    cell = cell_of(name)
    jobs, _ = run.window(cell, 0)
    readings = control.control_readings(cell, jobs)
    failed = [k for k, v in readings.items() if k in cell.limits and v > cell.limits[k]]
    assert failed, readings
    assert np.isfinite(readings["mask_gap"])

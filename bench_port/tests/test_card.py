"""On the card: a run's comparison comes out false when the timed path is
broken underneath, once for each fault a cell can have, and the control
(the reference in TF32) reads above the limits the program reads below.

    python3 -m pytest -q bench_port/tests/test_card.py

Each case builds the cell, warms it up once, runs one cycle of jobs as a
window does (skipping the harness's look for a chip) and compares. The
tests skip without a CUDA device.
"""

import numpy as np
import pytest
import torch

from bench_port import check, control, run

SEED = 2**31 + 77
CELLS = {}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cells run on the card")


def cell_of(name):
    if name not in CELLS:
        run.set_environment()
        cell = run.Cell(name, SEED)
        cell.warm_up()
        CELLS[name] = cell
    return CELLS[name]


def flip_mask_byte(monkeypatch):
    from cova_tpu_torch.pipeline.compressed import CompressedStage

    orig = CompressedStage.run_chunk_masks

    def broken(self, meta):
        out = orig(self, meta).clone()
        r, f, h, w = self.masks_shape
        out.view(r, f, h, w // 8)[0, 10:20, 10:30] ^= 0x3C
        return out

    monkeypatch.setattr(CompressedStage, "run_chunk_masks", broken)


def drop_half_the_ranges(monkeypatch):
    from cova_tpu_torch.pipeline.compressed import CompressedStage

    orig = CompressedStage.run_chunk_masks

    def broken(self, meta):
        out = orig(self, meta).clone()
        r, f, h, w = self.masks_shape
        out.view(r, f, h, w // 8)[r // 2 :] = 0
        return out

    monkeypatch.setattr(CompressedStage, "run_chunk_masks", broken)


def alter_metadata(monkeypatch):
    from cova_tpu_torch.codec import Mp4Demuxer

    orig = Mp4Demuxer.entropy_decode_packed16

    def broken(self, *a, **kw):
        out = orig(self, *a, **kw)
        out[len(out) // 2, 3, 3, 1] ^= 0x11
        return out

    monkeypatch.setattr(Mp4Demuxer, "entropy_decode_packed16", broken)


def alter_detection(monkeypatch):
    from cova_tpu_torch.models.yolov4 import YoloDetector

    orig = YoloDetector.boxrecs

    def broken(self, *a):
        recs = orig(self, *a)
        if recs:
            recs[0].class_id = (recs[0].class_id + 1) % 80
        return recs

    monkeypatch.setattr(YoloDetector, "boxrecs", broken)


def alter_picture(monkeypatch):
    from cova_tpu_torch.codec.pixrec import PixelDecoder

    orig = PixelDecoder.pop

    def broken(self, *a):
        got = orig(self, *a)
        if got is not None:
            got[1][100, 100] ^= 1
        return got

    monkeypatch.setattr(PixelDecoder, "pop", broken)


def skip_the_capture(monkeypatch):
    """The pipeline's masks step no longer goes through the attribute
    the harness wraps, so nothing of the masks or metadata is captured."""
    orig = run.Cell._wrap

    def wrap(pipe, job):
        masks = pipe.stage.run_chunk_masks
        orig(pipe, job)
        pipe.stage.run_chunk_masks = masks

    monkeypatch.setattr(run.Cell, "_wrap", staticmethod(wrap))


FAULTS = {
    "synth720.full": [flip_mask_byte, drop_half_the_ranges, alter_metadata,
                      alter_detection, alter_picture, skip_the_capture],
    "synth1080.select": [flip_mask_byte, drop_half_the_ranges, alter_metadata,
                         skip_the_capture],
}
CASES = [(c, f) for c, fs in FAULTS.items() for f in fs]


@pytest.mark.parametrize("name", list(FAULTS))
def test_sound_run_is_correct(card, name):
    cell = cell_of(name)
    jobs, _ = run.window(cell, 0)
    numbers = run.compare(cell, jobs)
    assert check.verdict(numbers, cell.limits), numbers


@pytest.mark.parametrize("name,fault", CASES, ids=[f"{c}-{f.__name__}" for c, f in CASES])
def test_fault_is_not_correct(card, monkeypatch, name, fault):
    cell = cell_of(name)
    fault(monkeypatch)
    jobs, _ = run.window(cell, 0)
    numbers = run.compare(cell, jobs)
    assert not check.verdict(numbers, cell.limits), numbers


@pytest.mark.parametrize("name", list(FAULTS))
def test_control_is_not_correct(card, name):
    cell = cell_of(name)
    jobs, _ = run.window(cell, 0)
    readings = control.control_readings(cell, jobs)
    failed = [k for k, v in readings.items() if k in cell.limits and v > cell.limits[k]]
    assert failed, readings
    assert np.isfinite(readings["mask_gap"])

"""The comparison's parts on small data (CPU)."""

import numpy as np
import pytest
import torch

from bench_port import check


def test_range_bounds_split_gops():
    assert check.range_bounds([250] * 7 + [50], 4) == [(0, 500), (500, 500), (1000, 500),
                                                      (1500, 300)]
    assert check.range_bounds([50] + [250] * 7, 4)[0] == (0, 300)


def test_chunk_frames_count_what_the_pipeline_decodes():
    due = check.chunk_frames([500, 500, 500, 300], f=128, t=4)
    assert len(due) == 4
    assert due[0] == [131] * 4
    assert due[2] == [131, 131, 131, 44]
    assert due[3] == [116, 116, 116, 0]
    assert check.chunk_frames([3, 0], f=128, t=4) == []


def test_mask_gap_reads_the_widest_flip_in_live_windows():
    probs = torch.full((2, 3, 4, 8), 0.1)
    probs[0, 0, 1, 2] = 0.61
    probs[1, 2, 0, 0] = 0.9  # window 2 of range 1 is padding
    bits = (probs > 0.6).numpy().astype(np.uint8)
    live = [(0, 0), (0, 1), (0, 2), (1, 0), (1, 1)]
    assert check.mask_gap(bits, probs, live, 0.6) == (0.0, 0)
    bits[0, 0, 1, 2] = 0
    bits[1, 2, 0, 0] = 0
    gap, n = check.mask_gap(bits, probs, live, 0.6)
    assert n == 1 and gap == pytest.approx(0.01, abs=1e-6)


class Box:
    def __init__(self, c, s, l, t, w, h):
        self.class_id, self.confidence, self.left, self.top, self.width, self.height = \
            c, s, l, t, w, h


def test_detections_off_counts_each_side():
    ref = [(1, 0.9, 10.0, 10.0, 5.0, 5.0), (2, 0.5, 1.0, 1.0, 2.0, 2.0)]
    assert check.detections_off([Box(*d) for d in ref], ref) == 0
    assert check.detections_off([Box(3, *ref[0][1:]), Box(*ref[1])], ref) == 1
    assert check.detections_off([Box(*ref[0])], ref) == 1


def test_replayed_csvs_equal_the_program_associator(tmp_path):
    from cova_tpu_torch.aggregator.associator import Associator, BoxRec
    from cova_tpu_torch.types import TrackRecord

    hist = [(k / 30.0, (10.0 + k, 5.0, 4.0, 3.0)) for k in range(40)]
    rec = TrackRecord(track_id=3, start_ts=0.0, end_ts=39 / 30.0, seen=True, history=hist)
    dets = [BoxRec(160.0 + 16 * k, 80.0, 64.0, 48.0, 3072.0, None, k / 30.0, 2, 0.7)
            for k in range(0, 40, 5)]
    dets.append(BoxRec(900.0, 600.0, 30.0, 30.0, 900.0, None, 0.5, 7, 0.4))
    calls = [("set_ranges", ([0.0, 10.0],)), ("submit_track", (0.0, 0.0, rec)),
             ("update_dnn", (dets,))]
    prog = Associator(tmp_path / "prog")
    for name, args in calls:
        getattr(prog, name)(*args)
    prog.terminate()
    ref = check.replay_csvs(calls, tmp_path / "ref")
    assert check.csv_files_off(tmp_path / "prog", ref) == 0
    assert ref["assoc.csv"].count(b"\n") > 1

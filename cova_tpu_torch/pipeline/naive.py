"""Naive full-decode baseline pipeline.

Port of the reference's ground-truth path (reference:
pipeline/naive/pipeline.py + experiment/naive/launch.py): decode every
frame, run the oracle detector on each, write dnn.csv — used as the
accuracy baseline for parse/accuracy (query metrics).

The detector is any callable (list[(pts, y, u, v)]) -> list[BoxRec]
(e.g. a jitted YOLOv4 apply + postprocess); the decode loop feeds it in
display order with bounded batches.
"""

from __future__ import annotations

import dataclasses
import pathlib
import time
from typing import Callable, Optional

from cova_tpu_torch.aggregator.associator import BoxRec, _Writer
from cova_tpu_torch.codec import Mp4Demuxer, PixelDecoder
from cova_tpu_torch.config import CovaConfig


@dataclasses.dataclass
class NaiveResult:
    num_frames: int
    num_detections: int
    elapsed_seconds: float


class NaivePipeline:
    def __init__(
        self,
        input_path: str,
        output_dir: str,
        detector: Callable,
        cfg: CovaConfig = CovaConfig(),
        batch: int = 8,
        log=print,
    ):
        self.demux = Mp4Demuxer(input_path)
        self.detector = detector
        self.cfg = cfg
        self.batch = batch
        self.log = log
        out = pathlib.Path(output_dir)
        out.mkdir(parents=True, exist_ok=True)
        self.writer = _Writer(out / "dnn.csv")

    def run(self, max_frames: Optional[int] = None) -> NaiveResult:
        demux = self.demux
        n = demux.num_samples if max_frames is None else min(
            demux.num_samples, max_frames
        )
        dec = PixelDecoder(demux.extradata())
        start = time.perf_counter()
        pending = []
        n_det = 0
        n_frames = 0

        # Detector and dnn.csv timestamps are SECONDS (the aggregator and
        # query metrics operate in seconds); container pts are in
        # timescale ticks.
        tsc = float(demux.timescale)

        def flush():
            nonlocal n_det
            if not pending:
                return
            for det in self.detector(list(pending)):
                self.writer.row(det)
                n_det += 1
            pending.clear()

        def take(got):
            nonlocal n_frames
            pts, y, u, v = got
            pending.append((pts / tsc, y, u, v))
            n_frames += 1

        for i in range(n):
            dec.send(demux.read_sample(i), demux.sample(i).pts)
            got = dec.pop(demux.width, demux.height)
            while got is not None:
                take(got)
                if len(pending) >= self.batch:
                    flush()
                got = dec.pop(demux.width, demux.height)
        dec.flush()
        got = dec.pop(demux.width, demux.height)
        while got is not None:
            take(got)
            got = dec.pop(demux.width, demux.height)
        flush()
        self.writer.close()
        return NaiveResult(n_frames, n_det, time.perf_counter() - start)

"""Standalone tracking pipeline (PyTorch port of
cova_tpu/pipeline/sort_pipeline.py).

Runs the compressed-domain stage with device SORT over one range and
writes every dead track's history to a CSV, without the frame-selection
and oracle stages; useful for tracker evaluation and debugging.
"""

from __future__ import annotations

import dataclasses
import pathlib
import time
import types
from typing import Optional

import numpy as np
import torch

from cova_tpu_torch.aggregator.associator import BoxRec, _Writer
from cova_tpu_torch.codec import Mp4Demuxer
from cova_tpu_torch.config import CovaConfig
from cova_tpu_torch.models.blobnet import BlobNet, BlobNetConfig
from cova_tpu_torch.pipeline.compressed import CompressedStage, unpack_outputs_np
from cova_tpu_torch.scheduler import HostTracker
from cova_tpu_torch.utils.dataset import pack_metadata


@dataclasses.dataclass
class SortResult:
    num_frames: int
    dead_tracks: int
    elapsed_seconds: float


class SortPipeline:
    """variables: a state_dict for a 3-channel BlobNet (default
    BlobNetConfig); None initialises it at random from a torch.Generator
    seeded with 0. device: where the compressed stage runs."""

    def __init__(
        self,
        input_path: str,
        output_path: str,
        cfg: CovaConfig = CovaConfig(),
        variables=None,
        log=print,
        device="cuda",
    ):
        self.demux = Mp4Demuxer(input_path)
        self.cfg = cfg
        self.log = log
        model = BlobNet(BlobNetConfig())
        if variables is not None:
            model.load_state_dict(variables)
        else:
            model.reset_parameters(torch.Generator().manual_seed(0))
        self.stage = CompressedStage(model, cfg, 1, device)
        pathlib.Path(output_path).parent.mkdir(parents=True, exist_ok=True)
        self.writer = _Writer(output_path)

    def run(self, max_frames: Optional[int] = None) -> SortResult:
        cfg = self.cfg
        t = cfg.video.timestep
        f = cfg.compressed.batch_frames
        fps = cfg.video.fps
        demux = self.demux
        n = demux.num_samples if max_frames is None else min(
            demux.num_samples, max_frames
        )

        dead = [0]

        def on_dead(rec):
            dead[0] += 1
            for ts, (l, tp, w, h) in rec.history:
                self.writer.row(
                    BoxRec(
                        left=l * 16,
                        top=tp * 16,
                        width=w * 16,
                        height=h * 16,
                        area=w * h * 256,
                        track_id=rec.track_id,
                        timestamp=ts / fps,
                        class_id=None,
                        confidence=None,
                    )
                )

        ht = HostTracker(on_dead=on_dead)
        order = demux.display_order(0, n)
        names = (
            "track_ltwh", "track_id", "track_id_post", "exists", "active",
            "predicted", "death", "death_id", "death_start",
            "death_last_match", "death_tsu", "death_active",
        )

        start = time.perf_counter()
        total = 0
        for off in range(0, n - t + 1, f):
            count = min(f + t - 1, n - off)
            if count < t:
                break
            meta = demux.entropy_decode_indices(order[off : off + count])
            frames = pack_metadata(meta)
            chunk = np.zeros((1, f + t - 1, *frames.shape[1:]), np.uint8)
            chunk[0, :count] = frames
            packed, _, _ = self.stage.run_chunk(chunk, np.array([off], np.int32))
            out_np = unpack_outputs_np(packed.cpu().numpy(), self.stage.packed_shape)
            frames_here = min(f, n - t + 1 - off)
            for k in range(frames_here):
                row = types.SimpleNamespace(
                    **{name: getattr(out_np, name)[0, k] for name in names}
                )
                ht.update(float(off + k), row)
                total += 1
        ht.finalize(cfg.sort.min_hits)
        self.writer.close()
        return SortResult(total, dead[0], time.perf_counter() - start)

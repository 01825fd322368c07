"""End-to-end CoVA pipeline orchestration (PyTorch port of
cova_tpu/pipeline/cova.py, all-device tracking).

Wires the codec host layer, the compressed-domain device stage, the
frame selector, the selective pixel decoder and the in-process
aggregator into one driver. Data flow per chunk of F windows:

  host   entropy decode (C++)                     -> (R, F+T-1, H, W, 2) u8
  device metapreprocess+BlobNet+mask+CC+SORT      -> packed (R, F, MT, 30) u8
  host   HostTracker mirror, FrameSelector schedules decodes
  host   selective pixel decode (libavcodec), droppable frames discarded
  host   Associator -> track/dnn/assoc/stationary CSVs

Only `host_tracking=False` is ported: the device runs CC + SORT and the
host mirrors its packed outputs. The `last` config key stops the
pipeline after a named stage for debugging: one of "entdec", "mask",
"boxes", "track", "select", "full".
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
import types
from typing import Callable, Optional

import numpy as np
import torch

from cova_tpu_torch.aggregator import Associator
from cova_tpu_torch.codec import Mp4Demuxer, PixelDecoder
from cova_tpu_torch.config import CovaConfig
from cova_tpu_torch.models.blobnet import BlobNet, BlobNetConfig
from cova_tpu_torch.pipeline.compressed import CompressedStage, unpack_outputs_np
from cova_tpu_torch.scheduler import FrameSelector, HostTracker


@dataclasses.dataclass
class StageTimers:
    """Wall-clock seconds per pipeline stage. Device work runs
    asynchronously behind the host, so the parts can exceed
    elapsed_seconds."""

    entropy_decode: float = 0.0
    device_dispatch: float = 0.0
    host_mirror: float = 0.0
    pixel_stage: float = 0.0


@dataclasses.dataclass
class CovaResult:
    num_frames: int
    elapsed_seconds: float
    dropped: int
    decoded_dependency: int
    decoded_inference: int
    dead_tracks: int
    # Frames actually produced by the selective pixel stage and handed
    # to the detector. On PAFF input this counts WOVEN frames (a field
    # pair is one decode unit), so it can be below decoded_inference.
    pixel_frames: int = 0
    timers: StageTimers = dataclasses.field(default_factory=StageTimers)

    @property
    def decode_filter_rate(self) -> float:
        t = max(self.num_frames, 1)
        return 1.0 - (self.decoded_dependency + self.decoded_inference) / t

    @property
    def inference_filter_rate(self) -> float:
        return 1.0 - self.decoded_inference / max(self.num_frames, 1)


class _HostCopy:
    """A device tensor on its way into host memory: a non-blocking copy
    into a pinned buffer, with a CUDA event recorded behind it. `numpy()`
    waits for the event, so the host reads the buffer only once the copy
    has landed."""

    def __init__(self, src: torch.Tensor):
        cuda = src.device.type == "cuda"
        self.buf = torch.empty(src.shape, dtype=src.dtype, pin_memory=cuda)
        self.buf.copy_(src, non_blocking=cuda)
        self.event = None
        if cuda:
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(src.device))

    def numpy(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.buf.numpy()


class CovaPipeline:
    """End-to-end pipeline, R ranges batched on one device.

    variables: a BlobNet state_dict (e.g. from
    models.blobnet.load_artifact or convert_flax_variables); None
    initialises BlobNet at random from a torch.Generator seeded with 0.
    detector: optional callable (frames) -> list[BoxRec] standing in for
    the oracle; None runs the pixel decoder without inference.
    device: where the compressed stage runs. On CUDA, constructing the
    pipeline turns TF32 off for cuDNN convolutions and matmuls process
    wide (see pipeline.compressed.exact_float32).
    """

    def __init__(
        self,
        input_path: str,
        output_dir: str,
        cfg: CovaConfig = CovaConfig(),
        variables=None,
        detector: Optional[Callable] = None,
        log=print,
        device="cpu",
    ):
        if cfg.compressed.host_tracking:
            raise NotImplementedError(
                "host_tracking=True is not ported yet (ROADMAP: port slice 2, "
                "the host-tracking mode); set cfg.compressed.host_tracking=False"
            )
        if cfg.parallel.num_devices > 1:
            raise NotImplementedError(
                "num_devices > 1 is not ported (ROADMAP: parallel/mesh)"
            )
        self.cfg = cfg
        self.log = log
        self.device = torch.device(device)
        self.demux = Mp4Demuxer(input_path)
        self.aggregator = Associator(output_dir, cfg.aggregator)
        self.detector = detector

        in_ch = 4 if cfg.compressed.use_nnz_channel else 3
        model = BlobNet(BlobNetConfig(in_channels=in_ch))
        if variables is not None:
            model.load_state_dict(variables)
        else:
            model.reset_parameters(torch.Generator().manual_seed(0))

        self.num_ranges = cfg.parallel.num_ranges
        self.stage = CompressedStage(model, cfg, self.num_ranges, self.device)
        self.num_chunks = 0

    @classmethod
    def multi(cls, *args, **kwargs):
        raise NotImplementedError(
            "multi-stream ingest is not ported (ROADMAP: parallel/mesh and .multi)"
        )

    def _range_bounds(self):
        """Split the stream's GoPs into num_ranges contiguous ranges, so
        each range is one coherent timeline. Returns (start, count)
        sample pairs, num_ranges of them."""
        r = self.cfg.parallel.num_ranges
        gops = self.demux.gops()
        per = max(1, math.ceil(len(gops) / r))
        bounds = []
        for i in range(0, len(gops), per):
            chunk = gops[i : i + per]
            first = chunk[0].first_sample
            count = sum(g.num_samples for g in chunk)
            bounds.append((first, count))
        while len(bounds) < r:
            bounds.append((self.demux.num_samples, 0))
        return bounds[:r]

    def warmup(self) -> None:
        """Run the device stage once on a zeroed chunk (nwin = 0, so the
        tracker state is untouched), so a subsequent timed run() measures
        steady-state work, not kernel builds and cuDNN planning."""
        cfg = self.cfg
        nf = cfg.compressed.batch_frames + cfg.video.timestep - 1
        chunk = np.zeros(
            (self.num_ranges, nf, self.demux.mb_height, self.demux.mb_width, 2),
            np.uint8,
        )
        if cfg.compressed.signed_mv:
            chunk[..., 1] = 0x88
        ts0 = np.zeros(self.num_ranges, np.int32)
        nwin = np.zeros(self.num_ranges, np.int32)
        pulled, _, _ = self.stage.run_chunk(chunk, ts0, nwin)
        pulled.cpu()

    def run(self, max_frames: Optional[int] = None) -> CovaResult:
        # COVA_PROFILE=<dir> wraps the run in a torch.profiler trace
        # (host ops, and device kernels on CUDA), written to <dir> as a
        # Chrome trace beside the stage timers in CovaResult.timers.
        prof_dir = os.environ.get("COVA_PROFILE")
        if not prof_dir:
            return self._run(max_frames)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        os.makedirs(prof_dir, exist_ok=True)
        with torch.profiler.profile(activities=acts) as prof:
            res = self._run(max_frames)
        prof.export_chrome_trace(os.path.join(prof_dir, "cova_trace.json"))
        return res

    def _run(self, max_frames: Optional[int] = None) -> CovaResult:
        cfg = self.cfg
        t = cfg.video.timestep
        f = cfg.compressed.batch_frames
        fps = cfg.video.fps
        demux = self.demux
        last = cfg.last or "full"

        bounds = self._range_bounds()
        if max_frames:
            bounds = [(s, min(c, max_frames)) for s, c in bounds]
        # Absolute display rank -> presentation seconds. The aggregator
        # associates oracle detections with track boxes by EXACT
        # timestamp equality, and detections carry container pts, so
        # every timestamp that reaches the aggregator comes from the
        # container clock, not from rank/fps. The selector/tracker keep
        # working in the rank/fps domain internally.
        all_pts = np.sort(
            np.array(
                [demux.sample(i).pts for i in range(demux.num_samples)],
                dtype=np.int64,
            )
        )
        pts_sec = all_pts / float(demux.timescale)
        if len(pts_sec) == 0:
            pts_sec = np.zeros(1)
        # Extrapolate past EOS for empty-range placeholders.
        pts_sec = np.concatenate(
            [pts_sec, pts_sec[-1] + np.arange(1, len(bounds) + 2) / fps]
        )
        range_starts = [float(pts_sec[s]) for s, _ in bounds]
        self.aggregator.set_ranges(range_starts)
        # Display-order sample indices per range (B-frame reordering):
        # the temporal stack must see frames in presentation order, while
        # the frame selector consumes frames in decode order with their
        # display-position pts.
        disp = [
            demux.display_order(s, c) if c else np.zeros(0, np.int32)
            for s, c in bounds
        ]
        # display position (absolute frame rank) per sample index
        pos_of = []
        for ri, (s_, _) in enumerate(bounds):
            pos_of.append({int(si): s_ + rel for rel, si in enumerate(disp[ri])})

        dead_count = [0]

        def on_dead_factory(range_start, sample_start):
            # HostTracker works in range-relative frame indices (the
            # device SORT's ts domain); convert to absolute seconds at
            # the aggregator boundary. `box` is filled with the tracker
            # right after construction.
            box = {}

            def cb(rec):
                dead_count[0] += 1
                oldest = box["ht"].oldest

                def sec(frame_idx):
                    return float(
                        pts_sec[min(sample_start + int(round(frame_idx)),
                                    len(pts_sec) - 1)]
                    )

                oldest_s = sec(oldest) if math.isfinite(oldest) else 1e18
                rec = dataclasses.replace(
                    rec,
                    start_ts=sec(rec.start_ts),
                    end_ts=sec(rec.end_ts),
                    history=[(sec(fi), box_) for fi, box_ in rec.history],
                )
                self.aggregator.submit_track(range_start, oldest_s, rec)

            return cb, box

        selectors = []
        trackers = []
        # Scheduled decodes, grouped by range so the pixel stage can run
        # one independent decoder per range.
        pix_jobs: list[list] = [[] for _ in bounds]

        def emit_factory(selector_idx):
            def emit(frames):
                pix_jobs[selector_idx].extend(frames)

            return emit

        for ri, (start, _) in enumerate(bounds):
            cb, cb_box = on_dead_factory(range_starts[ri], start)
            ht = HostTracker(on_dead=cb)
            cb_box["ht"] = ht
            trackers.append(ht)

            def mk_seen(ht=ht, start=start):
                # selector pts (seconds) -> range-relative frame index
                return lambda pts: ht.mark_seen(round(pts * fps) - start)

            selectors.append(
                FrameSelector(
                    cfg.selector,
                    cfg.sort,
                    fps=fps,
                    mark_seen=mk_seen(),
                    emit=emit_factory(ri),
                )
            )

        # Pre-feed the selectors with every encoded frame in decode order.
        for ri, (start, count) in enumerate(bounds):
            sel = selectors[ri]
            for si in range(start, start + count):
                info = demux.sample(si)
                sel.push_frame(si, pos_of[ri][si] / fps, info.keyframe)

        start_time = time.perf_counter()
        # Window accounting: window j of a range covers source frames
        # [j*gamma, j*gamma + t) and is attributed to its NEWEST frame
        # j*gamma + t - 1. Chunk count follows the longest range; shorter
        # ranges stop contributing (their slots process zero-filled
        # metadata, which the host mirror skips).
        g = cfg.compressed.gamma
        wmax = [max(0, (c - t) // g + 1) for _, c in bounds]
        longest_w = max(wmax, default=0)
        n_chunks = -(-longest_w // f) if longest_w > 0 else 0
        self.num_chunks = n_chunks
        nf_chunk = (f - 1) * g + t  # source frames fed per chunk
        total_frames = sum(c for _, c in bounds)

        threads = cfg.parallel.decode_threads
        mh, mw = demux.mb_height, demux.mb_width

        def host_mirror(pulled, win0, skipped):
            """Consume one chunk's packed SortOutputs: HostTracker
            histories/deaths + FrameSelector scheduling per window."""
            out_np = unpack_outputs_np(pulled.numpy(), self.stage.packed_shape)
            names = (
                "track_ltwh", "track_id", "track_id_post", "exists",
                "active", "predicted", "death", "death_id", "death_start",
                "death_last_match", "death_tsu", "death_active",
            )
            for ri, (start, _) in enumerate(bounds):
                if skipped[ri]:
                    continue
                sel = selectors[ri]
                ht = trackers[ri]
                for k in range(f):
                    if win0 + k >= wmax[ri]:
                        break
                    # Range-relative display index of the window's
                    # newest frame (the frame this mask describes).
                    frame_idx = (win0 + k) * g + t - 1
                    pts = (start + frame_idx) / fps
                    row = types.SimpleNamespace(
                        **{n: getattr(out_np, n)[ri, k] for n in names}
                    )
                    min_required_frame = ht.update(float(frame_idx), row)
                    if last == "track":
                        continue
                    min_required = (
                        None
                        if min_required_frame is None
                        else (start + min_required_frame) / fps
                    )
                    sel.on_mask_frame(pts, min_required)

        # Software-pipelined chunk loop: while chunk i's packed outputs
        # cross to the host, the host entropy-decodes chunk i+1 and the
        # device works on it; the host mirror for chunk i runs one
        # iteration later, when its copy has landed.
        timers = StageTimers()
        pending_mirror = None  # (_HostCopy, win0, skipped) awaiting mirror
        for chunk_i in range(n_chunks):
            win0 = chunk_i * f
            off = win0 * g  # first source frame of the chunk
            t_dec = time.perf_counter()
            meta_chunk = np.zeros((self.num_ranges, nf_chunk, mh, mw, 2), np.uint8)
            if cfg.compressed.signed_mv:
                # zero motion (mv_x=mv_y=8 -> offset 128) in padding
                meta_chunk[..., 1] = 0x88
            skipped = []
            for ri, (start, count) in enumerate(bounds):
                n = min(nf_chunk, count - off)
                if win0 >= wmax[ri] or n <= 0:
                    skipped.append(True)
                    continue
                demux.entropy_decode_packed16(
                    disp[ri][off : off + n],
                    with_nnz=cfg.compressed.use_nnz_channel,
                    signed_mv=cfg.compressed.signed_mv,
                    threads=threads,
                    out=meta_chunk[ri, :n],
                )
                skipped.append(False)
            timers.entropy_decode += time.perf_counter() - t_dec
            if last == "entdec":
                continue

            t_dev = time.perf_counter()
            ts0 = np.full(self.num_ranges, off + t - 1, np.int32)
            nwin = np.array([max(0, min(f, wm - win0)) for wm in wmax], np.int32)
            packed, _, _ = self.stage.run_chunk(meta_chunk, ts0, nwin)
            timers.device_dispatch += time.perf_counter() - t_dev
            if last in ("mask", "boxes"):
                continue
            pulled = _HostCopy(packed)

            if pending_mirror is not None:
                t_mir = time.perf_counter()
                host_mirror(*pending_mirror)
                timers.host_mirror += time.perf_counter() - t_mir
            pending_mirror = (pulled, win0, skipped)
        if pending_mirror is not None:
            t_mir = time.perf_counter()
            host_mirror(*pending_mirror)
            timers.host_mirror += time.perf_counter() - t_mir

        # EOS: flush selectors + trackers, then decode scheduled frames.
        for sel, ht in zip(selectors, trackers):
            sel.finish()
            ht.finalize(cfg.sort.min_hits)

        pixel_frames = 0
        if last == "full" and any(pix_jobs):
            t_pix = time.perf_counter()
            pixel_frames = self._run_pixel_stage(pix_jobs)
            timers.pixel_stage += time.perf_counter() - t_pix

        self.aggregator.terminate()
        elapsed = time.perf_counter() - start_time

        counts = [s.counts for s in selectors]
        return CovaResult(
            num_frames=total_frames,
            elapsed_seconds=elapsed,
            dropped=sum(c.dropped for c in counts),
            decoded_dependency=sum(c.decoded_dependency for c in counts),
            decoded_inference=sum(c.decoded_inference for c in counts),
            dead_tracks=dead_count[0],
            pixel_frames=pixel_frames,
            timers=timers,
        )

    def _run_pixel_stage(self, jobs_per_range):
        """Selective decode: feed scheduled frames in GoP-prefix order to
        libavcodec, drop droppable (dependency-only) outputs, hand the
        rest to the detector. Ranges decode concurrently, one decoder per
        range; ctypes drops the GIL inside libavcodec."""
        import concurrent.futures

        demux = self.demux
        # Prefetch bitstream payloads serially: the demuxer's FILE* is
        # seek-position stateful, so only the libavcodec work is fanned
        # out to threads.
        prefetched = []
        for jobs in jobs_per_range:
            ordered = sorted(jobs, key=lambda x: x.sample_index)
            drop = {fr.sample_index: fr.droppable for fr in ordered}
            # PAFF: one sample = one FIELD; libavcodec weaves the
            # complementary pair (adjacent samples, opposite parity)
            # into ONE output frame carrying the FIRST field's pts.
            # Decode pairs atomically: pull in the complement of every
            # scheduled field, and keep the woven frame iff EITHER
            # field was scheduled non-droppable. field_parity() is 0
            # for every progressive/MBAFF sample (frame pictures), so
            # this is a no-op off PAFF streams.
            for si in sorted(drop):
                p = demux.field_parity(si)
                if p == 0:
                    continue
                for cand in (si + 1, si - 1):
                    if (0 <= cand < demux.num_samples
                            and demux.field_parity(cand) == 3 - p):
                        if cand not in drop:
                            drop[cand] = True
                        merged = drop[si] and drop[cand]
                        drop[si] = drop[cand] = merged
                        break
            prefetched.append(
                [(demux.read_sample(si), demux.sample(si).pts, drop[si])
                 for si in sorted(drop)]
            )

        def decode_range(items):
            if not items:
                return []
            dec = PixelDecoder(demux.extradata())
            frames = []
            droppable_by_pts = {pts: d for _, pts, d in items}

            def drain():
                got = dec.pop(demux.width, demux.height)
                while got is not None:
                    pts, y, u, v = got
                    d = droppable_by_pts.get(pts)
                    if d is not None and not d:
                        # Detector timestamps are seconds (the
                        # aggregator's association domain); container
                        # pts are timescale ticks.
                        frames.append((pts / float(demux.timescale), y, u, v))
                    got = dec.pop(demux.width, demux.height)

            for payload, pts, _ in items:
                dec.send(payload, pts)
                drain()
            dec.flush()
            drain()
            return frames

        workers = max(1, min(len(prefetched), self.cfg.parallel.decode_threads))
        with concurrent.futures.ThreadPoolExecutor(max_workers=workers) as ex:
            per_range = list(ex.map(decode_range, prefetched))

        infer_frames = [fr for frames in per_range for fr in frames]
        self.log(f"pixel stage: decoded {len(infer_frames)} inference frames")
        if self.detector is not None and infer_frames:
            dets = self.detector(infer_frames)
            if dets:
                self.aggregator.update_dnn(dets)
        return len(infer_frames)

"""End-to-end CoVA pipeline orchestration (PyTorch port of
cova_tpu/pipeline/cova.py).

Wires the codec host layer, the compressed-domain device stage, the
frame selector, the selective pixel decoder and the in-process
aggregator into one pipeline. Data flow per chunk of F windows (default
cfg.compressed.host_tracking=True):

  host   entropy decode (C++)                 -> (R, F+T-1, H, W, 2) u8
  device metapreprocess+BlobNet+mask          -> flat bit-packed u8 masks
  host   native CC + SORT (cctrack.cc), FrameSelector schedules decodes
  host   selective pixel decode (libavcodec), droppable frames discarded
  device oracle detector on the surviving frames (optional; e.g.
         models.yolov4.make_yolo_detector)
  host   Associator -> track/dnn/assoc/stationary CSVs

With host_tracking=False the device also runs CC (the CUDA kernel) and
SORT, and the host mirrors its packed per-slot outputs.

The `last` config key stops the pipeline after a named stage for
debugging: one of "entdec", "mask", "boxes", "track", "select", "full"
(the default). A codec library built without libavcodec (the stub
decoder, csrc/pixdec_stub.cc) cannot run the pixel stage, so "full" then
raises before any work starts.
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
from cova_tpu_torch.parallel.mesh import make_mesh
from cova_tpu_torch.pipeline.compressed import (
    CompressedStage,
    unpack_masks,
    unpack_outputs_np,
)
from cova_tpu_torch.scheduler import FrameSelector, HostTracker
from cova_tpu_torch.tracker.host import HostSort, cc_boxes

# Box capacity per frame of the host CC (the device path keeps
# types.MAX_BOXES_PER_FRAME = 32).
HOST_MAX_BOXES = 16


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


@dataclasses.dataclass
class _Stream:
    """Per-input state for multi-stream ingest: N files share one device
    batch, each with its own trackers, selectors and aggregator."""

    demux: Mp4Demuxer
    aggregator: Associator
    detector: Optional[Callable]


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
    """End-to-end pipeline, R ranges batched on one device, or split over
    cfg.parallel.num_devices devices of `device`'s type (a mesh: each
    device runs the stage on its block of ranges; the host state stays
    per range in this process, so the outputs do not change).

    variables: a BlobNet state_dict (e.g. from
    models.blobnet.load_artifact or convert_flax_variables); None
    initialises BlobNet at random from a torch.Generator seeded with 0.
    detector: optional callable (frames) -> list[BoxRec] standing in for
    the oracle; None runs the pixel decoder without inference.
    device: where the compressed stage runs. On CUDA, constructing the
    pipeline turns TF32 off for cuDNN convolutions and matmuls process
    wide (see pipeline.compressed.exact_float32).

    Multi-stream ingest: `CovaPipeline.multi([(path, out_dir, detector),
    ...], cfg)` runs N files through one device batch: each stream
    contributes cfg.parallel.num_ranges ranges (R_total = N * num_ranges)
    and keeps its own host state (trackers, selectors, aggregator CSVs),
    so per-stream outputs equal solo runs. All streams must share one MB
    grid.
    """

    def __init__(
        self,
        input_path: Optional[str],
        output_dir: Optional[str],
        cfg: CovaConfig = CovaConfig(),
        variables=None,
        detector: Optional[Callable] = None,
        log=print,
        device="cuda",
        _streams=None,
    ):
        self.cfg = cfg
        self.log = log
        self.device = torch.device(device)
        if _streams is None:
            _streams = [(input_path, output_dir, detector)]
        self.streams = [
            _Stream(
                demux=Mp4Demuxer(path),
                aggregator=Associator(out, cfg.aggregator),
                detector=det,
            )
            for path, out, det in _streams
        ]
        # Single-stream aliases.
        self.demux = self.streams[0].demux
        self.aggregator = self.streams[0].aggregator
        self.detector = self.streams[0].detector
        grid = (self.demux.mb_width, self.demux.mb_height)
        for s in self.streams[1:]:
            if (s.demux.mb_width, s.demux.mb_height) != grid:
                raise ValueError(
                    "multi-stream ingest requires one MB grid across "
                    "streams (one device batch per shape)"
                )

        in_ch = 4 if cfg.compressed.use_nnz_channel else 3
        model = BlobNet(BlobNetConfig(in_channels=in_ch))
        if variables is not None:
            model.load_state_dict(variables)
        else:
            model.reset_parameters(torch.Generator().manual_seed(0))

        self.num_ranges = cfg.parallel.num_ranges * len(self.streams)
        mesh = None
        if cfg.parallel.num_devices > 1:
            mesh = make_mesh(cfg.parallel.num_devices, cfg.parallel.mesh_axis,
                             self.device.type)
        self.stage = CompressedStage(model, cfg, self.num_ranges, self.device, mesh=mesh)
        self.num_chunks = 0

    @classmethod
    def multi(
        cls,
        streams,
        cfg: CovaConfig = CovaConfig(),
        variables=None,
        log=print,
        device="cuda",
    ) -> "CovaPipeline":
        """streams: list of (input_path, output_dir, detector)."""
        return cls(None, None, cfg, variables, None, log, device, _streams=streams)

    def _range_bounds(self):
        """Split each stream's GoPs into num_ranges contiguous ranges, so
        each range is one coherent timeline. Returns (stream_idx, start,
        count) triples, num_ranges per stream."""
        r = self.cfg.parallel.num_ranges
        bounds = []
        for sidx, s in enumerate(self.streams):
            gops = s.demux.gops()
            per = max(1, math.ceil(len(gops) / r))
            sb = []
            for i in range(0, len(gops), per):
                chunk = gops[i : i + per]
                first = chunk[0].first_sample
                count = sum(g.num_samples for g in chunk)
                sb.append((sidx, first, count))
            while len(sb) < r:
                sb.append((sidx, s.demux.num_samples, 0))
            bounds.extend(sb[:r])
        return bounds

    def warmup(self) -> None:
        """Run the device stage once on a zeroed chunk (for the device
        SORT with nwin = 0, so the tracker state is untouched), so a
        subsequent timed run() measures steady-state work, not kernel
        builds and cuDNN planning."""
        cfg = self.cfg
        nf = cfg.compressed.batch_frames + cfg.video.timestep - 1
        chunk = np.zeros(
            (self.num_ranges, nf, self.demux.mb_height, self.demux.mb_width, 2),
            np.uint8,
        )
        if cfg.compressed.signed_mv:
            chunk[..., 1] = 0x88
        if cfg.compressed.host_tracking:
            self.stage.run_chunk_masks(chunk).cpu()
        else:
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
        last = cfg.last or "full"
        if last == "full":
            self._require_pixel_decoder()

        bounds = self._range_bounds()
        if max_frames:
            bounds = [(sx, s, min(c, max_frames)) for sx, s, c in bounds]
        # Absolute display rank -> presentation seconds, per stream. The
        # aggregator associates oracle detections with track boxes by
        # EXACT timestamp equality, and detections carry container pts,
        # so every timestamp that reaches the aggregator comes from the
        # container clock, not from rank/fps. The selector/tracker keep
        # working in the rank/fps domain internally.
        pts_sec_s = []
        for s in self.streams:
            d = s.demux
            all_pts = np.sort(
                np.array(
                    [d.sample(i).pts for i in range(d.num_samples)],
                    dtype=np.int64,
                )
            )
            ps = all_pts / float(d.timescale)
            if len(ps) == 0:
                ps = np.zeros(1)
            # Extrapolate past EOS for empty-range placeholders.
            ps = np.concatenate([ps, ps[-1] + np.arange(1, len(bounds) + 2) / fps])
            pts_sec_s.append(ps)
        range_starts = [float(pts_sec_s[sx][s]) for sx, s, _ in bounds]
        for sidx, s in enumerate(self.streams):
            s.aggregator.set_ranges(
                [rs for rs, (sx, _, _) in zip(range_starts, bounds) if sx == sidx]
            )
        # Display-order sample indices per range (B-frame reordering):
        # the temporal stack must see frames in presentation order, while
        # the frame selector consumes frames in decode order with their
        # display-position pts.
        disp = [
            self.streams[sx].demux.display_order(s, c) if c else np.zeros(0, np.int32)
            for sx, s, c in bounds
        ]
        # display position (absolute frame rank) per sample index
        pos_of = []
        for ri, (_, s_, _) in enumerate(bounds):
            pos_of.append({int(si): s_ + rel for rel, si in enumerate(disp[ri])})

        dead_count = [0]

        def on_dead_factory(range_start, sample_start, stream):
            # The trackers work in range-relative frame indices; convert
            # to absolute seconds at the aggregator boundary. `box` is
            # filled with the tracker right after construction.
            box = {}
            pts_sec = pts_sec_s[stream]
            agg = self.streams[stream].aggregator

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
                agg.submit_track(range_start, oldest_s, rec)

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

        host_tracking = cfg.compressed.host_tracking
        for ri, (sx, start, _) in enumerate(bounds):
            cb, cb_box = on_dead_factory(range_starts[ri], start, sx)
            # One native tracker per range and run (its C state is freed
            # when the object goes).
            if host_tracking:
                ht = HostSort(cfg.sort, on_dead=cb)
            else:
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
        for ri, (sx, start, count) in enumerate(bounds):
            sel = selectors[ri]
            d = self.streams[sx].demux
            for si in range(start, start + count):
                sel.push_frame(si, pos_of[ri][si] / fps, d.sample(si).keyframe)

        start_time = time.perf_counter()
        # Window accounting: window j of a range covers source frames
        # [j*gamma, j*gamma + t) and is attributed to its NEWEST frame
        # j*gamma + t - 1. Chunk count follows the longest range; shorter
        # ranges stop contributing (their slots process zero-filled
        # metadata, which the host mirror skips).
        g = cfg.compressed.gamma
        wmax = [max(0, (c - t) // g + 1) for _, _, c in bounds]
        longest_w = max(wmax, default=0)
        n_chunks = -(-longest_w // f) if longest_w > 0 else 0
        self.num_chunks = n_chunks
        nf_chunk = (f - 1) * g + t  # source frames fed per chunk
        total_frames = sum(c for _, _, c in bounds)

        threads = cfg.parallel.decode_threads
        mh, mw = self.demux.mb_height, self.demux.mb_width

        def live_windows(win0, skipped):
            """(range, window of the chunk, range-relative display index
            of the window's newest frame, the frame its mask describes)
            for every real window of a chunk."""
            for ri in range(len(bounds)):
                if skipped[ri]:
                    continue
                for k in range(min(f, wmax[ri] - win0)):
                    yield ri, k, (win0 + k) * g + t - 1

        def select(ri, frame_idx, min_required_frame):
            """Feed the window's mask frame to the range's selector, with
            the tracker's min_required frame (None when nothing died)."""
            if last == "track":
                return
            start = bounds[ri][1]
            # The selector works in the rank/fps domain.
            min_required = (
                None if min_required_frame is None else (start + min_required_frame) / fps
            )
            selectors[ri].on_mask_frame((start + frame_idx) / fps, min_required)

        def host_track(pulled, win0, skipped):
            """host_tracking mode: the chunk's bit-packed masks through
            native CC + SORT (csrc/cctrack.cc) per range and window, and
            the selector fed from them."""
            r_, f_, mh_, mw_ = self.stage.masks_shape
            masks = unpack_masks(pulled.numpy(), self.stage.masks_shape)
            ltwh, _, valid = cc_boxes(
                masks.reshape(r_ * f_, mh_, mw_),
                cfg.compressed.cc_threshold,
                HOST_MAX_BOXES,
            )
            ltwh = ltwh.reshape(r_, f_, HOST_MAX_BOXES, 4)
            valid = valid.reshape(r_, f_, HOST_MAX_BOXES)
            for ri, k, frame_idx in live_windows(win0, skipped):
                dets = ltwh[ri, k][valid[ri, k]]
                select(ri, frame_idx, trackers[ri].update(dets, float(frame_idx)))

        names = (
            "track_ltwh", "track_id", "track_id_post", "exists",
            "active", "predicted", "death", "death_id", "death_start",
            "death_last_match", "death_tsu", "death_active",
        )

        def host_mirror(pulled, win0, skipped):
            """Consume one chunk's packed SortOutputs: HostTracker
            histories/deaths + FrameSelector scheduling per window."""
            out_np = unpack_outputs_np(pulled.numpy(), self.stage.packed_shape)
            for ri, k, frame_idx in live_windows(win0, skipped):
                row = types.SimpleNamespace(
                    **{n: getattr(out_np, n)[ri, k] for n in names}
                )
                select(ri, frame_idx, trackers[ri].update(float(frame_idx), row))

        mirror = host_track if host_tracking else host_mirror
        # Software-pipelined chunk loop: while chunk i's outputs cross to
        # the host, the host entropy-decodes chunk i+1 and the device
        # works on it; the host mirror for chunk i runs one iteration
        # later, when its copy has landed.
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
            for ri, (sx, start, count) in enumerate(bounds):
                n = min(nf_chunk, count - off)
                if win0 >= wmax[ri] or n <= 0:
                    skipped.append(True)
                    continue
                self.streams[sx].demux.entropy_decode_packed16(
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
            if host_tracking:
                out = self.stage.run_chunk_masks(meta_chunk)
            else:
                ts0 = np.full(self.num_ranges, off + t - 1, np.int32)
                nwin = np.array([max(0, min(f, wm - win0)) for wm in wmax], np.int32)
                out, _, _ = self.stage.run_chunk(meta_chunk, ts0, nwin)
            timers.device_dispatch += time.perf_counter() - t_dev
            if last in ("mask", "boxes"):
                continue
            pulled = _HostCopy(out)

            if pending_mirror is not None:
                t_mir = time.perf_counter()
                mirror(*pending_mirror)
                timers.host_mirror += time.perf_counter() - t_mir
            pending_mirror = (pulled, win0, skipped)
        if pending_mirror is not None:
            t_mir = time.perf_counter()
            mirror(*pending_mirror)
            timers.host_mirror += time.perf_counter() - t_mir

        # EOS: flush selectors + trackers, then decode scheduled frames.
        for sel, ht in zip(selectors, trackers):
            sel.finish()
            if host_tracking:
                ht.finalize()
            else:
                ht.finalize(cfg.sort.min_hits)

        pixel_frames = 0
        if last == "full" and any(pix_jobs):
            t_pix = time.perf_counter()
            pixel_frames = self._run_pixel_stage(pix_jobs, [sx for sx, _, _ in bounds])
            timers.pixel_stage += time.perf_counter() - t_pix

        for s in self.streams:
            s.aggregator.terminate()
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

    def _require_pixel_decoder(self) -> None:
        """The pixel stage needs a decoder that opens: refuse to start
        with the stub, rather than skip the stage."""
        for s in self.streams:
            try:
                PixelDecoder(s.demux.extradata()).close()
            except RuntimeError as e:
                raise RuntimeError(
                    'last="full" needs the selective pixel decoder, and this '
                    "codec library has none (built with csrc/pixdec_stub.cc, "
                    'without libavcodec): run with last="select", or call the '
                    "detector on decoded frames directly "
                    "(models.yolov4.make_yolo_detector)"
                ) from e

    def _run_pixel_stage(self, jobs_per_range, stream_of_range):
        """Selective decode: feed scheduled frames in GoP-prefix order to
        libavcodec, drop droppable (dependency-only) outputs, hand the
        rest to the stream's detector. Ranges decode concurrently, one
        decoder per range; ctypes drops the GIL inside libavcodec."""
        import concurrent.futures

        # Prefetch bitstream payloads serially: the demuxer's FILE* is
        # seek-position stateful, so only the libavcodec work is fanned
        # out to threads.
        prefetched = []
        for ri, jobs in enumerate(jobs_per_range):
            demux = self.streams[stream_of_range[ri]].demux
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

        def decode_range(args):
            items, sx = args
            if not items:
                return []
            demux = self.streams[sx].demux
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
            per_range = list(ex.map(decode_range, zip(prefetched, stream_of_range)))

        # Inference + aggregation per stream (independent detector and
        # aggregator state; a solo run is the 1-stream special case).
        total = 0
        for sidx, s in enumerate(self.streams):
            infer_frames = [
                fr
                for ri, frames in enumerate(per_range)
                if stream_of_range[ri] == sidx
                for fr in frames
            ]
            total += len(infer_frames)
            self.log(
                f"pixel stage: decoded {len(infer_frames)} inference frames"
                + (f" (stream {sidx})" if len(self.streams) > 1 else "")
            )
            if s.detector is not None and infer_frames:
                dets = s.detector(infer_frames)
                if dets:
                    s.aggregator.update_dnn(dets)
        return total

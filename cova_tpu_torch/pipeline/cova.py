"""End-to-end CoVA pipeline orchestration (PyTorch port of
cova_tpu/pipeline/cova.py).

Wires the codec host layer, the compressed-domain device stage, the
frame selector, the selective pixel decoder and the in-process
aggregator into one pipeline. Data flow per chunk of F windows (default
cfg.compressed.host_tracking=True):

  host   entropy decode (C++) of the run's GoP-aligned ranges
         (pipeline/ranges.py's RangePlan)     -> (R, F+T-1, H, W, 2) u8
  device metapreprocess+BlobNet+mask          -> flat bit-packed u8 masks
  host   native CC + SORT (cctrack.cc), FrameSelector schedules decodes
         (one ranges.RangeHost a range)
  host   selective pixel decode: syntax on the host, the picture on the
  device   pipeline's device (codec/pixrec.py, kernels K8-K10 on CUDA);
         droppable frames discarded
  device oracle detector on the surviving frames (optional; e.g.
         models.yolov4.make_yolo_detector)
  host   Associator -> track/dnn/assoc/stationary CSVs

With host_tracking=False the device also runs CC (the CUDA kernel) and
SORT, and the host mirrors its packed per-slot outputs.

The `last` config key stops the pipeline after a named stage for
debugging: one of "entdec", "mask", "boxes", "track", "select", "full"
(the default). "full" raises before any work starts on a stream outside
the pixel decoder's scope (pixrec.UnsupportedStreamError: field or
MBAFF pictures, other chroma formats or bit depths, ...).
"""

from __future__ import annotations

import dataclasses
import functools
import threading
import time
import types
from typing import Callable, Optional

import numpy as np
import torch

from cova_tpu_torch import trace
from cova_tpu_torch.aggregator import Associator
from cova_tpu_torch.codec import Mp4Demuxer, PixelDecoder
from cova_tpu_torch.codec.pixrec import check_stream
from cova_tpu_torch.config import CovaConfig
from cova_tpu_torch.models.blobnet import BlobNet, BlobNetConfig
from cova_tpu_torch.parallel.mesh import make_mesh
from cova_tpu_torch.pipeline.compressed import (
    CompressedStage,
    unpack_masks,
    unpack_outputs_np,
)
from cova_tpu_torch.pipeline.ranges import RangePlan
from cova_tpu_torch.scheduler import HostTracker
from cova_tpu_torch.tracker.host import HostSort, cc_boxes

# Box capacity per frame of the host CC (the device path keeps
# types.MAX_BOXES_PER_FRAME = 32).
HOST_MAX_BOXES = 16


@dataclasses.dataclass
class StageTimers:
    """Wall-clock seconds per pipeline stage. Device work runs
    asynchronously behind the host, so the parts can exceed
    elapsed_seconds. Each field sums the seconds of the tracer's timed
    spans that bound it (cova_tpu_torch/trace.py), traced or not:
    entropy_decode `cova.entdec`, device_dispatch `cova.masks`,
    host_mirror `cova.mirror`, pixel_stage `cova.pixel_stage`, oracle
    `cova.oracle`, and pixel_decode `cova.pixdec` less `cova.oracle`."""

    entropy_decode: float = 0.0
    device_dispatch: float = 0.0
    host_mirror: float = 0.0
    pixel_stage: float = 0.0
    # The pixel stage's parts: the selective decode (ranges in threads,
    # wall time) and the detector over the decoded frames.
    pixel_decode: float = 0.0
    oracle: float = 0.0


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
        with trace.span("cova.run", root=True) as sp:
            res = self._run(max_frames)
            sp.set(frames=res.num_frames, ranges=self.num_ranges, streams=len(self.streams))
        return res

    def _run(self, max_frames: Optional[int] = None) -> CovaResult:
        cfg = self.cfg
        t = cfg.video.timestep
        f = cfg.compressed.batch_frames
        last = cfg.last or "full"
        host_tracking = cfg.compressed.host_tracking
        demuxers = [s.demux for s in self.streams]
        with trace.span("cova.prepare"):
            if last == "full":
                self._require_pixel_decoder()
            plan = RangePlan.build(demuxers, cfg, max_frames)
            # One native tracker per range and run (its C state is freed
            # when the object goes).
            make_tracker = functools.partial(HostSort, cfg.sort) if host_tracking else HostTracker
            hosts = plan.hosts(cfg, make_tracker, [s.aggregator for s in self.streams])

        start_time = time.perf_counter()
        self.num_chunks = plan.n_chunks
        threads = cfg.parallel.decode_threads
        mh, mw = self.demux.mb_height, self.demux.mb_width

        def step(ri, frame_idx, min_required_frame):
            if last != "track":
                hosts[ri].feed(frame_idx, min_required_frame)

        def host_track(pulled, chunk_i):
            """host_tracking mode: the chunk's bit-packed masks through
            native CC + SORT (csrc/cctrack.cc) per range and window, and
            the selector fed from them."""
            r_, f_, mh_, mw_ = self.stage.masks_shape
            with trace.span("cova.mirror.wait"):
                packed = pulled.numpy()
            with trace.span("cova.mirror.cc"):
                masks = unpack_masks(packed, self.stage.masks_shape)
                ltwh, _, valid = cc_boxes(
                    masks.reshape(r_ * f_, mh_, mw_),
                    cfg.compressed.cc_threshold,
                    HOST_MAX_BOXES,
                )
            ltwh = ltwh.reshape(r_, f_, HOST_MAX_BOXES, 4)
            valid = valid.reshape(r_, f_, HOST_MAX_BOXES)
            with trace.span("cova.mirror.track"):
                for ri, k, frame_idx in plan.live_windows(chunk_i):
                    dets = ltwh[ri, k][valid[ri, k]]
                    step(ri, frame_idx, hosts[ri].tracker.update(dets, float(frame_idx)))

        names = (
            "track_ltwh", "track_id", "track_id_post", "exists",
            "active", "predicted", "death", "death_id", "death_start",
            "death_last_match", "death_tsu", "death_active",
        )

        def host_mirror(pulled, chunk_i):
            """Consume one chunk's packed SortOutputs: HostTracker
            histories/deaths + FrameSelector scheduling per window."""
            with trace.span("cova.mirror.wait"):
                packed = pulled.numpy()
            with trace.span("cova.mirror.track"):
                out_np = unpack_outputs_np(packed, self.stage.packed_shape)
                for ri, k, frame_idx in plan.live_windows(chunk_i):
                    row = types.SimpleNamespace(
                        **{n: getattr(out_np, n)[ri, k] for n in names}
                    )
                    step(ri, frame_idx, hosts[ri].tracker.update(float(frame_idx), row))

        mirror = host_track if host_tracking else host_mirror
        # Software-pipelined chunk loop: while chunk i's outputs cross to
        # the host, the host entropy-decodes chunk i+1 and the device
        # works on it; the host mirror for chunk i runs one iteration
        # later, when its copy has landed.
        timers = StageTimers()

        def run_mirror(pending):
            with trace.timed("cova.mirror") as sp:
                mirror(*pending)
            timers.host_mirror += sp.seconds

        pending_mirror = None  # (_HostCopy, chunk index) awaiting mirror
        for chunk_i in range(plan.n_chunks):
            with trace.timed("cova.entdec", process=True) as dec:
                meta_chunk = np.zeros((self.num_ranges, plan.nf_chunk, mh, mw, 2), np.uint8)
                if cfg.compressed.signed_mv:
                    # zero motion (mv_x=mv_y=8 -> offset 128) in padding
                    meta_chunk[..., 1] = 0x88
                plan.decode_chunk(chunk_i, demuxers, meta_chunk, threads)
            timers.entropy_decode += dec.seconds
            if last == "entdec":
                continue

            with trace.timed("cova.masks") as dev:
                if host_tracking:
                    out = self.stage.run_chunk_masks(meta_chunk)
                else:
                    off = chunk_i * f * cfg.compressed.gamma
                    ts0 = np.full(self.num_ranges, off + t - 1, np.int32)
                    nwin = np.array(plan.chunk_windows(chunk_i), np.int32)
                    out, _, _ = self.stage.run_chunk(meta_chunk, ts0, nwin)
            timers.device_dispatch += dev.seconds
            trace.count("masks.chunks")
            if last in ("mask", "boxes"):
                continue
            pulled = _HostCopy(out)

            if pending_mirror is not None:
                run_mirror(pending_mirror)
            pending_mirror = (pulled, chunk_i)
        if pending_mirror is not None:
            run_mirror(pending_mirror)

        # EOS: flush selectors + trackers, then decode scheduled frames.
        with trace.span("cova.finish"):
            for h in hosts:
                if host_tracking:
                    h.finish()
                else:
                    h.finish(cfg.sort.min_hits)

        pix_jobs = [h.jobs for h in hosts]
        pixel_frames = 0
        if last == "full" and any(pix_jobs):
            self.log(f"pixel stage: {sum(map(len, pix_jobs))} frames scheduled")
            with trace.timed("cova.pixel_stage", process=True) as pix:
                pixel_frames = self._run_pixel_stage(pix_jobs, [sx for sx, _, _ in plan.bounds],
                                                     timers)
            timers.pixel_stage += pix.seconds

        with trace.span("cova.finish"):
            for s in self.streams:
                s.aggregator.terminate()
        elapsed = time.perf_counter() - start_time

        counts = [h.selector.counts for h in hosts]
        return CovaResult(
            num_frames=sum(c for _, _, c in plan.bounds),
            elapsed_seconds=elapsed,
            dropped=sum(c.dropped for c in counts),
            decoded_dependency=sum(c.decoded_dependency for c in counts),
            decoded_inference=sum(c.decoded_inference for c in counts),
            dead_tracks=sum(h.dead for h in hosts),
            pixel_frames=pixel_frames,
            timers=timers,
        )

    def _require_pixel_decoder(self) -> None:
        """The pixel stage needs every stream inside the pixel decoder's
        scope: refuse to start otherwise (pixrec.UnsupportedStreamError),
        rather than skip the stage."""
        for s in self.streams:
            check_stream(s.demux, self.device)

    def _run_pixel_stage(self, jobs_per_range, stream_of_range, timers=None):
        """Selective decode: feed scheduled frames in GoP-prefix order to
        the pixel decoder on the pipeline's device, drop droppable
        (dependency-only) outputs, hand the rest to the stream's
        detector as they are decoded. Ranges decode concurrently, one
        decoder per range (each its own frames; ctypes drops the GIL in
        the syntax decoder)."""
        import concurrent.futures

        # Prefetch bitstream payloads serially: the demuxer's FILE* is
        # seek-position stateful, so only the decoding (the port's own
        # pixel decoder: syntax on the host, kernels K8-K10 on the card)
        # is fanned out to threads.
        with trace.span("cova.pixdec.prefetch"):
            prefetched = []
            for ri, jobs in enumerate(jobs_per_range):
                demux = self.streams[stream_of_range[ri]].demux
                ordered = sorted(jobs, key=lambda x: x.sample_index)
                drop = {fr.sample_index: fr.droppable for fr in ordered}
                # PAFF: one sample = one FIELD; a decoder of field
                # pictures weaves the complementary pair (adjacent
                # samples, opposite parity) into ONE output frame carrying
                # the FIRST field's pts. Decode pairs atomically: pull in
                # the complement of every scheduled field, and keep the
                # woven frame iff EITHER field was scheduled
                # non-droppable. field_parity() is 0 for every
                # progressive/MBAFF sample (frame pictures), so this is a
                # no-op off PAFF streams, which the port's own decoder
                # refuses before the run starts (_require_pixel_decoder).
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

        # Each inference frame goes to its stream's detector as it leaves
        # the decoder (one call a frame, one call at a time), so the stage
        # holds a frame a range, not every frame of the run. Both
        # detectors of the package work frame by frame, and the
        # aggregator groups detections by timestamp, so the CSVs are
        # those of one call over all frames.
        detect_lock = threading.Lock()
        oracle_s = [0.0]
        # The ranges' decode, in threads: each range's span hangs under it.
        stage = trace.timed("cova.pixdec")

        def detect(detector, frame):
            with trace.span("cova.oracle.wait"):
                detect_lock.acquire()
            try:
                with trace.timed("cova.oracle") as sp:
                    got = detector([frame])
                oracle_s[0] += sp.seconds
                trace.count("oracle.frames")
            finally:
                detect_lock.release()
            return got

        def decode_range(args):
            items, sx = args
            if not items:
                return 0, []
            s = self.streams[sx]
            demux = s.demux
            n, dets = 0, []
            droppable_by_pts = {pts: d for _, pts, d in items}
            with trace.span("cova.pixdec.range", parent=stage):
                dec = PixelDecoder(demux.extradata(), device=self.device)

                def drain():
                    nonlocal n
                    got = dec.pop(demux.width, demux.height)
                    while got is not None:
                        pts, y, u, v = got
                        d = droppable_by_pts.get(pts)
                        if d is not None and not d:
                            n += 1
                            if s.detector is not None:
                                # Detector timestamps are seconds (the
                                # aggregator's association domain);
                                # container pts are timescale ticks.
                                dets.extend(detect(
                                    s.detector, (pts / float(demux.timescale), y, u, v)))
                        got = dec.pop(demux.width, demux.height)

                try:
                    for payload, pts, _ in items:
                        dec.send(payload, pts)
                        drain()
                    dec.flush()
                    drain()
                finally:
                    dec.close()
            return n, dets

        workers = max(1, min(len(prefetched), self.cfg.parallel.decode_threads))
        with stage:
            with concurrent.futures.ThreadPoolExecutor(max_workers=workers) as ex:
                per_range = list(ex.map(decode_range, zip(prefetched, stream_of_range)))
        if timers is not None:
            # The detector's calls overlap other ranges' decoding: the
            # decode is the stage's wall time less the detector's.
            timers.oracle += oracle_s[0]
            timers.pixel_decode += stage.seconds - oracle_s[0]

        # Aggregation per stream (independent detector and aggregator
        # state; a solo run is the 1-stream special case).
        total = 0
        for sidx, s in enumerate(self.streams):
            mine = [r for ri, r in enumerate(per_range) if stream_of_range[ri] == sidx]
            n = sum(k for k, _ in mine)
            total += n
            self.log(
                f"pixel stage: decoded {n} inference frames"
                + (f" (stream {sidx})" if len(self.streams) > 1 else "")
            )
            dets = [d for _, ds in mine for d in ds]
            if dets:
                s.aggregator.update_dnn(dets)
        return total

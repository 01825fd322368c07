"""Headline benchmark of the compressed-domain path on one device (the
PyTorch port's counterpart of bench.py):

    python -m cova_tpu_torch.bench [--input V.mp4] [--device cpu]
        [--passes 5] [--device-reps 4] [--sweep 2,4,8,16]

The work split of bench.py, unchanged: the input's GoPs split into R
GoP-aligned ranges (CovaConfig's R=8), decoded in display order by the
shared C++ entropy decoder into wire16 chunks of F+T-1 frames a range
(F=128, T=4) held in two alternating host buffers; each chunk through
`CompressedStage.run_chunk_masks` on --device (metapreprocess + BlobNet +
threshold + bit-pack, the blobnet_demo artifact's input contract,
cc_threshold 3); its packed masks copied back one chunk behind, while
the host entropy-decodes the next chunk; then `unpack_masks` ->
`cc_boxes` -> `HostSort.update_batch` per range, and `finalize`. Every
chunk's masks are pulled and tracked.

On the card the chunk buffers are pinned: a chunk is uploaded without
blocking, and its masks come back without blocking into a pinned buffer
behind a CUDA event made with blocking=True, so the host sleeps in the
wait instead of spinning (a spin would count as process CPU time, the
headline's basis). A buffer is written again two chunks later, after
the host waited for that chunk's event, which the stream records behind
the chunk's upload and masks. A warm-up chunk (zeros, 0x88 in the MV
channel for signed MVs) makes cuDNN's first call before any timing.

Prints ONE JSON line with bench.py's keys:

  value      the median over --passes passes of frames / process CPU
             seconds (the headline, "value_basis": "cpu_time_median");
  wall_fps   the median of frames / wall seconds; passes_fps and
             passes_cpu_fps every pass's rates; stage_seconds the split of
             the pass whose CPU-time rate is the median;
  device_fps the median of 3 device-only passes: every chunk decoded
             beforehand and held in host memory, then --device-reps times
             over them: upload, masks step, pull, two deep; with --sweep,
             device_fps_sweep_by_R at each R;
  cpu_calib_mips  a fixed-work scalar probe before and after the passes.

Process CPU time counts every thread of the process. Each range's
frames decode in order within its GoP and the ranges one after another,
so it is about the wall time here; were the ranges decoded in parallel,
it would not be, and on a host with many cores it is not a one-core
host's basis. bench.py's value_calib_normalized and calib_ref_mips are
left out: their reference speed was pinned on another host, and
re-pinning it on the card's host, or dropping it, is for the benchmark
that defines the cells. `platform` is the torch device type ("cuda" on
the card) and input.device the device's name.

--input defaults to the committed render of the synth scene,
cova_tpu_torch/data/synth_1800.mp4 (1280x720); its 1080p re-encode
synth_1800_1080p.mp4 is beside it. Runs on the card unless --device cpu
is given (then its times are the CPU's, for checking paths only).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import pathlib
import time

import numpy as np
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
SYNTH_RENDER = REPO / "cova_tpu_torch" / "data" / "synth_1800.mp4"
WEIGHTS = REPO / "artifacts" / "blobnet_demo.npz"
# The demo dataset's tuned CC area knob (ACCURACY.md): the bench runs the
# production configuration, not an untuned default.
CC_THRESHOLD = 3
STAGES = ("decode", "dispatch", "pull", "cc", "sort", "elapsed", "cpu")


def bench_cfg(meta: dict):
    """CovaConfig defaults (R=8, F=128, T=4), cc_threshold 3, the weights'
    input contract."""
    from cova_tpu_torch.config import CovaConfig
    from cova_tpu_torch.examples.profile_device import with_weights_contract

    cfg = with_weights_contract(CovaConfig(), meta)
    return dataclasses.replace(
        cfg, compressed=dataclasses.replace(cfg.compressed, cc_threshold=CC_THRESHOLD))


@dataclasses.dataclass
class Ranges:
    """GoP-aligned ranges of a stream: (first sample, samples) a range,
    its windows (samples - T + 1; chunks follow the longest range and a
    shorter one stops contributing), and its display-order sample
    indices."""

    bounds: list
    wmax: list
    disp: list

    def windows(self, off: int, f: int) -> int:
        """Real windows of the chunk that starts at window `off`."""
        return sum(max(0, min(f, wm - off)) for wm in self.wmax)


def make_ranges(demux, nr: int, t: int) -> Ranges:
    """Split `demux`'s GoPs into `nr` contiguous ranges (as
    CovaPipeline._range_bounds does), padded with empty ones: entropy
    decode is sequential within a GoP, so a range that straddled GoPs
    would decode the straddled prefix again."""
    gops = demux.gops()
    per_gop = max(1, math.ceil(len(gops) / nr))
    bounds = []
    for i in range(0, len(gops), per_gop):
        g = gops[i : i + per_gop]
        bounds.append((g[0].first_sample, sum(x.num_samples for x in g)))
    while len(bounds) < nr:
        bounds.append((demux.num_samples, 0))
    bounds = bounds[:nr]
    disp = [demux.display_order(s0, cnt) if cnt else np.zeros(0, np.int32)
            for s0, cnt in bounds]
    return Ranges(bounds, [max(0, c - t + 1) for _, c in bounds], disp)


@dataclasses.dataclass
class Bench:
    """What the passes share: the stream, the configuration, BlobNet on
    the device, the ranges and the stage at cfg's R."""

    path: str
    demux: object
    cfg: object
    model: torch.nn.Module
    device: torch.device
    threads: int
    ranges: Ranges
    stage: object


def fresh_chunk(b: Bench, nr: int) -> torch.Tensor:
    """A zeroed (nr, F+T-1, H, W, 2) u8 wire16 chunk in host memory,
    pinned for the card; zero motion (0x88) in the MV channel when the
    weights take signed MVs."""
    f, t = b.cfg.compressed.batch_frames, b.cfg.video.timestep
    shape = (nr, f + t - 1, b.demux.mb_height, b.demux.mb_width, 2)
    chunk = torch.zeros(shape, dtype=torch.uint8, pin_memory=b.device.type == "cuda")
    if b.cfg.compressed.signed_mv:
        chunk[..., 1] = 0x88
    return chunk


def fill_chunk(b: Bench, chunk: np.ndarray, prev_n: list, off: int, ranges: Ranges) -> None:
    """Entropy-decode the chunk that starts at window `off` into `chunk`
    (a reused buffer), range by range in display order; zero only what
    the buffer's last use (`prev_n` frames a range, updated here) wrote
    beyond the new extent."""
    f, t = b.cfg.compressed.batch_frames, b.cfg.video.timestep
    c = b.cfg.compressed
    for ri, (_, cnt) in enumerate(ranges.bounds):
        count = min(f + t - 1, cnt - off)
        if count <= 0 or off >= ranges.wmax[ri]:
            count = 0
        else:
            b.demux.entropy_decode_packed16(
                ranges.disp[ri][off : off + count], with_nnz=c.use_nnz_channel,
                signed_mv=c.signed_mv, threads=b.threads, out=chunk[ri, :count])
        if count < prev_n[ri]:
            chunk[ri, count : prev_n[ri]] = 0
            if c.signed_mv:
                chunk[ri, count : prev_n[ri], :, :, 1] = 0x88
        prev_n[ri] = count


def upload(b: Bench, chunk: torch.Tensor) -> torch.Tensor:
    """The chunk on the device: a non-blocking copy from pinned memory on
    the card, the host tensor itself on the CPU."""
    return chunk.to(b.device, non_blocking=True)


class _Pull:
    """A reusable host buffer for one chunk's packed masks: on the card a
    non-blocking copy into pinned memory, with a CUDA event recorded
    behind it that `wait` sleeps on (blocking=True) rather than spins."""

    def __init__(self, b: Bench, numel: int):
        cuda = b.device.type == "cuda"
        self.buf = torch.empty(numel, dtype=torch.uint8, pin_memory=cuda)
        self.event = torch.cuda.Event(blocking=True) if cuda else None

    def start(self, packed: torch.Tensor) -> None:
        self.buf.copy_(packed, non_blocking=self.event is not None)
        if self.event is not None:
            self.event.record(torch.cuda.current_stream(packed.device))

    def wait(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.buf.numpy()


def _packed_numel(b: Bench, nr: int) -> int:
    return nr * b.cfg.compressed.batch_frames * b.demux.mb_height * b.demux.mb_width // 8


def _warm(b: Bench, stage) -> None:
    """One zero chunk through `stage` and back, outside any timing: cuDNN
    plans its convolutions on the first call."""
    stage.run_chunk_masks(upload(b, fresh_chunk(b, stage.num_ranges))).cpu()
    if b.device.type == "cuda":
        torch.cuda.synchronize(b.device)


def setup(path, device="cuda") -> Bench:
    """Load the weights onto `device`, open `path`, split it into
    bench_cfg's R ranges, build the stage and warm it up."""
    from cova_tpu_torch.codec import Mp4Demuxer
    from cova_tpu_torch.models.blobnet import load_artifact
    from cova_tpu_torch.pipeline.compressed import CompressedStage

    device = torch.device(device)
    model, _, meta = load_artifact(WEIGHTS, device)
    cfg = bench_cfg(meta)
    demux = Mp4Demuxer(str(path))
    r = cfg.parallel.num_ranges
    b = Bench(str(path), demux, cfg, model, device, min(os.cpu_count() or 8, 16),
              make_ranges(demux, r, cfg.video.timestep),
              CompressedStage(model, cfg, r, device))
    _warm(b, b.stage)
    return b


def one_pass(b: Bench, on_dead=None) -> tuple:
    """One timed pass over the whole input. Returns (frames, wall seconds,
    stage seconds); `on_dead(range, TrackRecord)` receives every track
    the host SORT retires."""
    from cova_tpu_torch.pipeline.compressed import unpack_masks
    from cova_tpu_torch.pipeline.cova import HOST_MAX_BOXES
    from cova_tpu_torch.tracker.host import HostSort, cc_boxes

    cfg, rg, stage = b.cfg, b.ranges, b.stage
    r, f = stage.num_ranges, cfg.compressed.batch_frames
    mh, mw = b.demux.mb_height, b.demux.mb_width
    start, cpu0 = time.perf_counter(), time.process_time()
    stages = dict.fromkeys(STAGES, 0.0)
    trackers = [HostSort(cfg.sort, on_dead=None if on_dead is None
                         else (lambda rec, ri=ri: on_dead(ri, rec)))
                for ri in range(r)]
    bufs = [fresh_chunk(b, r) for _ in (0, 1)]
    pulls = [_Pull(b, _packed_numel(b, r)) for _ in (0, 1)]
    prev_n = [[0] * r, [0] * r]

    def consume(pull, win0):
        t0 = time.perf_counter()
        masks = unpack_masks(pull.wait(), stage.masks_shape)
        stages["pull"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        ltwh, _, valid = cc_boxes(masks.reshape(r * f, mh, mw),
                                  cfg.compressed.cc_threshold, HOST_MAX_BOXES)
        stages["cc"] += time.perf_counter() - t0
        ltwh = ltwh.reshape(r, f, HOST_MAX_BOXES, 4)
        valid = valid.reshape(r, f, HOST_MAX_BOXES)
        t0 = time.perf_counter()
        for ri in range(r):
            nf = min(f, rg.wmax[ri] - win0)
            if nf > 0:
                trackers[ri].update_batch(ltwh[ri, :nf], valid[ri, :nf], float(win0))
        stages["sort"] += time.perf_counter() - t0

    processed, pending = 0, None
    for ci, off in enumerate(range(0, max(rg.wmax), f)):
        chunk, pull = bufs[ci & 1], pulls[ci & 1]
        t0 = time.perf_counter()
        fill_chunk(b, chunk.numpy(), prev_n[ci & 1], off, rg)
        stages["decode"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        pull.start(stage.run_chunk_masks(upload(b, chunk)))
        stages["dispatch"] += time.perf_counter() - t0
        if pending is not None:
            consume(*pending)
        pending = (pull, off)
        processed += rg.windows(off, f)
    if pending is not None:
        consume(*pending)
    for tr in trackers:
        tr.finalize()
    stages["elapsed"] = time.perf_counter() - start
    stages["cpu"] = time.process_time() - cpu0
    return processed, stages["elapsed"], stages


def measure_device_fps(b: Bench, nr: int, reps: int, stage=None) -> tuple:
    """The device-only ceiling at `nr` ranges: every chunk decoded
    beforehand into host memory, then `reps` rounds over them, each chunk
    uploaded, through the masks step and pulled, two deep. Returns the
    median frames/s of 3 passes and the three rates. `stage` reuses a
    warm stage at `nr`; otherwise one is built and warmed."""
    from cova_tpu_torch.pipeline.compressed import CompressedStage

    f = b.cfg.compressed.batch_frames
    rg = make_ranges(b.demux, nr, b.cfg.video.timestep)
    if stage is None:
        stage = CompressedStage(b.model, b.cfg, nr, b.device)
        _warm(b, stage)
    chunks = []
    for off in range(0, max(rg.wmax), f):
        chunk = fresh_chunk(b, nr)
        fill_chunk(b, chunk.numpy(), [0] * nr, off, rg)
        chunks.append((chunk, rg.windows(off, f)))
    pulls = [_Pull(b, _packed_numel(b, nr)) for _ in (0, 1)]

    def device_pass():
        start, frames, pending, k = time.perf_counter(), 0, None, 0
        for _ in range(reps):
            for chunk, nframes in chunks:
                pull = pulls[k & 1]
                k += 1
                pull.start(stage.run_chunk_masks(upload(b, chunk)))
                if pending is not None:
                    pending.wait()
                pending = pull
                frames += nframes
        pending.wait()
        return frames / (time.perf_counter() - start)

    rates = sorted(device_pass() for _ in range(3))
    return rates[1], rates


def cpu_probe() -> float:
    """Fixed-work scalar calibration: 2M LCG iterations of pure-Python
    integer work (branchy scalar code, like the decoder; not numpy, which
    would measure SIMD and bandwidth), in process-CPU seconds. Returns
    million iterations a CPU second."""
    t0 = time.process_time()
    x = 0
    for i in range(2_000_000):
        x = (x * 1103515245 + i) & 0xFFFFFFFF
    return 2.0 / (time.process_time() - t0)


def run(b: Bench, passes: int = 5, device_reps: int = 4, sweep=()) -> dict:
    """The passes, the device ceiling and the optional R sweep; returns
    the JSON record."""
    calib = [cpu_probe()]
    rates, cpu_rates, splits = [], [], []
    for _ in range(passes):
        processed, elapsed, stages = one_pass(b)
        rates.append(processed / elapsed)
        cpu_rates.append(processed / stages["cpu"])
        splits.append(stages)
    wall_fps = sorted(rates)[passes // 2]
    # The headline pass is the one with the median CPU-time rate; the
    # recorded split is the same pass's.
    mid = sorted(range(passes), key=lambda i: cpu_rates[i])[passes // 2]
    fps = cpu_rates[mid]
    calib.append(cpu_probe())
    device_fps, device_rates = measure_device_fps(
        b, b.stage.num_ranges, device_reps, b.stage)
    by_r = {str(nr): measure_device_fps(b, nr, device_reps)[0] for nr in sweep}
    dev_name = (torch.cuda.get_device_name(b.device) if b.device.type == "cuda"
                else "cpu")
    return {
        "metric": "compressed_domain_fps",
        "value": round(fps, 1),
        "unit": "frames/sec",
        "value_basis": "cpu_time_median",
        "wall_fps": round(wall_fps, 1),
        "platform": b.device.type,
        "vs_baseline": round(fps / (30 * 10), 3),
        "passes_fps": [round(x, 1) for x in rates],
        "passes_cpu_fps": [round(x, 1) for x in cpu_rates],
        "cpu_calib_mips": [round(x, 2) for x in calib],
        "stage_seconds": {k: round(v, 3) for k, v in splits[mid].items()},
        "frames_per_pass": processed,
        "device_fps": round(device_fps, 1),
        "device_fps_passes": [round(x, 1) for x in device_rates],
        **({"device_fps_sweep_by_R": {k: round(v, 1) for k, v in by_r.items()}}
           if by_r else {}),
        "input": {"path": b.path, "width": b.demux.width, "height": b.demux.height,
                  "device": dev_name},
    }


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--input", default=str(SYNTH_RENDER), help="an H.264 mp4")
    ap.add_argument("--device", default="cuda", help="torch device (cpu on request)")
    ap.add_argument("--passes", type=int, default=5,
                    help="timed passes over the input (medians)")
    ap.add_argument("--device-reps", type=int, default=4,
                    help="rounds over the decoded chunks a device-only pass")
    ap.add_argument("--sweep", default="",
                    help="comma-separated R values for device_fps_sweep_by_R")
    return ap


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    sweep = [int(x) for x in args.sweep.split(",") if x]
    b = setup(args.input, args.device)
    try:
        out = run(b, max(1, args.passes), max(1, args.device_reps), sweep)
    finally:
        b.demux.close()
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()

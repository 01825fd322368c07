"""The port's benchmark: one run of one cell.

    python3 -m bench_port.run --workload CELL --seed N --seconds S --trace 0|1

A cell of BENCHMARK.json names a configuration (configs/<name>.json) and
a traffic mix (traffic/<name>.json). A run builds the cell's jobs from
the seed, warms up, then runs a closed loop of query jobs for S seconds:
each job is one recorded clip, GoP-rotated, through a fresh
`CovaPipeline(...).run()` of the port (cova_tpu_torch) on the card. Job k
takes the rotation (seed + k) mod (the clip's GoPs), and the window closes
at the end of the first whole cycle of `cycle` jobs (the traffic file's)
that ends after S seconds, so every seed runs the same work in another
order. Then each job's outputs are held to the plain reference
(check.py) and one JSON line is printed: with --trace 0 the cell's
end-to-end metrics, with --trace 1 (the window under torch.profiler) its
per-layer metrics, each read by metrics/<name>.py. A --trace 0 run traces
its window too where one of the cell's end-to-end metrics is read from
the device's trace.

The oracle is the configuration's: `oracle.arch` names its module,
oracles/<arch>.py, which builds the program's detector and the plain
reference and states the oracle's numbers and limits.

Exits non-zero, printing no result, without a CUDA device, and where the
process holds JAX or the JAX package once the window has closed.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
import pathlib
import resource
import shutil
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
HERE = ROOT / "bench_port"
PEAK_FP32 = 67e12  # H100 SXM, float32 outside the tensor cores (data sheet)
# Top-level modules the process that prints a result may not hold: the
# benchmark measures the port alone.
FORBIDDEN = ("jax", "jaxlib", "flax", "cova_tpu")


def set_environment() -> None:
    """Kernel caches at fixed paths inside the checkout (the port builds
    its nvcc libraries and its codec into cova_tpu_torch/build/ itself),
    and the program's own profiler off: the harness traces."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(ROOT / ".bench_cache" / sub)
    os.environ.pop("COVA_PROFILE", None)


def process_age() -> float:
    """Seconds since this process started (from /proc)."""
    with open("/proc/self/stat") as f:
        start = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        up = float(f.read().split()[0])
    return up - start / os.sysconf("SC_CLK_TCK")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def cpu_seconds() -> float:
    """CPU seconds of this process so far, all its threads."""
    r = resource.getrusage(resource.RUSAGE_SELF)
    return r.ru_utime + r.ru_stime


def host_state() -> str:
    """What a run finds on its host: free memory, processes, threads of
    this process, what its temporary directory holds."""
    with open("/proc/meminfo") as f:
        avail = next((ln.split()[1] for ln in f if ln.startswith("MemAvailable")), "?")
    procs = sum(p.isdigit() for p in os.listdir("/proc"))
    with open("/proc/self/status") as f:
        threads = next((ln.split()[1] for ln in f if ln.startswith("Threads")), "?")
    tmp = pathlib.Path(tempfile.gettempdir())
    held = sum(p.stat().st_size for p in tmp.rglob("*") if p.is_file()) if tmp.is_dir() else 0
    return (f"host: {avail} kB available, {procs} processes, {threads} threads here, "
            f"{held} B under {tmp}")


@dataclasses.dataclass
class Job:
    rotation: int
    out_dir: str
    result: object = None
    error: str = ""
    seconds: float = 0.0
    meta: list = dataclasses.field(default_factory=list)
    masks: list = dataclasses.field(default_factory=list)
    masks_shape: tuple = ()
    calls: list = dataclasses.field(default_factory=list)
    frames: list = dataclasses.field(default_factory=list)  # (ts, y, u, v, recs, outputs)
    oracle_s: float = 0.0
    cpu_s: float = 0.0


class Cell:
    """Everything a run of one cell needs, built in set-up."""

    def __init__(self, name: str, seed: int, device: str = "cuda"):
        from bench_port import check, oracles, streams

        bench = json.loads((ROOT / "BENCHMARK.json").read_text())
        self.cell = next(w for w in bench["workloads"] if w["name"] == name)
        self.bench = bench
        self.conf = json.loads((HERE / "configs" / f"{self.cell['config']}.json").read_text())
        self.traffic = json.loads((HERE / "traffic" / f"{self.cell['traffic']}.json").read_text())
        self.seed = seed
        self.device = device
        unknown = set(self.traffic) - {"last", "cycle"}
        if unknown:  # one job at a time, one stream a job: nothing else is driven yet
            raise ValueError(f"traffic keys the generator does not read: {sorted(unknown)}")
        self.last = self.traffic["last"]
        self.cycle = int(self.traffic.get("cycle", 1))
        self.oracle = oracles.load(self.conf)
        self.limits = dict(check.LIMITS)
        if self.last == "full":
            self.limits.update(self.oracle.LIMITS)
        else:
            del self.limits["pictures_off"]

        from cova_tpu_torch.config import CovaConfig
        from cova_tpu_torch.models.blobnet import load_artifact

        self.cfg = CovaConfig.from_dict({**self.conf["pipeline"], "last": self.last})
        _, self.variables, _ = load_artifact(str(ROOT / self.conf["blobnet"]), "cpu")
        self.src = streams.read_mp4(ROOT / self.conf["input"])
        self.gops = [len(g) for g in self.src.gops()]
        self.tmp = pathlib.Path(tempfile.mkdtemp(prefix="bench_port_"))
        self.paths, self.rotations, self.samples = {}, {}, {}
        for r in range(len(self.gops)):
            p = self.tmp / f"rot{r}.mp4"
            self.rotations[r] = streams.write_rotated(self.src, p, r)
            self.paths[r] = str(p)
            self.samples[r] = streams.read_mp4(p).samples
        self.detector = None
        if self.last == "full":
            self.detector = self.oracle.Program(self.conf["oracle"], seed, device)

    def job(self, k: int, rotation: int, max_frames=None) -> Job:
        import torch
        from torch.profiler import record_function

        from cova_tpu_torch.pipeline.cova import CovaPipeline

        job = Job(rotation, str(self.tmp / f"job{k}"))
        oracle = None
        if self.detector is not None:
            def oracle(frames):
                recs = []
                for fr in frames:
                    with record_function("bench.oracle"):
                        t = time.perf_counter()
                        got = self.detector([fr])
                        job.oracle_s += time.perf_counter() - t
                    job.frames.append((*fr, got, self.detector.take()))
                    recs += got
                return recs

        cpu0 = cpu_seconds()
        t0 = time.perf_counter()
        try:
            with record_function("bench.job"):
                pipe = CovaPipeline(self.paths[rotation], job.out_dir, self.cfg,
                                    variables=self.variables, detector=oracle,
                                    log=lambda *a: None, device=self.device)
                self._wrap(pipe, job)
                job.result = pipe.run(max_frames)
                job.masks_shape = pipe.stage.masks_shape
                if torch.device(self.device).type == "cuda":
                    torch.cuda.synchronize()
        except Exception as e:  # a job that fails counts as failed, and the run goes on
            job.error = f"{type(e).__name__}: {e}"
            log(f"job {k} failed: {job.error}")
        job.seconds = time.perf_counter() - t0
        job.cpu_s = cpu_seconds() - cpu0
        return job

    @staticmethod
    def _wrap(pipe, job: Job) -> None:
        """Mark the layers' calls with record_function ranges and keep
        what each produced for the check."""
        from torch.profiler import record_function

        stage, demux, agg = pipe.stage, pipe.streams[0].demux, pipe.streams[0].aggregator
        masks, entdec, pixel = stage.run_chunk_masks, demux.entropy_decode_packed16, \
            pipe._run_pixel_stage

        def run_chunk_masks(meta):
            with record_function("bench.masks"):
                out = masks(meta)
            job.meta.append(meta)
            job.masks.append(out)
            return out

        def entropy_decode_packed16(*a, **kw):
            with record_function("bench.entdec"):
                return entdec(*a, **kw)

        def run_pixel_stage(*a, **kw):
            with record_function("bench.pixel_stage"):
                return pixel(*a, **kw)

        stage.run_chunk_masks = run_chunk_masks
        demux.entropy_decode_packed16 = entropy_decode_packed16
        pipe._run_pixel_stage = run_pixel_stage
        for name in ("set_ranges", "submit_track", "update_dnn"):
            method = getattr(agg, name)

            def record(*a, _m=method, _n=name):
                job.calls.append((_n, a))
                return _m(*a)

            setattr(agg, name, record)

    def warm_up(self) -> None:
        """One job on a one-GoP prefix of every range, then the pixel
        decoder and the oracle once more, so that builds, cuDNN's plans
        and first uses fall before the window."""
        import torch

        job = self.job(-1, self.seed % len(self.gops), max_frames=self.gops[0])
        if job.error:
            raise RuntimeError(f"warm-up job failed: {job.error}")
        if self.last == "full":
            from cova_tpu_torch.codec import Mp4Demuxer, PixelDecoder

            d = Mp4Demuxer(self.paths[0])
            dec = PixelDecoder(d.extradata(), device=self.device)
            got = None
            for i in range(4):
                dec.send(d.read_sample(i), d.sample(i).pts)
                got = got or dec.pop(d.width, d.height)
            dec.flush()
            got = got or dec.pop(d.width, d.height)
            dec.close()
            d.close()
            pts, y, u, v = got
            self.detector([(pts / d.timescale, y, u, v)])
            self.detector.take()
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize()


def job_line(k: int, job: Job) -> str:
    """A job's wall time beside its stages' host clocks and its CPU."""
    parts = ""
    if job.result is not None:
        tm = job.result.timers
        parts = (f" entdec {tm.entropy_decode:.3f} mirror {tm.host_mirror:.3f} "
                 f"pixdec {tm.pixel_decode:.3f} oracle {tm.oracle:.3f}")
    return f"job {k} rot {job.rotation}: {job.seconds:.3f} s{parts} cpu {job.cpu_s:.3f} s"


def window(cell: Cell, seconds: float) -> tuple:
    jobs, k = [], 0
    t0 = time.perf_counter()
    while True:
        jobs.append(cell.job(k, (cell.seed + k) % len(cell.gops)))
        log(job_line(k, jobs[-1]))
        k += 1
        if k % cell.cycle == 0 and time.perf_counter() - t0 >= seconds:
            break
    return jobs, time.perf_counter() - t0


def compare(cell: Cell, jobs: list) -> dict:
    """Each job's outputs against the plain reference (check.py)."""
    import torch

    from bench_port import check, digests
    from bench_port.ref import blobnet_ref

    expected = json.loads((HERE / "ref" / "expected" / f"{cell.conf['name']}.json").read_text())
    clip = pathlib.Path(cell.conf["input"]).stem
    pictures = json.loads((HERE / "ref" / "pictures" / f"{clip}.json").read_text())["frames"]
    cc = cell.conf["pipeline"]["compressed"]
    f = cell.cfg.compressed.batch_frames
    t = cell.cfg.video.timestep
    g = cell.cfg.compressed.gamma
    thr = cell.cfg.compressed.mask_threshold
    n = {k: 0 for k in cell.limits if k in check.LIMITS}
    n["mask_gap"] = 0.0
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    blob = blobnet_ref.load(ROOT / cell.conf["blobnet"], cell.device)
    probs_of, outputs_of = {}, {}
    oracle_frames = []
    mask_bits = 0
    for job in jobs:
        if job.error:
            n["jobs_failed"] += 1
            continue
        rot = cell.rotations[job.rotation]
        exp = expected["rotations"][str(job.rotation)]
        bounds = check_bounds(cell, job.rotation)
        range_pts = check.display_pts(cell.samples[job.rotation], bounds)
        # Every chunk the clip's ranges need has to have been captured:
        # one that went round the capture is off, its frames with it.
        due = check.chunk_frames([c for _, c in bounds], f, t, g)
        n["chunks_off"] += abs(len(job.meta) - len(due)) + abs(len(job.masks) - len(due))
        n["metadata_frames_off"] += sum(map(sum, due[len(job.meta):]))
        n["metadata_frames_off"] += check.metadata_off(job.meta, range_pts, rot,
                                                       expected["metadata"], f, t)
        if len(probs_of.get(job.rotation, ())) < len(job.meta):
            probs_of[job.rotation] = [blobnet_ref.chunk_probs(blob, m, t, cc["use_nnz_channel"],
                                                              cc["signed_mv"], cell.device)
                                      for m in job.meta]
        for c, packed in enumerate(job.masks):
            bits = check.unpack_bits(packed, job.masks_shape)
            mask_bits += int(bits.sum())
            gap, _ = check.mask_gap(bits, probs_of[job.rotation][c],
                                    check.live_windows(range_pts, c, f, t), thr)
            n["mask_gap"] = max(n["mask_gap"], gap)
        res = job.result
        sched = {k: getattr(res, k) for k in ("decoded_dependency", "decoded_inference",
                                              "dropped", "dead_tracks")}
        n["schedule_jobs_off"] += any(sched[k] != exp[k] for k in sched)
        tracks = [a for name, a in job.calls if name == "submit_track"]
        n["track_jobs_off"] += digests.track_calls(tracks) != exp["tracks"]
        if cell.last == "full":
            ts_scale = cell.src.timescale
            seen = sorted(int(round(fr[0] * ts_scale)) for fr in job.frames)
            n["schedule_jobs_off"] += seen != exp["inference_pts"]
            for ts, y, u, v, recs, outs in job.frames:
                pts = int(round(ts * ts_scale))
                n["pictures_off"] += digests.picture(y, u, v) != pictures[
                    str(rot.source_pts(pts))]
                oracle_frames.append(((job.rotation, pts), y, u, v, recs, outs))
        ref_csvs = check.replay_csvs(job.calls, job.out_dir + ".ref")
        n["csv_files_off"] += check.csv_files_off(job.out_dir, ref_csvs)
    if cell.detector is not None:
        reference = cell.oracle.Reference(cell.conf["oracle"], cell.detector.weights, cell.device)
        n.update(check.oracle_numbers(cell.oracle, reference, oracle_frames, outputs_of))
    log(f"compared: {len(jobs)} jobs, {mask_bits} mask bits set, "
        f"{sum(len(f[4]) for f in oracle_frames)} detections, "
        f"{len(outputs_of)} distinct oracle frames")
    return n


def cell_metrics(cell: Cell, kind: str) -> list:
    """The metrics of BENCHMARK.json's list `kind` ("end_to_end" or
    "per_layer") that this cell reports: those with no `workloads` key,
    and those whose `workloads` name it."""
    return [m for m in cell.bench[kind]
            if "workloads" not in m or cell.cell["name"] in m["workloads"]]


def read_metrics(cell: Cell, specs: list, jobs, window_s, tr, setup_s=None) -> tuple:
    """The metrics `specs` from metrics/<name>.py, each given the run's
    counts, host timers, set-up seconds and trace; the breakdown of the
    trace."""
    from bench_port import flops

    grid = cell.conf["input_grid"]
    t = cell.cfg.video.timestep
    ok = [j for j in jobs if not j.error]
    windows = sum(max(0, c - t + 1) for j in ok
                  for _, c in check_bounds(cell, j.rotation))
    oracle_frames = sum(len(j.frames) for j in ok)
    run = dict(
        cell=cell, jobs=ok, window_s=window_s, trace=tr, peak_flops=PEAK_FP32, setup_s=setup_s,
        frames=sum(j.result.num_frames for j in ok),
        chunks=sum(len(j.masks) for j in ok),
        pictures=sum(j.result.decoded_dependency + j.result.decoded_inference for j in ok),
        oracle_frames=oracle_frames,
        model_flops=windows * flops.blobnet(grid[1], grid[0])
        + oracle_frames * cell.oracle.flops(),
    )
    out = {}
    for m in specs:
        spec = importlib.util.spec_from_file_location(
            f"bench_port_metric_{len(out)}", HERE / "metrics" / f"{m['name']}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        v = mod.read(run)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    breakdown = None
    if tr is not None and tr.ranges:
        lo = min(s for s, _, n, _ in tr.ranges if n == "bench.job")
        hi = max(e for _, e, n, _ in tr.ranges if n == "bench.job")
        gaps = sorted(tr.gaps(lo, hi), key=lambda g: g[0] - g[1])[:10]
        breakdown = {
            "device_ops": [[n, s / 1e6] for n, s in tr.by_name()[:10]],
            "idle_gaps": [[tr.host_at((a + b) / 2), (b - a) / 1e6] for a, b in gaps],
        }
    return out, breakdown, run


def check_bounds(cell: Cell, rotation: int):
    from bench_port import check

    return check.range_bounds([cell.gops[(rotation + i) % len(cell.gops)]
                               for i in range(len(cell.gops))], cell.cfg.parallel.num_ranges)


def power_limit() -> str:
    import subprocess

    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_environment()

    import torch

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell_spec = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if cell_spec is None:
        log(f"no cell {args.workload!r} in BENCHMARK.json")
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell_spec["chips"]:
        log(f"needs {cell_spec['chips']} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    log(f"card: {power_limit()}")
    log(host_state())
    t_cuda = process_age()
    cell = Cell(args.workload, args.seed)
    t_cell = process_age()
    cell.warm_up()
    torch.cuda.reset_peak_memory_stats()
    setup_s = process_age()
    log(f"set-up {setup_s:.3f} s: to the card {t_cuda:.3f}, the cell's streams and weights "
        f"{t_cell - t_cuda:.3f}, the warm-up {setup_s - t_cell:.3f}")

    specs = cell_metrics(cell, "per_layer" if args.trace else "end_to_end")
    trace_path = None
    if args.trace or any(m["source"] == "device_trace" for m in specs):
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            jobs, window_s = window(cell, args.seconds)
        trace_path = str(cell.tmp / "trace.json")
        prof.export_chrome_trace(trace_path)
    else:
        jobs, window_s = window(cell, args.seconds)
    peak = torch.cuda.max_memory_allocated()
    frames = sum(j.result.num_frames for j in jobs if not j.error)
    log(f"window {window_s:.3f} s, {len(jobs)} jobs, {frames} frames, "
        f"jobs {[round(j.seconds, 3) for j in jobs]}")
    log(host_state())

    tr = None
    if trace_path is not None:
        from bench_port.trace import Trace

        tr = Trace.load(trace_path)
    metrics, breakdown, _ = read_metrics(cell, specs, jobs, window_s, tr, setup_s)
    if not args.trace:
        breakdown = None
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
              "memory_peak_bytes": int(peak)}
    if args.trace:
        device["busy_s"] = tr.busy_us() / 1e6
        device["window_s"] = window_s

    from bench_port import check

    t = time.perf_counter()
    numbers = compare(cell, jobs)
    correct = check.verdict(numbers, cell.limits)
    log(f"check {time.perf_counter() - t:.3f} s")
    out = {"correct": correct, "attempted": len(jobs),
           "failed": sum(bool(j.error) for j in jobs), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checked"] = {k: {"value": v, "limit": cell.limits[k]} for k, v in numbers.items()}
    for line in check.lines(numbers, cell.limits):
        log(line)
    shutil.rmtree(cell.tmp, ignore_errors=True)
    held = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if held:
        log(f"the process holds {held}: the benchmark measures the port alone")
        return 4
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

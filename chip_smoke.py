#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (cova_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds every CUDA kernel of the port from the sources in the checkout,
holds each kernel against its plain PyTorch version on the card, drives
one chunk of the compressed stage at production shape, and then the
port's `CovaPipeline` (host_tracking=False) end to end on a generated
1280x736 PAFF clip, counting the kernel launches that pipeline run made.
Every phase raises on failure; nothing falls back to the CPU. Without a
CUDA device, or without the repository beside it, it exits non-zero and
prints no result.

Output: one line per measurement, then a JSON line with the kernels'
launches, errors and times, the card's name and power limit from
nvidia-smi, and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
It imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time

REPO = pathlib.Path(__file__).resolve().parent
SEED = 0

# The kernels of the slice: (name, route, source, TPU kernel it replaces).
KERNELS = {
    "cc_label": (
        "cuda",
        "cova_tpu_torch/csrc/cc_kernel.cu",
        "cova_tpu/ops/pallas/cc_kernel.py:34",
    ),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = 5) -> float:
    """Median milliseconds of `fn()` over `reps` runs after one warm-up,
    each timed with CUDA events around the call."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def phase0_environment() -> str:
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[0] card: {smi}")
    log(
        f"[0] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}"
    )
    log(
        "[0] codec: the port builds libcovacodec from cova_tpu/csrc with "
        "pixdec.cc replaced by cova_tpu_torch/csrc/pixdec_stub.cc (no "
        "libavcodec); the pipeline stops after frame selection (last=select)"
    )
    return smi


def phase1_build() -> None:
    from cova_tpu_torch import codec
    from cova_tpu_torch.ops.cuda import _build

    for _, source, _ in KERNELS.values():
        unit = pathlib.Path(source).stem
        t0 = time.perf_counter()
        _build.build(unit, verbose=True)
        log(f"[1] built {source} in {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    codec.lib()
    log(f"[1] built libcovacodec in {time.perf_counter() - t0:.3f} s")


def _spiral(h: int = 45, w: int = 80):
    import numpy as np

    mask = np.zeros((h, w), bool)
    mask[0, :] = True
    mask[:, w - 1] = True
    mask[h - 1, 2:] = True
    mask[4:h, 2] = True
    mask[4, 2 : w - 10] = True
    return mask


def phase2_kernels() -> dict:
    """Every CC kernel case against the plain version, labels exactly
    equal. Returns the JSON record of the kernel (without launches)."""
    import numpy as np
    import torch

    from cova_tpu_torch.ops.cuda.cc_kernel import (
        connected_components,
        connected_components_plain,
    )

    rng = np.random.default_rng(SEED)
    cases = []
    for p in (0.05, 0.3, 0.6):
        cases.append((f"B=1024 45x80 p={p}", rng.uniform(size=(1024, 45, 80)) < p))
    cases.append(("B=1024 46x80 p=0.05", rng.uniform(size=(1024, 46, 80)) < 0.05))
    cases.append(("B=1024 68x120 p=0.3", rng.uniform(size=(1024, 68, 120)) < 0.3))
    cases.append(("spiral 45x80", _spiral()[None]))
    cases.append(("empty+full 45x80", np.stack([np.zeros((45, 80), bool),
                                                np.ones((45, 80), bool)])))
    timed = {}
    max_err = 0
    for label, m in cases:
        masks = torch.from_numpy(m).cuda()
        got = connected_components(masks)
        ref = connected_components_plain(masks)
        torch.cuda.synchronize()
        if got.dtype != torch.int32 or got.shape != masks.shape:
            raise AssertionError(f"{label}: bad output {got.dtype} {tuple(got.shape)}")
        err = int((got.long() - ref.long()).abs().max())
        max_err = max(max_err, err)
        if not torch.equal(got, ref):
            raise AssertionError(f"{label}: kernel labels differ from plain (max {err})")
        line = f"[2] {label}: labels equal"
        if masks.shape[0] == 1024:
            k_ms = cuda_ms(lambda: connected_components(masks))
            p_ms = cuda_ms(lambda: connected_components_plain(masks))
            timed[label] = (k_ms, p_ms)
            line += f", kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms"
        log(line)
    log(f"[2] cc_label launches so far: {connected_components.launches}")
    k_ms, p_ms = timed["B=1024 45x80 p=0.05"]
    route, source, replaces = KERNELS["cc_label"]
    return {
        "name": "cc_label", "route": route, "source": source,
        "replaces": replaces, "max_abs_err": max_err,
        "ms": k_ms, "plain_ms": p_ms,
    }


def _demo_weights(device):
    from cova_tpu_torch.models.blobnet import load_artifact

    return load_artifact(REPO / "artifacts" / "blobnet_demo.npz", device)


def _cfg_from_meta(meta, **compressed):
    from cova_tpu_torch.config import CovaConfig

    cfg = CovaConfig()
    return dataclasses.replace(
        cfg,
        compressed=dataclasses.replace(
            cfg.compressed,
            use_nnz_channel=bool(meta["use_nnz_channel"]),
            signed_mv=bool(meta["signed_mv"]),
            host_tracking=False,
            **compressed,
        ),
    )


def phase3_compressed_stage() -> None:
    """One production chunk (R=8, F=128, T=4, 45x80) of seeded wire16
    bytes through CompressedStage.run_chunk on the card; then a small
    chunk checked stage by stage against the CPU."""
    import numpy as np
    import torch

    from cova_tpu_torch.ops.cc import mask_to_boxes
    from cova_tpu_torch.pipeline.compressed import (
        CompressedStage,
        compressed_probs,
        track_chunk,
    )
    from cova_tpu_torch.tracker.sort import sort_init

    dev = torch.device("cuda")
    model, _, meta = _demo_weights(dev)
    cfg = _cfg_from_meta(meta)
    r, f, t = 8, cfg.compressed.batch_frames, cfg.video.timestep
    rng = np.random.default_rng(SEED)
    chunk = rng.integers(0, 256, size=(r, f + t - 1, 45, 80, 2), dtype=np.uint8)
    ts0 = np.full(r, t - 1, np.int32)
    stage = CompressedStage(model, cfg, r, dev)
    # The stage's parts at this shape, each warmed up first (cuDNN
    # plans), then the whole chunk once: SORT takes the rest.
    md = torch.as_tensor(chunk, device=dev)
    thr = cfg.compressed.mask_threshold
    front_ms = cuda_ms(lambda: compressed_probs(model, cfg, md), reps=3)
    m = compressed_probs(model, cfg, md) > thr
    boxes_ms = cuda_ms(lambda: mask_to_boxes(m, cfg.compressed.cc_threshold), reps=3)
    t0 = time.perf_counter()
    packed, masks, boxes = stage.run_chunk(chunk, ts0)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if tuple(packed.shape) != stage.packed_shape or packed.dtype != torch.uint8:
        raise AssertionError(f"packed {tuple(packed.shape)} != {stage.packed_shape}")
    if not bool(torch.isfinite(boxes.ltwh).all()):
        raise AssertionError("non-finite boxes")
    log(
        f"[3] compressed stage chunk R={r} F={f} T={t} 45x80: {dt * 1e3:.3f} ms, "
        f"{int(boxes.valid.sum())} valid boxes, {int(masks.sum())} mask pixels"
    )
    log(
        f"[3] of which metapreprocess+BlobNet {front_ms:.3f} ms, CC+box stats "
        f"{boxes_ms:.3f} ms, SORT+pack (the rest) {dt * 1e3 - front_ms - boxes_ms:.3f} ms"
    )

    # Small chunk, card against CPU: probabilities within 1e-4 (cuDNN
    # sums in another order), boxes from the card's masks exactly equal
    # to the plain labelling's, SORT integer outputs exactly equal.
    rs, fs = 2, 16
    small = chunk[:rs, : fs + t - 1]
    cpu = torch.device("cpu")
    model_cpu, _, _ = _demo_weights(cpu)
    p_gpu = compressed_probs(model, cfg, torch.from_numpy(small).to(dev))
    p_cpu = compressed_probs(model_cpu, cfg, torch.from_numpy(small))
    perr = float((p_gpu.cpu() - p_cpu).abs().max())
    if not perr <= 1e-4:
        raise AssertionError(f"BlobNet card vs CPU: max abs err {perr}")
    m_gpu = p_gpu > cfg.compressed.mask_threshold
    b_gpu = mask_to_boxes(m_gpu, cfg.compressed.cc_threshold)
    b_cpu = mask_to_boxes(m_gpu.cpu(), cfg.compressed.cc_threshold)
    for name in ("ltwh", "valid", "area"):
        if not torch.equal(getattr(b_gpu, name).cpu(), getattr(b_cpu, name)):
            raise AssertionError(f"boxes.{name}: card differs from CPU")
    ts = torch.full((rs,), t - 1, dtype=torch.int32)
    nwin = torch.full((rs,), fs, dtype=torch.int32)
    mt = cfg.sort.max_tracks
    _, o_gpu = track_chunk(sort_init(mt, rs, dev), b_gpu, ts.to(dev), nwin.to(dev),
                           cfg.compressed.gamma, cfg.sort)
    _, o_cpu = track_chunk(sort_init(mt, rs, cpu), b_cpu, ts, nwin,
                           cfg.compressed.gamma, cfg.sort)
    for name in ("track_id", "track_id_post", "exists", "active", "death"):
        if not torch.equal(getattr(o_gpu, name).cpu(), getattr(o_cpu, name)):
            raise AssertionError(f"SORT {name}: card differs from CPU")
    lerr = float((o_gpu.track_ltwh.cpu() - o_cpu.track_ltwh).abs().max())
    log(
        f"[3] small chunk R={rs} F={fs}: probs max err {perr:.3g}, boxes equal, "
        f"SORT ids/flags equal, track_ltwh max err {lerr:.3g}"
    )


def _paff_clip(tmp: pathlib.Path, frames: int) -> pathlib.Path:
    from cova_tpu_torch.utils.mp4loop import mux_rec_to_mp4

    spec = importlib.util.spec_from_file_location(
        "paff_gen", REPO / "cova_tpu" / "csrc" / "tools" / "paff_gen.py"
    )
    pg = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(pg)
    rec = tmp / "paff.rec"
    mp4 = tmp / "paff.mp4"
    pg.scenario_pipeline(80, 46, frames, 30).write_rec(str(rec))
    mux_rec_to_mp4(str(rec), str(mp4))
    return mp4


def phase4_pipeline() -> dict:
    """CovaPipeline(device="cuda") end to end; returns launch counts."""
    import torch

    from cova_tpu_torch.codec import Mp4Demuxer
    from cova_tpu_torch.config import ParallelConfig, SortConfig
    from cova_tpu_torch.ops.cuda.cc_kernel import connected_components
    from cova_tpu_torch.pipeline.cova import CovaPipeline

    with tempfile.TemporaryDirectory() as td:
        tmp = pathlib.Path(td)
        t0 = time.perf_counter()
        mp4 = _paff_clip(tmp, 1200)
        samples = Mp4Demuxer(str(mp4)).num_samples
        log(f"[4] PAFF clip 1280x736, {samples} field samples, made in "
            f"{time.perf_counter() - t0:.3f} s")
        _, sd, meta = _demo_weights("cpu")
        cfg = _cfg_from_meta(meta)
        cfg = dataclasses.replace(
            cfg,
            sort=SortConfig(min_hits=3, max_age=10),
            parallel=ParallelConfig(num_ranges=8),
            last="select",
        )
        out = tmp / "out"
        pipe = CovaPipeline(str(mp4), str(out), cfg, sd, device="cuda", log=log)
        pipe.warmup()
        torch.cuda.synchronize()
        connected_components.launches = 0
        res = pipe.run()
        torch.cuda.synchronize()
        launches = {"cc_label": connected_components.launches}
        n_chunks = pipe.num_chunks
        tm = res.timers
        log(
            f"[4] pipeline: {res.num_frames} frames in {res.elapsed_seconds:.3f} s, "
            f"{n_chunks} chunks, dead tracks {res.dead_tracks}, "
            f"decode filter rate {res.decode_filter_rate:.4f}, "
            f"inference filter rate {res.inference_filter_rate:.4f}"
        )
        log(
            f"[4] StageTimers: entropy_decode {tm.entropy_decode:.3f} s, "
            f"device_dispatch {tm.device_dispatch:.3f} s, "
            f"host_mirror {tm.host_mirror:.3f} s, pixel_stage {tm.pixel_stage:.3f} s"
        )
        if res.num_frames != samples:
            raise AssertionError(f"num_frames {res.num_frames} != {samples} samples")
        if res.dead_tracks <= 0:
            raise AssertionError("no dead tracks reported")
        for name in ("track", "dnn", "assoc", "stationary"):
            if not (out / f"{name}.csv").exists():
                raise AssertionError(f"{name}.csv missing")
        rows = (out / "track.csv").read_text().strip().splitlines()
        if len(rows) < 2:
            raise AssertionError("track.csv has no rows")
        log(f"[4] track.csv rows: {len(rows) - 1}, cc_label launches {launches}")
        if launches["cc_label"] < n_chunks:
            raise AssertionError(
                f"cc_label launched {launches['cc_label']} times for {n_chunks} chunks"
            )
    return launches


def main() -> int:
    if not (REPO / "cova_tpu_torch").is_dir() or not (REPO / "cova_tpu").is_dir():
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs only on a GPU",
              file=sys.stderr)
        return 1
    smi = phase0_environment()
    phase1_build()
    record = phase2_kernels()
    phase3_compressed_stage()
    launches = phase4_pipeline()
    record["launches"] = launches["cc_label"]
    kernels = [{k: record[k] for k in (
        "name", "route", "source", "replaces", "launches", "max_abs_err",
        "ms", "plain_ms")}]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (cova_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases:
  0  the card, the software versions;
  1  builds every CUDA kernel of the port from the sources in the
     checkout, and the port's codec library;
  2  holds each kernel against its plain PyTorch version on the card;
  3  the all-device compressed stage on a seeded chunk (R=8, T=4), parts
     at F=128, the whole stage at F=16, a small chunk against the CPU;
  4  `CovaPipeline` (host_tracking=False) end to end on a generated
     1280x736 PAFF clip, counting the kernel launches that run made;
  5  the host-tracking masks step (`run_chunk_masks`) timed at R=8,
     F=128 on 45x80 and 68x120, and a sub-chunk against the CPU;
  6  the default `CovaPipeline` (host_tracking=True) on the same clip,
     its CSVs byte-identical to the port's run on the CPU.
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


def _cfg_from_meta(meta, host_tracking=False):
    """CovaConfig defaults with the artifact's metadata channels."""
    from cova_tpu_torch.config import CovaConfig

    cfg = CovaConfig()
    return dataclasses.replace(
        cfg,
        compressed=dataclasses.replace(
            cfg.compressed,
            use_nnz_channel=bool(meta["use_nnz_channel"]),
            signed_mv=bool(meta["signed_mv"]),
            host_tracking=host_tracking,
        ),
    )


def phase3_compressed_stage() -> None:
    """A chunk of seeded wire16 bytes (R=8, T=4, 45x80) through
    CompressedStage.run_chunk on the card: BlobNet and CC+box stats timed
    at the production F=128, the whole stage (its device SORT is
    host-bound: about 1.5 s a window on this saturated input) at F=16;
    then a small chunk checked stage by stage against the CPU."""
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
    thr = cfg.compressed.mask_threshold

    def parts_ms(md):
        """metapreprocess+BlobNet and CC+box stats ms on a device chunk,
        each warmed up first (cuDNN plans)."""
        front = cuda_ms(lambda: compressed_probs(model, cfg, md), reps=3)
        m = compressed_probs(model, cfg, md) > thr
        return front, cuda_ms(lambda: mask_to_boxes(m, cfg.compressed.cc_threshold), reps=3)

    front_ms, boxes_ms = parts_ms(torch.as_tensor(chunk, device=dev))
    log(
        f"[3] R={r} F={f} T={t} 45x80: metapreprocess+BlobNet {front_ms:.3f} ms, "
        f"CC+box stats {boxes_ms:.3f} ms"
    )
    # The whole stage once at F=16: SORT takes the rest.
    fw = 16
    part = chunk[:, : fw + t - 1]
    front_ms, boxes_ms = parts_ms(torch.as_tensor(part, device=dev))
    t0 = time.perf_counter()
    packed, masks, boxes = stage.run_chunk(part, ts0)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if tuple(packed.shape) != stage.packed_shape or packed.dtype != torch.uint8:
        raise AssertionError(f"packed {tuple(packed.shape)} != {stage.packed_shape}")
    if not bool(torch.isfinite(boxes.ltwh).all()):
        raise AssertionError("non-finite boxes")
    log(
        f"[3] compressed stage chunk R={r} F={fw} T={t} 45x80: {dt * 1e3:.3f} ms, "
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


def _pipeline_cfg(meta, host_tracking):
    from cova_tpu_torch.config import ParallelConfig, SortConfig

    return dataclasses.replace(
        _cfg_from_meta(meta, host_tracking),
        sort=SortConfig(min_hits=3, max_age=10),
        parallel=ParallelConfig(num_ranges=8),
        last="select",
    )


CSVS = ("track", "dnn", "assoc", "stationary")


def _run_pipeline(tag, mp4, out, cfg, sd, device, samples):
    """Warm up, zero the kernels' launch counts, run CovaPipeline once,
    check its output and log it. Returns (result, launch counts, number
    of chunks)."""
    import torch

    from cova_tpu_torch.ops.cuda.cc_kernel import connected_components
    from cova_tpu_torch.pipeline.cova import CovaPipeline

    pipe = CovaPipeline(str(mp4), str(out), cfg, sd, device=device, log=log)
    if device == "cuda":
        pipe.warmup()
        torch.cuda.synchronize()
    connected_components.launches = 0
    res = pipe.run()
    if device == "cuda":
        torch.cuda.synchronize()
    launches = {"cc_label": connected_components.launches}
    tm = res.timers
    log(
        f"[{tag}] pipeline on {device}: {res.num_frames} frames in "
        f"{res.elapsed_seconds:.3f} s ({res.num_frames / res.elapsed_seconds:.1f} "
        f"frames/s), {pipe.num_chunks} chunks, dead tracks {res.dead_tracks}, "
        f"decode filter rate {res.decode_filter_rate:.4f}, "
        f"inference filter rate {res.inference_filter_rate:.4f}"
    )
    log(
        f"[{tag}] StageTimers: entropy_decode {tm.entropy_decode:.3f} s, "
        f"device_dispatch {tm.device_dispatch:.3f} s, "
        f"host_mirror {tm.host_mirror:.3f} s, pixel_stage {tm.pixel_stage:.3f} s"
    )
    if res.num_frames != samples:
        raise AssertionError(f"num_frames {res.num_frames} != {samples} samples")
    if res.dead_tracks <= 0:
        raise AssertionError("no dead tracks reported")
    for name in CSVS:
        if not (out / f"{name}.csv").exists():
            raise AssertionError(f"{name}.csv missing")
    rows = (out / "track.csv").read_text().strip().splitlines()
    if len(rows) < 2:
        raise AssertionError("track.csv has no rows")
    log(f"[{tag}] track.csv rows: {len(rows) - 1}, launches {launches}")
    return res, launches, pipe.num_chunks


def phase4_pipeline(mp4, samples, tmp) -> tuple:
    """CovaPipeline(device="cuda") with host_tracking=False end to end;
    returns (result, launch counts)."""
    _, sd, meta = _demo_weights("cpu")
    res, launches, n_chunks = _run_pipeline(
        "4", mp4, tmp / "out4", _pipeline_cfg(meta, False), sd, "cuda", samples
    )
    if launches["cc_label"] < n_chunks:
        raise AssertionError(
            f"cc_label launched {launches['cc_label']} times for {n_chunks} chunks"
        )
    return res, launches


def phase5_masks_step() -> None:
    """The host-tracking device step, run_chunk_masks, on a seeded
    production chunk (R=8, F=128, T=4) at 45x80 and 68x120: its time, and
    a sub-chunk (R=2, F=16) against the port on the CPU, packed bytes
    equal except at pixels whose CPU probability lies within 1e-4 of the
    threshold."""
    import numpy as np
    import torch

    from cova_tpu_torch.models.blobnet import load_artifact
    from cova_tpu_torch.pipeline.compressed import (
        CompressedStage,
        compressed_masks_step,
        compressed_probs,
        unpack_masks,
    )

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    for weights, (h, w) in (("blobnet_demo.npz", (45, 80)),
                            ("blobnet_demo1080.npz", (68, 120))):
        model, _, meta = load_artifact(REPO / "artifacts" / weights, dev)
        cfg = _cfg_from_meta(meta, host_tracking=True)
        r, f, t = 8, cfg.compressed.batch_frames, cfg.video.timestep
        thr = cfg.compressed.mask_threshold
        chunk = rng.integers(0, 256, size=(r, f + t - 1, h, w, 2), dtype=np.uint8)
        stage = CompressedStage(model, cfg, r, dev)
        out = stage.run_chunk_masks(chunk)
        torch.cuda.synchronize()
        if out.device.type != "cuda" or out.dtype != torch.uint8:
            raise AssertionError(f"masks step output {out.dtype} on {out.device}")
        if tuple(out.shape) != (r * f * h * w // 8,) or stage.masks_shape != (r, f, h, w):
            raise AssertionError(
                f"masks step shape {tuple(out.shape)}, {stage.masks_shape}"
            )
        host_ms = cuda_ms(lambda: stage.run_chunk_masks(chunk))
        md = torch.as_tensor(chunk, device=dev)
        dev_ms = cuda_ms(lambda: stage.run_chunk_masks(md))
        on = float(unpack_masks(out.cpu().numpy(), stage.masks_shape).mean())
        log(
            f"[5] run_chunk_masks R={r} F={f} T={t} {h}x{w} ({weights}): "
            f"{host_ms:.3f} ms from host memory, {dev_ms:.3f} ms from a device "
            f"chunk; {on:.4f} of pixels on"
        )

        rs, fs = 2, 16
        small = chunk[:rs, : fs + t - 1]
        got = stage.run_chunk_masks(small).cpu().numpy()
        model_cpu, _, _ = load_artifact(REPO / "artifacts" / weights, "cpu")
        x_cpu = torch.from_numpy(small)
        ref = compressed_masks_step(model_cpu, cfg, x_cpu).numpy()
        p_cpu = compressed_probs(model_cpu, cfg, x_cpu).numpy()
        shape = (rs, fs, h, w)
        flipped = unpack_masks(got, shape) != unpack_masks(ref, shape)
        gap = np.abs(p_cpu - thr)
        near = gap <= 1e-4
        if (flipped & ~near).any():
            raise AssertionError(
                f"{h}x{w}: {int((flipped & ~near).sum())} mask pixels differ from "
                "the CPU away from the threshold"
            )
        log(
            f"[5] sub-chunk R={rs} F={fs} {h}x{w} card vs CPU: "
            f"{int((got != ref).sum())} bytes differ, {int(flipped.sum())} pixels "
            f"flipped, {int(near.sum())} pixels within 1e-4 of the threshold, "
            f"smallest |p - threshold| {float(gap.min()):.3g}"
        )


def phase6_default_pipeline(mp4, samples, tmp, phase4) -> None:
    """CovaPipeline(device="cuda") with the CovaConfig defaults
    (host_tracking=True) end to end; its four CSVs byte-identical to the
    port's run on the CPU."""
    _, sd, meta = _demo_weights("cpu")
    cfg = _pipeline_cfg(meta, True)
    res, launches, _ = _run_pipeline("6", mp4, tmp / "out6", cfg, sd, "cuda", samples)
    cpu, _, _ = _run_pipeline("6", mp4, tmp / "out6cpu", cfg, sd, "cpu", samples)
    for name in CSVS:
        a = (tmp / "out6" / f"{name}.csv").read_bytes()
        b = (tmp / "out6cpu" / f"{name}.csv").read_bytes()
        if a != b:
            raise AssertionError(f"{name}.csv: card run differs from the CPU run")
    for key in ("dropped", "decoded_dependency", "decoded_inference", "dead_tracks"):
        if getattr(res, key) != getattr(cpu, key):
            raise AssertionError(
                f"{key}: card {getattr(res, key)} != CPU {getattr(cpu, key)}"
            )
    log("[6] the four CSVs of the card run equal the CPU run's, byte for byte")
    for label, r_ in (("phase 4 (device tracking)", phase4),
                      ("phase 6 (host tracking)", res)):
        log(
            f"[6] {label}: dead tracks {r_.dead_tracks}, dropped {r_.dropped}, "
            f"decoded dependency {r_.decoded_dependency}, decoded inference "
            f"{r_.decoded_inference}, wall {r_.elapsed_seconds:.3f} s"
        )


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
    t_start = time.perf_counter()
    smi = phase0_environment()
    phase1_build()
    record = phase2_kernels()
    phase3_compressed_stage()
    from cova_tpu_torch.codec import Mp4Demuxer

    with tempfile.TemporaryDirectory() as td:
        tmp = pathlib.Path(td)
        t0 = time.perf_counter()
        mp4 = _paff_clip(tmp, 1200)
        samples = Mp4Demuxer(str(mp4)).num_samples
        log(f"[4] PAFF clip 1280x736, {samples} field samples, made in "
            f"{time.perf_counter() - t0:.3f} s")
        res4, launches = phase4_pipeline(mp4, samples, tmp)
        phase5_masks_step()
        phase6_default_pipeline(mp4, samples, tmp, res4)
    record["launches"] = launches["cc_label"]
    kernels = [{k: record[k] for k in (
        "name", "route", "source", "replaces", "launches", "max_abs_err",
        "ms", "plain_ms")}]
    log(f"[7] smoke total {time.perf_counter() - t_start:.1f} s")
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

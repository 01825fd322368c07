"""Per-op cost profile of the ALL-DEVICE compressed-stage program (the
PyTorch port's counterpart of examples/profile_device.py):

    python -m cova_tpu_torch.examples.profile_device [--input V.mp4]
        [--device cpu] [--reps N] [--cc-backend cuda|plain|auto]
        [--batch-frames F] [--pipelined-chunks N]

The default pipeline runs host_tracking=True (the device runs
metapreprocess + BlobNet + threshold; CC + SORT run natively on the
host). The all-device variant (host_tracking=False,
compressed_stage_step) keeps CC (the CUDA kernel K1) and the SORT scan
(the CUDA kernel K7) on the device. This profile breaks one chunk of it (R=8 GoP ranges of
the input, F=128 windows, the blobnet_demo artifact's input contract,
cc_threshold 3) into cumulative probes, each timed between
torch.cuda.synchronize() calls (median of --reps after a warm-up):

  masks      unpack_wire16 + metapreprocess + BlobNet + threshold
  +labels    ... + connected-component labelling (--cc-backend: cuda is
             K1, plain its plain PyTorch version on the same device,
             auto the kernel on the card and the plain version on the CPU)
  +stats     ... + region stats / box extraction (mask_to_boxes)
  +sort      ... + the SORT scan over the F windows and the packing:
             compressed_stage_step with the chosen labelling
  full+pull  CompressedStage.run_chunk from host memory, its packed
             outputs copied back to the host
  pipelined  steady-state frames/s, two deep: chunk i+1 is dispatched
             before chunk i's packed outputs, already on their way into
             pinned host memory (pipeline/cova.py's _HostCopy), are read

Deltas between consecutive rows are the per-op costs. One JSON line a
probe, then one with the deltas. --input defaults to the committed synth
render, cova_tpu_torch/data/synth_1800.mp4. Runs on the card unless
--device cpu is given (then its times are the CPU's, for checking paths
and shapes only).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pathlib
import statistics
import time

import numpy as np
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent.parent
SYNTH_RENDER = REPO / "cova_tpu_torch" / "data" / "synth_1800.mp4"
DEMO_WEIGHTS = REPO / "artifacts" / "blobnet_demo.npz"
CC_THRESHOLD = 3
PROBES = ("masks", "+labels", "+stats", "+sort")


def with_weights_contract(cfg, meta: dict):
    """cfg with the input contract that the weights' metadata records:
    the nnz channel and signed motion vectors."""
    return dataclasses.replace(
        cfg,
        compressed=dataclasses.replace(
            cfg.compressed,
            use_nnz_channel=bool(meta.get("use_nnz_channel", False)),
            signed_mv=bool(meta.get("signed_mv", False)),
        ),
    )


def profile_cfg(meta: dict, batch_frames: int | None = None):
    """CovaConfig defaults for the all-device program: cc_threshold 3,
    host_tracking False, the weights' metadata contract, F =
    batch_frames (default 128)."""
    from cova_tpu_torch.config import CovaConfig

    cfg = with_weights_contract(CovaConfig(), meta)
    return dataclasses.replace(
        cfg,
        compressed=dataclasses.replace(
            cfg.compressed,
            cc_threshold=CC_THRESHOLD,
            host_tracking=False,
            batch_frames=batch_frames or cfg.compressed.batch_frames,
        ),
    )


def load_chunk(path, cfg) -> np.ndarray:
    """The pipeline's first chunk of `path`: the first F+T-1 display-order
    frames of each of its cfg.parallel.num_ranges GoP ranges,
    entropy-decoded into one (R, F+T-1, H, W, 2) wire16 chunk
    (zero-motion padding past a range's end)."""
    from cova_tpu_torch.codec import Mp4Demuxer
    from cova_tpu_torch.pipeline.ranges import RangePlan

    demux = Mp4Demuxer(str(path))
    try:
        plan = RangePlan.build([demux], cfg)
        chunk = np.zeros((cfg.parallel.num_ranges, plan.nf_chunk, demux.mb_height,
                          demux.mb_width, 2), np.uint8)
        if cfg.compressed.signed_mv:
            chunk[..., 1] = 0x88
        plan.decode_chunk(0, [demux], chunk, min(os.cpu_count() or 8, 16))
    finally:
        demux.close()
    return chunk


def make_probes(model, cfg, metadata: torch.Tensor, cc_backend: str) -> dict:
    """The cumulative probes on a chunk already on the model's device:
    name -> a function returning the probe's 0-dim scalar (the mask
    count, the label sum, box area + valid count, the sum of the packed
    SORT outputs as int32), each the value of the JAX profile's probe."""
    from cova_tpu_torch.ops.cc import mask_to_boxes
    from cova_tpu_torch.ops.cuda.cc_kernel import connected_components, connected_components_plain
    from cova_tpu_torch.pipeline.compressed import compressed_probs, pack_outputs, track_chunk
    from cova_tpu_torch.tracker.sort import sort_init

    dev = metadata.device
    if cc_backend == "cuda" and dev.type != "cuda":
        raise ValueError("--cc-backend cuda needs the card (use plain or auto on the CPU)")
    label = connected_components_plain if cc_backend == "plain" else connected_components
    thr = cfg.compressed.mask_threshold
    cct = cfg.compressed.cc_threshold
    r = metadata.shape[0]
    state = sort_init(cfg.sort.max_tracks, r, dev)
    ts0 = torch.zeros((r,), dtype=torch.int32, device=dev)

    def front():
        return compressed_probs(model, cfg, metadata) > thr

    def p_labels():
        masks = front()
        return label(masks.reshape((-1,) + masks.shape[-2:])).long().sum()

    def p_stats():
        boxes = mask_to_boxes(front(), cct, backend=cc_backend)
        return boxes.area.double().sum() + boxes.valid.sum()

    def p_sort():
        boxes = mask_to_boxes(front(), cct, backend=cc_backend)
        nwin = torch.full((r,), boxes.valid.shape[1], dtype=torch.int32, device=dev)
        _, out = track_chunk(state, boxes, ts0, nwin, cfg.compressed.gamma, cfg.sort)
        return pack_outputs(out).to(torch.int32).sum()

    return {"masks": lambda: front().sum(), "+labels": p_labels, "+stats": p_stats,
            "+sort": p_sort}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def profile(path=SYNTH_RENDER, device="cuda", reps=5, cc_backend="auto",
            batch_frames=None, pipelined_chunks=8, pipelined_runs=3, sort=True,
            log=print) -> dict:
    """Run the probes on one chunk of `path`; each prints its JSON line
    through `log`. With sort=False only masks, +labels and +stats run.
    Returns {"seconds": name -> median seconds, "values": name -> the
    probe's scalar, "pipelined_fps", "report": the final line's dict}."""
    from cova_tpu_torch.models.blobnet import load_artifact
    from cova_tpu_torch.pipeline.compressed import CompressedStage, exact_float32
    from cova_tpu_torch.pipeline.cova import _HostCopy

    dev = torch.device(device)
    exact_float32(dev)
    model, _, meta = load_artifact(DEMO_WEIGHTS, dev)
    cfg = profile_cfg(meta, batch_frames)
    r, f = cfg.parallel.num_ranges, cfg.compressed.batch_frames
    chunk = load_chunk(path, cfg)
    mh, mw = chunk.shape[2:4]
    metadata = torch.as_tensor(chunk, device=dev)
    probes = make_probes(model, cfg, metadata, cc_backend)

    seconds, values = {}, {}

    def bench(name, fn):
        fn()
        _sync(dev)
        times = []
        for _ in range(reps):
            _sync(dev)
            t0 = time.perf_counter()
            out = fn()
            _sync(dev)
            times.append(time.perf_counter() - t0)
        seconds[name] = statistics.median(times)
        values[name] = out.item()
        log(json.dumps({"probe": name, "seconds": round(seconds[name], 4),
                        "all": [round(x, 4) for x in times]}))

    for name in PROBES if sort else PROBES[:3]:
        bench(name, probes[name])
    report = {"device": dev.type, "chunk": [r, f, mh, mw], "cc_backend": cc_backend,
              "deltas": {"blobnet_masks": round(seconds["masks"], 4),
                         "cc_labeling": round(seconds["+labels"] - seconds["masks"], 4),
                         "cc_stats": round(seconds["+stats"] - seconds["+labels"], 4)}}
    res = {"seconds": seconds, "values": values, "report": report}
    if not sort:
        log(json.dumps(report))
        return res

    st = CompressedStage(model, cfg, r, dev)
    ts0 = np.zeros(r, np.int32)

    def full():
        # Production-shaped: the evolving SORT state is part of the real
        # workload, and the packed outputs cross to the host.
        return st.run_chunk(chunk, ts0)[0].cpu().long().sum()

    bench("full+pull", full)

    def pipelined(n):
        st2 = CompressedStage(model, cfg, r, dev)
        _HostCopy(st2.run_chunk(chunk, ts0)[0]).numpy()  # warm
        start = time.perf_counter()
        pending = None
        for _ in range(n):
            copy = _HostCopy(st2.run_chunk(chunk, ts0)[0])
            if pending is not None:
                pending.numpy()
            pending = copy
        pending.numpy()
        return n * r * f / (time.perf_counter() - start)

    rates = sorted(pipelined(pipelined_chunks) for _ in range(pipelined_runs))
    res["pipelined_fps"] = rates[len(rates) // 2]
    log(json.dumps({"probe": "pipelined", "fps": round(res["pipelined_fps"], 1),
                    "all": [round(x, 1) for x in rates]}))
    report["deltas"]["sort_scan"] = round(seconds["+sort"] - seconds["+stats"], 4)
    report["deltas"]["packed_transfer+rebuild"] = round(seconds["full+pull"] - seconds["+sort"], 4)
    report["pipelined_fps"] = round(res["pipelined_fps"], 1)
    log(json.dumps(report))
    return res


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--input", default=str(SYNTH_RENDER), help="an H.264 mp4")
    ap.add_argument("--device", default="cuda", help="torch device (cpu on request)")
    ap.add_argument("--reps", type=int, default=5, help="timed runs a probe (median)")
    ap.add_argument("--cc-backend", default="auto", choices=("cuda", "plain", "auto"),
                    help="labelling: cuda (K1), plain (its plain version), auto")
    ap.add_argument("--batch-frames", type=int, default=None,
                    help="windows a range in the chunk (default: CovaConfig's 128)")
    ap.add_argument("--pipelined-chunks", type=int, default=8,
                    help="chunks a pipelined run (three runs, the median kept)")
    return ap


def main(argv=None) -> None:
    args = parser().parse_args(argv)
    profile(args.input, args.device, args.reps, args.cc_backend, args.batch_frames,
            args.pipelined_chunks)


if __name__ == "__main__":
    main()

"""Long-stream soak: bounded-memory validation of the whole pipeline (the
PyTorch port's counterpart of examples/soak.py):

    python -m cova_tpu_torch.examples.soak [REPS=10] [OUT_DIR]
        [--input V.mp4] [--device cpu]

The reference runs days of video per configuration; offline, the input
(by default the committed synth render, cova_tpu_torch/data/
synth_1800.mp4) is looped REPS times by utils/mp4loop.write_looped_mp4
and sent through CovaPipeline with 8 GoP ranges and the blobnet_demo
artifact's input contract, while a thread samples the process's RSS. It
validates that host memory stays flat over a long stream: the GoP
decoder-state cache, the aggregator's growth between finalizations, the
selector's flush over hours of pts, the per-GoP caches, and the pinned
host copies the pipeline makes of each chunk's device outputs.

The pipeline runs to the end (last="full", the stand-in oracle
StaticBackgroundDetector over artifacts/synth_bg.npy) only where the
codec library has a pixel decoder. The port's own library has only the
stub (csrc/pixdec_stub.cc, the card's machine has no libavcodec), so
there the soak stops after frame selection (last="select", no
detector): entropy decode, BlobNet's masks on --device, host CC + SORT,
the selector and the aggregator.

Prints one JSON line: frames, fps, RSS at the quarter point against the
end, dead tracks, selector counters (the JAX script's keys). Exits 1 if
RSS grows more than SOAK_RSS_BUDGET_MB (default 512) beyond the
quarter-point baseline: steady state must be flat.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import resource
import sys
import tempfile
import threading
import time

from cova_tpu_torch.examples.profile_device import (
    DEMO_WEIGHTS,
    REPO,
    SYNTH_RENDER,
    with_weights_contract,
)

SYNTH_BG = REPO / "artifacts" / "synth_bg.npy"
SAMPLE_S = 2.0  # seconds between RSS samples
RSS_BUDGET_MB = 512.0  # SOAK_RSS_BUDGET_MB's default


def rss_mb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


def current_rss_mb() -> float:
    with open("/proc/self/statm") as f:
        pages = int(f.read().split()[1])
    return pages * os.sysconf("SC_PAGE_SIZE") / 1e6


def has_pixel_decoder(path) -> bool:
    """Whether the codec library's selective pixel decoder opens on
    `path`'s stream (the stub's never does)."""
    from cova_tpu_torch.codec import Mp4Demuxer, PixelDecoder

    demux = Mp4Demuxer(str(path))
    try:
        PixelDecoder(demux.extradata()).close()
        return True
    except RuntimeError:
        return False
    finally:
        demux.close()


def soak_cfg(meta: dict, last: str):
    """8 ranges like production (the looped stream has REPS times the
    input's GoPs, so every range spans many: per-GoP state turns over),
    the weights' metadata contract."""
    from cova_tpu_torch.config import CovaConfig, ParallelConfig

    return with_weights_contract(CovaConfig(parallel=ParallelConfig(num_ranges=8), last=last),
                                 meta)


def soak(reps: int, out_dir, path=SYNTH_RENDER, device="cuda") -> dict:
    """Loop `path` `reps` times into out_dir, run the pipeline over it on
    `device` while sampling RSS, and return the report (the JAX script's
    keys). Progress notes go to stderr."""
    from cova_tpu_torch.models.bgdet import StaticBackgroundDetector, load_background
    from cova_tpu_torch.models.blobnet import load_artifact
    from cova_tpu_torch.pipeline.cova import CovaPipeline
    from cova_tpu_torch.utils.mp4loop import write_looped_mp4

    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    looped = out_dir / f"loop{reps}.mp4"
    n = write_looped_mp4(str(path), str(looped), reps)
    print(f"# looped stream: {n} samples ({n / 30 / 60:.1f} min)", file=sys.stderr)

    _, sd, meta = load_artifact(DEMO_WEIGHTS, "cpu")
    if has_pixel_decoder(looped):
        detector, last = StaticBackgroundDetector(load_background(SYNTH_BG)), "full"
    else:
        detector, last = None, "select"
    print(f"# last={last!r}" + ("" if detector else " (no pixel decoder: no detector)"),
          file=sys.stderr)
    pipe = CovaPipeline(str(looped), str(out_dir / "csv"), soak_cfg(meta, last),
                        variables=sd, detector=detector, log=lambda *a: None,
                        device=device)

    # Sample current RSS from a watcher thread; the quarter-point reading
    # is the steady-state baseline (model and buffers resident).
    samples = []
    stop = threading.Event()

    def watcher():
        while not stop.is_set():
            samples.append((time.monotonic(), current_rss_mb()))
            stop.wait(SAMPLE_S)

    th = threading.Thread(target=watcher, daemon=True)
    t0 = time.monotonic()
    th.start()
    try:
        res = pipe.run()
    finally:
        stop.set()
        th.join()
    elapsed = time.monotonic() - t0

    q = max(1, len(samples) // 4)
    rss_quarter = samples[q - 1][1] if samples else current_rss_mb()
    rss_end = samples[-1][1] if samples else current_rss_mb()
    growth = rss_end - rss_quarter
    return {
        "frames": res.num_frames,
        "elapsed_seconds": round(elapsed, 1),
        "fps": round(res.num_frames / elapsed, 1),
        "dead_tracks": res.dead_tracks,
        "dropped": res.dropped,
        "decoded_dependency": res.decoded_dependency,
        "decoded_inference": res.decoded_inference,
        "rss_quarter_mb": round(rss_quarter, 1),
        "rss_end_mb": round(rss_end, 1),
        "rss_growth_mb": round(growth, 1),
        "rss_peak_mb": round(rss_mb(), 1),
    }


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("reps", nargs="?", type=int, default=10, help="times the input is looped")
    ap.add_argument("out_dir", nargs="?",
                    default=os.path.join(tempfile.gettempdir(), "cova_torch_soak"))
    ap.add_argument("--input", default=str(SYNTH_RENDER), help="an H.264 mp4")
    ap.add_argument("--device", default="cuda", help="torch device (cpu on request)")
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    budget_mb = float(os.environ.get("SOAK_RSS_BUDGET_MB", RSS_BUDGET_MB))
    report = soak(args.reps, args.out_dir, args.input, args.device)
    print(json.dumps(report), flush=True)
    if report["rss_growth_mb"] > budget_mb:
        print(f"FAIL: steady-state RSS grew {report['rss_growth_mb']:.0f} MB "
              f"(budget {budget_mb:.0f})", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

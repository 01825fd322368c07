"""Accuracy at the 1080p operating point (the PyTorch port's counterpart of
examples/reproduce_1080p.py):

    python -m cova_tpu_torch.examples.reproduce_1080p [OUT_DIR]
        [--input V.mp4] [--device cpu] [--cc 7] [--mask 0.6]
        [--minhits N] [--maxage N] [--weights W.npz]

The naive-GT -> CoVA -> BP/GC flow of reproduce_accuracy on a 1920x1080
stream (the 120x68 MB grid). Every pixel-space knob scales with the 1.5x
upscale of the demo clip, so the queries mean what they mean at 720p:

  - the stand-in oracle's areas x2.25 (pixel count), the query's
    exclusions x1.5 (query/datasets.py DEMO1080);
  - BlobNet's CC area threshold 7 and mask threshold 0.6, the demo1080
    operating point (the winner of the JAX package's offline knob sweep);
  - the tracker's knobs count frames and stay at the reference launch
    defaults unless --minhits / --maxage.

Weights: artifacts/blobnet_demo1080.npz (--weights overrides), BlobNet on
--device. --input defaults to cova_tpu_torch/data/synth_1800_1080p.mp4,
the committed 1080p re-encode of the synth render (the demo clip's 1080p
stream is not in the repository). The stand-in detector's background is
built from the input next to the outputs (OUT_DIR/background.npy, reused
when present).

Both sides decode pixels, so the script needs a codec library with the
selective pixel decoder (libavcodec): it refuses to start with the
port's own library, whose decoder is the stub csrc/pixdec_stub.cc.

Writes OUT_DIR/{naive/dnn.csv, cova/*.csv, report.json} (the JAX
script's report keys); the naive ground truth is reused when
OUT_DIR/naive/dnn.csv exists. Nothing under golden/.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import tempfile
import time

REPO = pathlib.Path(__file__).resolve().parent.parent.parent
RENDER_1080P = REPO / "cova_tpu_torch" / "data" / "synth_1800_1080p.mp4"
WEIGHTS_1080P = REPO / "artifacts" / "blobnet_demo1080.npz"


def require_pixel_decoder(video, what: str) -> None:
    """Raise unless the codec library's selective pixel decoder opens on
    `video` (the stub's never does)."""
    from cova_tpu_torch.examples.soak import has_pixel_decoder

    if not has_pixel_decoder(video):
        raise RuntimeError(
            f"{what} decodes pixels, and this codec library has no pixel decoder "
            "(built with csrc/pixdec_stub.cc, without libavcodec)")


def detector_for(video, out_dir, width: int, height: int):
    """The stand-in oracle (StaticBackgroundDetector) over `video`'s
    background, built next to the outputs (out_dir/background.npy, reused
    when present), its areas scaled from their 1280x720 values by the
    pixel count."""
    from cova_tpu_torch.models.bgdet import (
        StaticBackgroundDetector,
        build_background,
        load_background,
        save_background,
    )

    bg_path = pathlib.Path(out_dir) / "background.npy"
    if bg_path.exists():
        bg = load_background(bg_path)
        print(f"loaded background model {bg_path}")
    else:
        bg = build_background(str(video))
        save_background(bg_path, bg)
        print(f"built + saved background model {bg_path}")
    s = (width * height) / float(1280 * 720)
    return StaticBackgroundDetector(bg, min_area=int(round(60 * s)),
                                    car_area=int(round(700 * s)))


def operating_point(meta: dict, cc: int = 7, mask: float = 0.6, min_hits=None,
                    max_age=None, last=None):
    """The 1080p CovaConfig: 4 ranges (a two-GoP walk a range on an 8-GoP
    clip), CC area `cc`, mask threshold `mask`, the tracker's defaults
    unless `min_hits` / `max_age`, the weights' input contract."""
    from cova_tpu_torch.config import (
        CompressedStageConfig,
        CovaConfig,
        ParallelConfig,
        SortConfig,
    )

    default = SortConfig()
    return CovaConfig(
        parallel=ParallelConfig(num_ranges=4),
        sort=SortConfig(
            min_hits=default.min_hits if min_hits is None else min_hits,
            max_age=default.max_age if max_age is None else max_age,
        ),
        compressed=CompressedStageConfig(
            cc_threshold=cc,
            mask_threshold=mask,
            use_nnz_channel=bool(meta.get("use_nnz_channel", False)),
            signed_mv=bool(meta.get("signed_mv", False)),
        ),
        last=last,
    )


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out_dir", nargs="?",
                    default=os.path.join(tempfile.gettempdir(), "cova_accuracy_1080"))
    ap.add_argument("--input", default=str(RENDER_1080P), help="a 1920x1080 H.264 mp4")
    ap.add_argument("--device", default="cuda",
                    help="torch device of BlobNet (cpu on request)")
    ap.add_argument("--cc", type=int, default=7, help="CC area threshold (MB cells)")
    ap.add_argument("--mask", type=float, default=0.6, help="mask threshold")
    ap.add_argument("--minhits", type=int, default=None, help="SORT min_hits")
    ap.add_argument("--maxage", type=int, default=None, help="SORT max_age")
    ap.add_argument("--weights", default=str(WEIGHTS_1080P), help="a BlobNet npz artifact")
    return ap


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    import torch

    torch.empty(0, device=args.device)  # no such device: fail before any work
    video = args.input
    require_pixel_decoder(video, "reproduce_1080p")
    out_dir = pathlib.Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    from cova_tpu_torch.codec import Mp4Demuxer
    from cova_tpu_torch.models.blobnet import load_artifact
    from cova_tpu_torch.pipeline.cova import CovaPipeline
    from cova_tpu_torch.pipeline.naive import NaivePipeline
    from cova_tpu_torch.query.datasets import DATASETS
    from cova_tpu_torch.query.metrics import load_boxes_csv, load_cova, parse_query

    demux = Mp4Demuxer(video)
    w, h, mw, mh = demux.width, demux.height, demux.mb_width, demux.mb_height
    duration = (demux.sample(demux.num_samples - 1).pts / demux.timescale) + (
        1.0 / 30.0
    )
    demux.close()
    detector = detector_for(video, out_dir, w, h)

    gt_csv = out_dir / "naive" / "dnn.csv"
    if gt_csv.exists():
        print(f"naive GT cached at {gt_csv}")
    else:
        print("== naive baseline (full decode, every frame, 1080p) ==")
        t0 = time.perf_counter()
        nres = NaivePipeline(video, str(out_dir / "naive"), detector).run()
        print(
            f"naive: {nres.num_frames} frames, {nres.num_detections} "
            f"detections, {time.perf_counter() - t0:.1f}s"
        )

    weights = pathlib.Path(args.weights)
    print(f"== cova pipeline @1080p (weights {weights}) ==")
    _, variables, wmeta = load_artifact(weights, "cpu")
    cfg = operating_point(wmeta, args.cc, args.mask, args.minhits, args.maxage)
    cres = CovaPipeline(video, str(out_dir / "cova"), cfg, variables=variables,
                        detector=detector, device=args.device).run()
    print(
        f"cova: {cres.num_frames} frames in {cres.elapsed_seconds:.1f}s, "
        f"dead tracks {cres.dead_tracks}"
    )

    ds = DATASETS["demo1080"]
    res = parse_query(
        load_boxes_csv(gt_csv), load_cova(out_dir / "cova"), duration, list(ds.targets),
        exclude=ds.exclude, region=ds.region, frame_size=ds.frame_size,
    )
    report = {
        "input": video,
        "resolution": f"{w}x{h} ({mw}x{mh} MB grid)",
        # The evaluation grid depends on the container-pts duration.
        "duration_seconds": duration,
        "weights": weights.name,
        "cc_threshold": args.cc,
        "mask_threshold": args.mask,
        "min_hits": cfg.sort.min_hits,
        "max_age": cfg.sort.max_age,
        "bp_accuracy": round(res.bp_accuracy, 4),
        "gc_error": round(res.gc_error, 4),
        "bp_accuracy_local": round(res.bp_accuracy_local, 4),
        "gc_error_local": round(res.gc_error_local, 4),
        "num_slots": res.num_slots,
        "decode_filter_rate": round(cres.decode_filter_rate, 4),
        "inference_filter_rate": round(cres.inference_filter_rate, 4),
        "frames": cres.num_frames,
        "dead_tracks": cres.dead_tracks,
    }
    (out_dir / "report.json").write_text(json.dumps(report, indent=1))
    print("== report (accuracy @1080p) ==")
    for k in ("bp_accuracy", "gc_error", "bp_accuracy_local",
              "gc_error_local", "decode_filter_rate",
              "inference_filter_rate"):
        print(f"{k}: {report[k]:.4f}")
    print(f"report written to {out_dir / 'report.json'}")
    return report


if __name__ == "__main__":
    main()

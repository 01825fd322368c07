"""Cross-scene accuracy on the synthetic third scene (the PyTorch port's
counterpart of examples/reproduce_synth.py):

    python -m cova_tpu_torch.examples.reproduce_synth [OUT_DIR]
        [--input V.mp4] [--device cpu] [--no-zeroshot]
        [--replay [--gt GT.csv] [--max-frames N]]

The scene is examples/make_synth.py's procedural intersection; the
default input is its committed render, cova_tpu_torch/data/
synth_1800.mp4 (recipe v6, seed 11, 1800 frames). The synth-trained
weights (artifacts/blobnet_synth.npz) run at the synth operating point
(mask 0.6 / cc 2 / min_hits 40 / max_age 45, 4 ranges), and the report
also records the ZERO-SHOT row: the demo-trained weights on this scene,
same knobs — the reason the reference trains BlobNet per scene.

Two routes write OUT_DIR/report.json with the JAX script's keys:

  * the full flow (the default): the naive ground truth (every frame
    decoded and through the stand-in oracle, StaticBackgroundDetector
    with bus_area 2500 on artifacts/synth_bg.npy) into OUT_DIR/naive,
    then CovaPipeline to the end (last="full", BlobNet on --device) for
    each weights file. It decodes pixels, so it needs a codec library
    with the selective pixel decoder (libavcodec); it refuses to start
    without one.
  * --replay: the same operating point through the sweep harness
    (examples/sweep_accuracy.py SweepContext): entropy decode on the
    host, BlobNet's probabilities on --device, the host replay of CC,
    SORT, the frame selector and the aggregator, and the oracle's output
    read from --gt (golden/synth/dnn_gt.csv by default) at the frames
    the selector picks. No pixel is decoded, so this is the route for a
    machine whose codec has no pixel decoder. --max-frames caps each
    range (a prefix).

Nothing is written under golden/.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import tempfile
import time

REPO = pathlib.Path(__file__).resolve().parent.parent.parent
BG_PATH = REPO / "artifacts" / "synth_bg.npy"
SYNTH_WEIGHTS = REPO / "artifacts" / "blobnet_synth.npz"
DEMO_WEIGHTS = REPO / "artifacts" / "blobnet_demo.npz"

# Committed synth operating point (examples/reproduce_synth.py).
CC, MASK, MIN_HITS, MAX_AGE = 2, 0.6, 40, 45
BUS_AREA = 2500
METRICS = ("bp_accuracy", "gc_error", "bp_accuracy_local", "gc_error_local")


def parser() -> argparse.ArgumentParser:
    from cova_tpu_torch.examples.sweep_accuracy import SYNTH_GT, SYNTH_VIDEO

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out_dir", nargs="?",
                    default=os.path.join(tempfile.gettempdir(), "cova_accuracy_synth"))
    ap.add_argument("--input", default=str(SYNTH_VIDEO), help="the synth scene's mp4")
    ap.add_argument("--device", default="cuda",
                    help="torch device of BlobNet (cpu on request)")
    ap.add_argument("--no-zeroshot", action="store_true",
                    help="skip the demo-weights row")
    ap.add_argument("--replay", action="store_true",
                    help="score through the sweep harness (no pixel decoder)")
    ap.add_argument("--gt", default=str(SYNTH_GT),
                    help="with --replay: the oracle's detections (naive dnn.csv)")
    ap.add_argument("--max-frames", type=int, default=None,
                    help="with --replay: cap on frames per GoP range")
    return ap


def synth_cfg(meta: dict):
    """The operating point as a CovaConfig, metadata channels from the
    weights' stored contract."""
    from cova_tpu_torch.config import (
        CompressedStageConfig,
        CovaConfig,
        ParallelConfig,
        SortConfig,
    )

    return CovaConfig(
        parallel=ParallelConfig(num_ranges=4),
        sort=SortConfig(min_hits=MIN_HITS, max_age=MAX_AGE),
        compressed=CompressedStageConfig(
            cc_threshold=CC,
            mask_threshold=MASK,
            use_nnz_channel=bool(meta.get("use_nnz_channel", False)),
            signed_mv=bool(meta.get("signed_mv", False)),
        ),
    )


def _replay(args, weights_list, out_dir):
    """Each weights file's row through the sweep harness, its CSVs under
    out_dir/<tag>."""
    from cova_tpu_torch.examples.sweep_accuracy import SweepContext
    from cova_tpu_torch.models.blobnet import load_meta_npz

    ctx = SweepContext(args.input, gt_csv=args.gt, dataset="synth",
                       max_frames=args.max_frames, device=args.device)
    rows = {}
    for tag, weights in weights_list:
        cfg = synth_cfg(load_meta_npz(weights))
        probs = ctx.probs(weights, use_nnz=cfg.compressed.use_nnz_channel,
                          signed_mv=cfg.compressed.signed_mv, cache=False)
        r = rows[tag] = ctx.run_config(probs, cfg, out_dir=str(out_dir / tag))
        print(f"{tag}: BP {r['bp_accuracy']:.4f}  GC {r['gc_error']:.4f}  "
              f"BPL {r['bp_accuracy_local']:.4f}  GCL {r['gc_error_local']:.4f}  "
              f"filters {r['decode_filter_rate']:.3f}/{r['inference_filter_rate']:.3f}")
    return ctx.duration, rows


def _full(args, weights_list, out_dir):
    from cova_tpu_torch.codec import Mp4Demuxer, PixelDecoder
    from cova_tpu_torch.models.bgdet import (
        StaticBackgroundDetector,
        build_background,
        load_background,
        save_background,
    )
    from cova_tpu_torch.models.blobnet import load_artifact
    from cova_tpu_torch.pipeline.cova import CovaPipeline
    from cova_tpu_torch.pipeline.naive import NaivePipeline
    from cova_tpu_torch.query.datasets import DATASETS
    from cova_tpu_torch.query.metrics import load_boxes_csv, load_cova, parse_query

    video = args.input
    demux = Mp4Demuxer(video)
    try:
        PixelDecoder(demux.extradata()).close()
    except RuntimeError as e:
        raise RuntimeError(
            "the full flow decodes pixels, and this codec library has no pixel "
            "decoder (built without libavcodec): run with --replay"
        ) from e
    duration = (demux.sample(demux.num_samples - 1).pts / demux.timescale) + (
        1.0 / 30.0
    )
    demux.close()

    if BG_PATH.exists():
        bg = load_background(BG_PATH)
        print(f"loaded background model {BG_PATH}")
    else:
        bg = build_background(video)
        save_background(out_dir / "background.npy", bg)
        print(f"built + saved background model {out_dir / 'background.npy'}")
    detector = StaticBackgroundDetector(bg, bus_area=BUS_AREA)

    gt_csv = out_dir / "naive" / "dnn.csv"
    if gt_csv.exists():
        print(f"naive GT cached at {gt_csv}")
    else:
        print("== naive baseline (full decode, every frame) ==")
        t0 = time.perf_counter()
        nres = NaivePipeline(video, str(out_dir / "naive"), detector).run()
        print(
            f"naive: {nres.num_frames} frames, {nres.num_detections} "
            f"detections, {time.perf_counter() - t0:.1f}s"
        )

    ds = DATASETS["synth"]
    gt = load_boxes_csv(gt_csv)
    rows = {}
    for tag, weights in weights_list:
        _, sd, wmeta = load_artifact(weights, "cpu")
        cdir = out_dir / tag
        cres = CovaPipeline(
            video, str(cdir), synth_cfg(wmeta), variables=sd, detector=detector,
            device=args.device,
        ).run()
        res = parse_query(
            gt, load_cova(cdir), duration, list(ds.targets),
            exclude=ds.exclude, region=ds.region, frame_size=ds.frame_size,
        )
        print(
            f"{tag}: BP {res.bp_accuracy:.4f}  GC {res.gc_error:.4f}  "
            f"BPL {res.bp_accuracy_local:.4f}  GCL {res.gc_error_local:.4f}  "
            f"filters {cres.decode_filter_rate:.3f}/"
            f"{cres.inference_filter_rate:.3f}"
        )
        rows[tag] = {
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
    return duration, rows


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    out_dir = pathlib.Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    weights_list = [("cova", str(SYNTH_WEIGHTS))]
    if not args.no_zeroshot:
        weights_list.append(("cova_zeroshot", str(DEMO_WEIGHTS)))
    run = _replay if args.replay else _full
    duration, rows = run(args, weights_list, out_dir)

    r = rows["cova"]
    video = pathlib.Path(args.input).resolve()
    report = {
        # The input's path in the repository where it lies there.
        "input": str(video.relative_to(REPO) if video.is_relative_to(REPO) else video),
        "scene": "procedural intersection (make_synth.py)",
        "route": "replay" if args.replay else "full",
        "duration_seconds": duration,
        "weights": SYNTH_WEIGHTS.name,
        "cc_threshold": CC,
        "mask_threshold": MASK,
        "min_hits": MIN_HITS,
        "max_age": MAX_AGE,
        "bus_area": BUS_AREA,
        **{k: r[k] for k in METRICS},
        "num_slots": r["num_slots"],
        "decode_filter_rate": r["decode_filter_rate"],
        "inference_filter_rate": r["inference_filter_rate"],
        "frames": r["frames"],
        "dead_tracks": r["dead_tracks"],
    }
    if "cova_zeroshot" in rows:
        report["zeroshot_demo_weights"] = {k: rows["cova_zeroshot"][k] for k in METRICS}

    (out_dir / "report.json").write_text(json.dumps(report, indent=1))
    print("== report (cross-scene accuracy, synth) ==")
    for k in METRICS + ("decode_filter_rate", "inference_filter_rate"):
        print(f"{k}: {report[k]:.4f}")
    print(f"report written to {out_dir / 'report.json'}")
    return report


if __name__ == "__main__":
    main()

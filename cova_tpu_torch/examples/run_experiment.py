"""Multi-input experiment launcher + per-day accuracy aggregation (the
PyTorch port's counterpart of examples/run_experiment.py):

    python -m cova_tpu_torch.examples.run_experiment EXPERIMENT.json
        [--device cpu]

The reference runs each day of a dataset through the pipeline from a
templated YAML config (experiment/cova/launch.py) and then evaluates every
day in parallel (parse/accuracy.py:27-92). Here one process drives all
inputs in turn (BlobNet on --device, the card unless told otherwise; the
aggregator in process) and writes a per-input + summary report.

Experiment config (JSON; YAML needs the `yaml` module):

    output_root: /tmp/cova_exp
    dataset: synth                # query config (query/datasets.py)
    inputs:                       # one entry per day/video; strings or
      - day1.mp4                  # dicts with per-input overrides:
      - path: synth.mp4
        dataset: synth            #   per-input query config
        bus_area: 2500            #   3-class stand-in oracle split
    ground_truth: naive           # "naive" = run the full-decode
                                  # baseline per input; or a directory
                                  # with <stem>.csv files, or absent to
                                  # skip accuracy
    blobnet_weights: artifacts/blobnet_demo.npz
    cova:                         # optional CovaConfig overrides
      parallel: {num_ranges: 4}

Every input must exist: the JAX example's `generate:` key renders a
missing input with libx264 (examples/make_synth.py, make_dataset2.py),
which this package does not carry; here it only names the tool to run.
The stand-in oracle's background is built from the video (a pixel
decode) unless OUTPUT_ROOT/<stem>/background.npy exists; the naive
ground truth and the pipeline's selective decode need the pixel decoder
too (a codec library with libavcodec).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pathlib

GENERATORS = {"synth": "examples/make_synth.py", "dataset2": "examples/make_dataset2.py"}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("experiment", help="experiment config (.json, or .yaml with yaml)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of BlobNet (cpu on request)")
    return ap


def load_experiment(path):
    text = pathlib.Path(path).read_text()
    if str(path).endswith((".yaml", ".yml")):
        try:
            import yaml
        except ImportError as e:
            raise RuntimeError(
                f"{path}: a YAML experiment needs the yaml module, which is not "
                "installed here; write the config as JSON"
            ) from e
        return yaml.safe_load(text)
    return json.loads(text)


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    exp = load_experiment(args.experiment)

    from cova_tpu_torch.codec import Mp4Demuxer
    from cova_tpu_torch.config import CovaConfig
    from cova_tpu_torch.models.bgdet import (
        StaticBackgroundDetector,
        build_background,
        load_background,
        save_background,
    )
    from cova_tpu_torch.pipeline.cova import CovaPipeline
    from cova_tpu_torch.pipeline.naive import NaivePipeline
    from cova_tpu_torch.query.datasets import DATASETS
    from cova_tpu_torch.query.metrics import load_boxes_csv, load_cova, parse_query

    root = pathlib.Path(exp["output_root"])
    root.mkdir(parents=True, exist_ok=True)
    cfg = CovaConfig.from_dict(exp.get("cova", {}))
    gt_mode = exp.get("ground_truth")

    variables = None
    if exp.get("blobnet_weights"):
        from cova_tpu_torch.models.blobnet import load_artifact

        _, variables, wmeta = load_artifact(exp["blobnet_weights"], "cpu")
        print(f"loaded BlobNet weights {exp['blobnet_weights']} ({wmeta or '3ch'})")
        if wmeta:
            cfg = dataclasses.replace(
                cfg,
                compressed=dataclasses.replace(
                    cfg.compressed,
                    use_nnz_channel=bool(wmeta.get("use_nnz_channel", False)),
                    signed_mv=bool(wmeta.get("signed_mv", False)),
                ),
            )

    summary = {"inputs": [], "mean": {}}
    for entry_cfg in exp["inputs"]:
        if isinstance(entry_cfg, str):
            entry_cfg = {"path": entry_cfg}
        video = entry_cfg["path"]
        ds = DATASETS[entry_cfg.get("dataset", exp.get("dataset", "demo"))]
        gen = entry_cfg.get("generate")
        if gen and not os.path.exists(video):
            raise FileNotFoundError(
                f"{video} is missing: render it first with "
                f"{GENERATORS.get(gen, gen)} (needs libx264)"
            )
        stem = pathlib.Path(video).stem
        out = root / stem
        out.mkdir(parents=True, exist_ok=True)
        print(f"== {stem}: {video} ==")

        demux = Mp4Demuxer(video)
        duration = (
            demux.sample(demux.num_samples - 1).pts / demux.timescale
            + 1.0 / cfg.video.fps
        )
        demux.close()

        # Deterministic stand-in oracle per input (median-luma
        # background; reference setups use YOLOv4 here).
        bg_path = out / "background.npy"
        if bg_path.exists():
            bg = load_background(bg_path)
        else:
            bg = build_background(video)
            save_background(bg_path, bg)
        det = StaticBackgroundDetector(bg, bus_area=entry_cfg.get("bus_area"))

        gt_csv = None
        if gt_mode == "naive":
            gt_csv = out / "naive" / "dnn.csv"
            if not gt_csv.exists():
                nres = NaivePipeline(video, str(out / "naive"), det).run()
                print(
                    f"  naive GT: {nres.num_detections} detections in "
                    f"{nres.elapsed_seconds:.1f}s"
                )
        elif gt_mode:
            cand = pathlib.Path(gt_mode) / f"{stem}.csv"
            gt_csv = cand if cand.exists() else None

        pipe = CovaPipeline(
            video, str(out / "cova"), cfg, variables=variables, detector=det,
            device=args.device,
        )
        res = pipe.run()
        entry = {
            "input": video,
            "frames": res.num_frames,
            "elapsed_seconds": round(res.elapsed_seconds, 2),
            "decode_filter_rate": round(res.decode_filter_rate, 4),
            "inference_filter_rate": round(res.inference_filter_rate, 4),
            "dead_tracks": res.dead_tracks,
        }
        print(
            f"  cova: {res.num_frames} frames in {res.elapsed_seconds:.1f}s, "
            f"filters {res.decode_filter_rate:.3f}/"
            f"{res.inference_filter_rate:.3f}"
        )

        if gt_csv is not None:
            gt = load_boxes_csv(gt_csv)
            cova_df = load_cova(out / "cova")
            q = parse_query(
                gt, cova_df, duration, list(ds.targets),
                exclude=ds.exclude, region=ds.region,
                frame_size=ds.frame_size,
            )
            entry.update(
                bp_accuracy=round(q.bp_accuracy, 4),
                gc_error=round(q.gc_error, 4),
                bp_accuracy_local=round(q.bp_accuracy_local, 4),
                gc_error_local=round(q.gc_error_local, 4),
            )
            print(
                f"  BP {q.bp_accuracy:.4f}  GC {q.gc_error:.4f}  "
                f"BPL {q.bp_accuracy_local:.4f}  GCL {q.gc_error_local:.4f}"
            )
        summary["inputs"].append(entry)

    # Dataset-level means (the reference prints per-day then averages).
    keys = [
        "bp_accuracy", "gc_error", "bp_accuracy_local", "gc_error_local",
        "decode_filter_rate", "inference_filter_rate",
    ]
    for k in keys:
        vals = [e[k] for e in summary["inputs"] if k in e]
        if vals:
            summary["mean"][k] = round(sum(vals) / len(vals), 4)
    (root / "summary.json").write_text(json.dumps(summary, indent=1))
    print(f"summary written to {root / 'summary.json'}")
    if summary["mean"]:
        print("means:", json.dumps(summary["mean"]))
    return summary


if __name__ == "__main__":
    main()

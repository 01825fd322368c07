"""End-to-end elapsed time of the naive full-decode pipeline against the
CoVA pipeline on the same input (the PyTorch port's counterpart of
examples/fig8.py; the reference paper's Fig. 8):

    python -m cova_tpu_torch.examples.fig8 [--inputs A.mp4,B.mp4]
        [--out FIG8.json] [--work DIR] [--device cpu]

Both sides run the same stand-in oracle (models/bgdet.py) on the same
machine: the naive side decodes and infers every frame; CoVA
entropy-decodes every frame on the host, runs BlobNet on --device, and
fully decodes and infers only the frames its selector schedules. Each
input's row carries wall and process-CPU seconds of both sides (process
CPU time sums over the host's threads), their ratios, the filter rates
and bench.py's fixed-work cpu_calib_mips probe before and after.

Each row runs the configuration its resolution's accuracy golden pins:
above 720 lines, artifacts/blobnet_demo1080.npz at cc_threshold 7 and
mask threshold 0.6; otherwise artifacts/blobnet_demo.npz at cc_threshold
3; 4 ranges, the tracker at its defaults. The stand-in's background is
built from each input next to its outputs (WORK/<input>/background.npy,
reused when present), its areas scaled with the pixel count from their
1280x720 values. CoVA's device step is warmed before its timed run.

--inputs takes mp4 paths (default: the committed renders of the synth
scene, cova_tpu_torch/data/synth_1800.mp4 and synth_1800_1080p.mp4). The
artifact goes to --out (default: fig8.json in a temporary directory).
Both sides decode pixels, so the script needs a codec library with the
selective pixel decoder (libavcodec): it refuses to start with the
port's own library, whose decoder is the stub csrc/pixdec_stub.cc.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import tempfile
import time

from cova_tpu_torch.bench import cpu_probe
from cova_tpu_torch.examples.reproduce_1080p import detector_for, require_pixel_decoder

REPO = pathlib.Path(__file__).resolve().parent.parent.parent
DATA = REPO / "cova_tpu_torch" / "data"
INPUTS = (DATA / "synth_1800.mp4", DATA / "synth_1800_1080p.mp4")
WORK = pathlib.Path(tempfile.gettempdir()) / "cova_fig8"


def run_input(label: str, video, work_root, device="cuda") -> dict:
    """Both pipelines on `video`, outputs under work_root/label; returns
    the row."""
    from cova_tpu_torch.codec import Mp4Demuxer
    from cova_tpu_torch.config import (
        CompressedStageConfig,
        CovaConfig,
        ParallelConfig,
    )
    from cova_tpu_torch.models.blobnet import load_artifact
    from cova_tpu_torch.pipeline.cova import CovaPipeline
    from cova_tpu_torch.pipeline.naive import NaivePipeline

    video = str(video)
    out = pathlib.Path(work_root) / label
    out.mkdir(parents=True, exist_ok=True)
    demux = Mp4Demuxer(video)
    w, h, n = demux.width, demux.height, demux.num_samples
    demux.close()
    detector = detector_for(video, out, w, h)

    calib0 = cpu_probe()

    print(f"== {label}: naive (full decode + infer every frame) ==", flush=True)
    c0, t0 = time.process_time(), time.perf_counter()
    nres = NaivePipeline(video, str(out / "naive"), detector).run()
    naive_s = time.perf_counter() - t0
    naive_cpu = time.process_time() - c0

    print(f"== {label}: cova ==", flush=True)
    w1080 = REPO / "artifacts" / "blobnet_demo1080.npz"
    if h > 720 and w1080.exists():
        weights, ckw = w1080, dict(cc_threshold=7, mask_threshold=0.6)
    else:
        weights, ckw = REPO / "artifacts" / "blobnet_demo.npz", dict(cc_threshold=3)
    _, variables, wmeta = load_artifact(weights, "cpu")
    cfg = CovaConfig(
        parallel=ParallelConfig(num_ranges=4),
        compressed=CompressedStageConfig(
            **ckw,
            use_nnz_channel=bool(wmeta.get("use_nnz_channel", False)),
            signed_mv=bool(wmeta.get("signed_mv", False)),
        ),
    )
    pipe = CovaPipeline(video, str(out / "cova"), cfg, variables=variables,
                        detector=detector, device=device)
    # The reference's elapsed likewise leaves out its engine builds.
    pipe.warmup()
    c0, t0 = time.process_time(), time.perf_counter()
    cres = pipe.run()
    cova_s = time.perf_counter() - t0
    cova_cpu = time.process_time() - c0
    calib1 = cpu_probe()

    row = {
        "input": label,
        "path": video,
        "width": w,
        "height": h,
        "frames": n,
        "naive_s": round(naive_s, 2),
        "naive_cpu_s": round(naive_cpu, 2),
        "cova_s": round(cova_s, 2),
        "cova_cpu_s": round(cova_cpu, 2),
        "speedup": round(naive_s / cova_s, 2),
        "speedup_cpu": round(naive_cpu / cova_cpu, 2),
        "decode_filter_rate": round(cres.decode_filter_rate, 4),
        "inference_filter_rate": round(cres.inference_filter_rate, 4),
        "naive_detections": nres.num_detections,
        "weights": weights.name,
        "cc_threshold": cfg.compressed.cc_threshold,
        "cpu_calib_mips": [round(calib0, 2), round(calib1, 2)],
    }
    print(json.dumps(row), flush=True)
    return row


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--inputs", default=",".join(str(p) for p in INPUTS),
                    help="comma-separated mp4 paths")
    ap.add_argument("--out", default=str(WORK / "fig8.json"), help="the JSON artifact")
    ap.add_argument("--work", default=str(WORK), help="outputs of every run")
    ap.add_argument("--device", default="cuda",
                    help="torch device of BlobNet (cpu on request)")
    return ap


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    import torch

    torch.empty(0, device=args.device)  # no such device: fail before any work
    videos = args.inputs.split(",")
    for video in videos:
        require_pixel_decoder(video, "fig8")
    rows = [run_input(pathlib.Path(v).stem, v, args.work, args.device) for v in videos]
    device = (torch.cuda.get_device_name(torch.device(args.device))
              if torch.device(args.device).type == "cuda" else "the CPU")
    artifact = {
        "metric": "fig8_elapsed_speedup",
        "description": (
            "end-to-end elapsed: naive full-decode+infer vs CoVA, same "
            f"input, same stand-in oracle detector, BlobNet on {device}, "
            f"{os.cpu_count()} host cores (reference paper Fig. 8 analog)"
        ),
        "value_basis": "wall (speedup) + process-cpu (speedup_cpu)",
        "rows": rows,
    }
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(artifact, indent=1))
    print(f"wrote {out}")
    return artifact


if __name__ == "__main__":
    main()

"""Run the end-to-end CoVA pipeline on a video.

The counterpart of examples/run_cova.py for the PyTorch port:

    python -m cova_tpu_torch.run_cova VIDEO.mp4 OUTPUT_DIR [--device cpu]
        [--max-frames N] [--device-tracking]

It runs on the card (--device cuda, the default; without one it raises)
unless --device names another torch device, such as cpu. The run uses the CovaConfig defaults, so connected components and SORT
run in native host code on the device's bit-packed masks
(host_tracking=True); --device-tracking runs them on the device instead
(host_tracking=False, the connected-components CUDA kernel and the
device SORT). BlobNet weights come from $COVA_BLOBNET_CKPT (an .npz
weight artifact) or the committed artifacts/blobnet_demo.npz; the
artifact's stored `__meta__` sets the metadata channels
(use_nnz_channel, signed_mv).

The oracle: with $COVA_YOLO_WEIGHTS set to a darknet `.weights` file,
YOLOv4 (models/yolov4.py, on --device, its NMS the CUDA kernel on a
card) runs on the frames the selector schedules, the run goes to the end
(last="full") and fills dnn.csv, assoc.csv and the stationary labels;
$COVA_YOLO_CFG names the darknet cfg the weights were trained for (other
darknet variants load too). The full run needs the selective pixel
decoder: a codec library built without libavcodec (the stub decoder)
refuses it with an error. Without $COVA_YOLO_WEIGHTS there is no
detector, and the run stops after frame selection (last="select"), with
dnn.csv and assoc.csv empty.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import pathlib

REPO = pathlib.Path(__file__).resolve().parent.parent


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("input")
    ap.add_argument("output_dir")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the device stage (cpu on request)")
    ap.add_argument("--max-frames", type=int, default=None,
                    help="cap on frames per GoP range")
    ap.add_argument("--device-tracking", action="store_true",
                    help="run CC + SORT on the device (host_tracking=False)")
    return ap


def main(argv=None) -> None:
    args = parser().parse_args(argv)

    from cova_tpu_torch.config import CovaConfig
    from cova_tpu_torch.models.blobnet import load_artifact
    from cova_tpu_torch.pipeline.cova import CovaPipeline

    ckpt = os.environ.get("COVA_BLOBNET_CKPT") or str(
        REPO / "artifacts" / "blobnet_demo.npz"
    )
    _, variables, wmeta = load_artifact(ckpt, args.device)
    print(f"loaded BlobNet weights from {ckpt} ({wmeta or '3ch'})")

    # Optional oracle: COVA_YOLO_WEIGHTS=yolov4.weights (darknet);
    # COVA_YOLO_CFG=yolov4.cfg builds the topology from the cfg file.
    detector = None
    yolo = os.environ.get("COVA_YOLO_WEIGHTS")
    if yolo:
        from cova_tpu_torch.models.yolov4 import make_yolo_detector

        detector = make_yolo_detector(
            yolo, cfg_path=os.environ.get("COVA_YOLO_CFG"), device=args.device
        )
        print(f"using YOLOv4 oracle from {yolo}")

    cfg = CovaConfig(last="full" if detector is not None else "select")
    cfg = dataclasses.replace(
        cfg,
        compressed=dataclasses.replace(
            cfg.compressed,
            use_nnz_channel=bool(wmeta.get("use_nnz_channel", False)),
            signed_mv=bool(wmeta.get("signed_mv", False)),
            host_tracking=not args.device_tracking,
        ),
    )
    pipe = CovaPipeline(
        args.input, args.output_dir, cfg, variables=variables, detector=detector,
        device=args.device,
    )
    result = pipe.run(max_frames=args.max_frames)

    total = result.num_frames
    print(f"Elapsed seconds: {result.elapsed_seconds:.2f}")
    print(f"Frames: {total} ({total / max(result.elapsed_seconds, 1e-9):.0f} fps)")
    print(
        f"Dropped: {result.dropped}, decoded (dependency): "
        f"{result.decoded_dependency}, decoded (inference): "
        f"{result.decoded_inference}"
    )
    print(f"Decode filter rate: {result.decode_filter_rate:.3f}")
    print(f"Inference filter rate: {result.inference_filter_rate:.3f}")
    print(f"Dead tracks reported: {result.dead_tracks}")
    tm = result.timers
    print(
        f"Stage seconds: entdec={tm.entropy_decode:.2f} "
        f"device={tm.device_dispatch:.2f} mirror={tm.host_mirror:.2f} "
        f"pixel={tm.pixel_stage:.2f}"
    )
    print(f"CSV outputs in {args.output_dir}: track, dnn, assoc, stationary")


if __name__ == "__main__":
    main()

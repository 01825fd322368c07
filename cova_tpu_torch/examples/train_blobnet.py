"""Train BlobNet on a video, end to end (the PyTorch port's counterpart of
examples/train_blobnet.py):

    python -m cova_tpu_torch.examples.train_blobnet VIDEO.mp4 CKPT_DIR
        [epochs] [max_frames] [--nnz] [--signed] [--augment] [--device cpu]

Builds the training set (full decode, MOG2 labels on --device,
entropy-decoded metadata windows) into CKPT_DIR/dataset.npz unless that
file already holds one, trains with the Jaccard loss on --device (the
card by default; it raises without one), and writes CKPT_DIR/final/state.pt
(`torch.save` of the best epoch's state_dict, in place of the JAX
example's orbax checkpoint of its variables) and CKPT_DIR/weights.npz (the
Flax-layout weight artifact both packages load).

Building the training set needs the selective pixel decoder: a codec
library built without libavcodec (the stub decoder) cannot, so on such a
machine run it from a cached CKPT_DIR/dataset.npz (VIDEO is then unread).

--nnz adds the residual-density 4th input channel; --signed trains on
mean signed offset-128 MV channels; --augment mirrors the training
windows horizontally and vertically (MV channels sign-corrected).
^C stops after the current step and keeps the best epoch so far; a
second ^C aborts.
"""

from __future__ import annotations

import argparse
import os
import signal
import sys


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("video")
    ap.add_argument("ckpt_dir")
    ap.add_argument("epochs", nargs="?", type=int, default=20)
    ap.add_argument("max_frames", nargs="?", type=int, default=None)
    ap.add_argument("--nnz", action="store_true", help="4th input channel: residual nnz")
    ap.add_argument("--signed", action="store_true", help="signed offset-128 MV channels")
    ap.add_argument("--augment", action="store_true", help="hflip x vflip views")
    ap.add_argument("--device", default="cuda",
                    help="torch device of labels and training (cpu on request)")
    return ap


def main(argv=None) -> None:
    args = parser().parse_intermixed_args(argv)

    # Two-stage SIGINT like the reference (train-blobnet.py:21-42).
    stop = {"flag": False}

    def handler(signum, frame):
        if not stop["flag"]:
            print("stopping after current step; ^C again to abort")
            stop["flag"] = True
        else:
            sys.exit(1)

    previous = signal.signal(signal.SIGINT, handler)
    try:
        _run(args, lambda: stop["flag"])
    finally:
        signal.signal(signal.SIGINT, previous)


def _run(args, should_stop) -> None:
    import numpy as np
    import torch

    from cova_tpu_torch.models.blobnet import BlobNetConfig, save_params_npz
    from cova_tpu_torch.models.train_blobnet import train_blobnet
    from cova_tpu_torch.utils.dataset import (
        ArrayDataset,
        augment_training_set,
        build_training_set,
    )

    cache = os.path.join(args.ckpt_dir, "dataset.npz")
    if os.path.exists(cache):
        with np.load(cache) as d:
            x, y = d["x"], d["y"]
        print(f"loaded cached dataset x {x.shape}")
    else:
        x, y = build_training_set(
            args.video, out_path=cache, max_frames=args.max_frames,
            use_nnz=args.nnz, signed_mv=args.signed, device=args.device,
        )

    if args.augment:
        x, y = augment_training_set(x, y, signed_mv=args.signed)
        print(f"augmented dataset x {x.shape} (hflip x vflip)")

    ds = ArrayDataset(x, y, batch=4)
    _, state_dict = train_blobnet(
        ds,
        epochs=args.epochs,
        config=BlobNetConfig(in_channels=4 if args.nnz else 3),
        should_stop=should_stop,
        log_every=100,
        signed_mv=args.signed,
        device=args.device,
    )

    final = os.path.join(args.ckpt_dir, "final")
    os.makedirs(final, exist_ok=True)
    torch.save({"state_dict": state_dict}, os.path.join(final, "state.pt"))
    print(f"checkpoint saved to {final}/state.pt")

    npz_path = os.path.join(args.ckpt_dir, "weights.npz")
    save_params_npz(
        npz_path,
        state_dict,
        meta={
            "in_channels": 4 if args.nnz else 3,
            "signed_mv": args.signed,
            "use_nnz_channel": args.nnz,
        },
    )
    print(f"npz weights saved to {npz_path}")


if __name__ == "__main__":
    main()

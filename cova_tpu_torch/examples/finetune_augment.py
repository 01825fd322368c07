"""Augmented fine-tune: adapt trained BlobNet weights to mirrored views
(the PyTorch port's counterpart of examples/finetune_augment.py):

    python -m cova_tpu_torch.examples.finetune_augment BASE.npz OUT.npz
        [VIDEO] [--epochs 6] [--max-frames 1200] [--extra V.mp4 [--extra ...]]
        [--dataset DATASET.npz] [--device cpu]

BASE.npz is a trained weight artifact (cova_tpu_torch.examples.train_blobnet's
or the JAX example's weights.npz); its stored input contract
(in_channels, signed_mv) drives the dataset packing. The training set is
built from VIDEO (max_frames of it) and each --extra video (all of it),
or read from --dataset (a cached training set such as train_blobnet's
dataset.npz; building one needs the selective pixel decoder, which a
codec library built without libavcodec lacks), then mirrored
horizontally and vertically (4 label-consistent views a window), and the
weights are fine-tuned on --device (the card by default) with Adam at a
constant 1e-4, the dataset shuffled with seed 1. The result goes to
OUT.npz in the same Flax layout.
"""

from __future__ import annotations

import argparse
import os


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("base")
    ap.add_argument("out")
    ap.add_argument("video", nargs="?", default=None)
    ap.add_argument("--epochs", type=int, default=6)
    ap.add_argument("--max-frames", type=int, default=1200,
                    help="frames of VIDEO to build the training set from")
    ap.add_argument("--extra", action="append", default=[], metavar="VIDEO",
                    help="another video whose whole training set is mixed in")
    ap.add_argument("--dataset", default=None,
                    help="a cached training set (npz with x, y) instead of VIDEO")
    ap.add_argument("--device", default="cuda",
                    help="torch device of labels and training (cpu on request)")
    return ap


def main(argv=None) -> None:
    ap = parser()
    args = ap.parse_intermixed_args(argv)
    if (args.video is None) == (args.dataset is None):
        ap.error("give either VIDEO or --dataset")

    import numpy as np
    import torch

    from cova_tpu_torch.models.blobnet import load_artifact, save_params_npz
    from cova_tpu_torch.models.train_blobnet import make_adam, make_train_step
    from cova_tpu_torch.utils.dataset import (
        ArrayDataset,
        augment_training_set,
        build_training_set,
    )

    model, _, meta = load_artifact(args.base, args.device)
    use_nnz = bool(meta.get("use_nnz_channel", False))
    signed = bool(meta.get("signed_mv", False))
    print(f"base contract: {meta}")

    if args.dataset:
        with np.load(args.dataset) as d:
            x, y = d["x"], d["y"]
        print(f"loaded cached dataset x {x.shape}")
    else:
        x, y = build_training_set(
            args.video, max_frames=args.max_frames, use_nnz=use_nnz,
            signed_mv=signed, device=args.device,
        )
    for ev in args.extra:
        ex, ey = build_training_set(ev, use_nnz=use_nnz, signed_mv=signed,
                                    device=args.device)
        x = np.concatenate([x, ex])
        y = np.concatenate([y, ey])
        print(f"mixed in {ev}: +{len(ex)} windows")
    x, y = augment_training_set(x, y, signed_mv=signed)
    print(f"augmented dataset x {x.shape} (hflip x vflip)")

    ds = ArrayDataset(x, y, batch=4, seed=1)
    generator = torch.Generator(args.device).manual_seed(0)
    step = make_train_step(model, make_adam(model, 1e-4), signed_mv=signed,
                           generator=generator)
    for epoch in range(args.epochs):
        el = ep = er = nb = 0
        for batch in ds:
            m = step(batch)
            el += float(m["loss"])
            ep += float(m["precision"])
            er += float(m["recall"])
            nb += 1
        print(
            f"ft epoch {epoch}: loss={el / nb:.3f} prec={ep / nb:.3f} "
            f"rec={er / nb:.3f}",
            flush=True,
        )

    save_params_npz(
        args.out,
        model.state_dict(),
        meta={
            **meta,
            "trained_on": f"{meta.get('trained_on', args.base)} "
            f"+ {args.epochs}-epoch hflip/vflip-augmented fine-tune lr 1e-4"
            + "".join(f" + {os.path.basename(e)}" for e in args.extra),
        },
    )
    print(f"saved {args.out}")


if __name__ == "__main__":
    main()

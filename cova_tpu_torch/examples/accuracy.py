"""Query-accuracy evaluation CLI (the PyTorch port's counterpart of
examples/accuracy.py):

    python -m cova_tpu_torch.examples.accuracy GT_DNN_CSV COVA_OUT_DIR \
        DURATION_SECONDS [--targets 2,5,7] [--region "upper left"]

Port of the reference's `parse/accuracy.py`: compares a CoVA output
directory (assoc.csv + stationary.csv) against a ground-truth dnn.csv
(from the naive full-decode pipeline) and prints BP/GC/BPL/GCL and the
number of evaluation slots. Host numpy only: no device work.
"""

from __future__ import annotations

import argparse


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("gt_csv")
    ap.add_argument("cova_dir")
    ap.add_argument("duration", type=float)
    ap.add_argument("--targets", default="2", help="comma-separated class ids")
    ap.add_argument("--region", default="upper left")
    return ap


def main(argv=None) -> None:
    args = parser().parse_args(argv)

    from cova_tpu_torch.query.metrics import load_boxes_csv, load_cova, parse_query

    gt = load_boxes_csv(args.gt_csv)
    cova = load_cova(args.cova_dir)
    targets = [int(x) for x in args.targets.split(",")]

    res = parse_query(gt, cova, args.duration, targets, region=args.region)
    print(f"BP accuracy:        {res.bp_accuracy:.4f}")
    print(f"GC error:           {res.gc_error:.4f}")
    print(f"BP accuracy (local): {res.bp_accuracy_local:.4f}")
    print(f"GC error (local):    {res.gc_error_local:.4f}")
    print(f"slots evaluated:     {res.num_slots}")


if __name__ == "__main__":
    main()

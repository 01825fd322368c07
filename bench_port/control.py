"""The control of the comparison: the plain reference put in the
program's place, computed in the precision below the configuration's
(TF32 for float32 with TF32 off), and held to the float32 reference by
the same numbers as the program. It has to come out not correct.

    python3 -m bench_port.control --workload CELL --seeds A,B,C [--out F]

For each seed, in one process: the cell is built and one cycle of jobs
runs as a window would run it; then the program's readings (check.py)
and the control's are printed, one JSON line a seed. The benchmark's own
runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys

from bench_port import check, run


def control_readings(cell, jobs) -> dict:
    """mask_gap and the oracle's numbers of the TF32 reference against the
    float32 reference, on the window's inputs."""
    import torch

    from bench_port.ref import blobnet_ref

    cc = cell.conf["pipeline"]["compressed"]
    f, t = cell.cfg.compressed.batch_frames, cell.cfg.video.timestep
    thr = cell.cfg.compressed.mask_threshold
    blob = blobnet_ref.load(run.ROOT / cell.conf["blobnet"], cell.device)
    reference = None
    out = {"mask_gap": 0.0, "mask_bits_off": 0}
    if cell.detector is not None:
        reference = cell.oracle.Reference(cell.conf["oracle"], cell.detector.weights, cell.device)
        out.update(dict.fromkeys(cell.oracle.LIMITS, 0))
    done = set()
    for job in jobs:
        if job.error or job.rotation in done:
            continue
        done.add(job.rotation)
        range_pts = check.display_pts(cell.samples[job.rotation],
                                      run.check_bounds(cell, job.rotation))
        for c, meta in enumerate(job.meta):
            probs = {}
            for tf32 in (False, True):
                torch.backends.cudnn.allow_tf32 = tf32
                torch.backends.cuda.matmul.allow_tf32 = tf32
                probs[tf32] = blobnet_ref.chunk_probs(blob, meta, t, cc["use_nnz_channel"],
                                                      cc["signed_mv"], cell.device)
            bits = (probs[True] > thr).cpu().numpy()
            gap, nbits = check.mask_gap(bits, probs[False],
                                        check.live_windows(range_pts, c, f, t), thr)
            out["mask_gap"] = max(out["mask_gap"], gap)
            out["mask_bits_off"] += nbits
        for ts, y, u, v, _, _ in job.frames:
            check.fold(out, reference.control(y, u, v), cell.oracle.FOLD)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    run.set_environment()
    import torch

    if not torch.cuda.is_available():
        run.log("needs a CUDA device")
        return 3
    warm = False
    for seed in (int(s) for s in args.seeds.split(",")):
        cell = run.Cell(args.workload, seed)
        if not warm:
            cell.warm_up()
            warm = True
        jobs, window_s = run.window(cell, 0)
        line = {"workload": args.workload, "seed": seed, "window_s": window_s,
                "program": run.compare(cell, jobs), "control": control_readings(cell, jobs)}
        text = json.dumps(line)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as fh:
                fh.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

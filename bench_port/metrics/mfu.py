"""BlobNet and YOLOv4 over the whole window: the models' operations
(bench_port/flops.py, counted from the published layer shapes: every
window of T frames that describes real frames, every frame the oracle
received) over the window's seconds and the H100's float32 peak outside
the tensor cores (67 TFLOP/s), since both compute float32 with TF32 off.
The card's power limit is logged on standard error."""


def read(run):
    if not run["model_flops"] or run["trace"] is None:
        return None
    return 100.0 * run["model_flops"] / (run["window_s"] * run["peak_flops"])

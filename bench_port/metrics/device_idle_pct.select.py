"""The device: the share of the traced window in which no kernel, copy or
set ran on the card (torch.profiler's CUDA activity).

The same reading as metrics/device_idle_pct.py, for cells that bound
card_ms_per_frame rather than fps."""


def read(run):
    tr = run["trace"]
    if tr is None or not tr.device:
        return None
    return 100.0 * (1.0 - tr.busy_us() / 1e6 / run["window_s"])

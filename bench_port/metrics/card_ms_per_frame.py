"""The card's time a frame: the length of the union of every kernel, copy
and set the card ran in the window (torch.profiler's CUDA activity), per
input frame of the window's jobs. What a frame costs the device, whatever
the host's pace: where one card serves many clips, 1000 / this is the
frames a second it carries."""


def read(run):
    tr = run["trace"]
    if tr is None or not tr.device or not run["frames"]:
        return None
    return tr.busy_us() / 1e3 / run["frames"]

"""The masks step (pipeline/compressed.py `run_chunk_masks`: the wire
cells unpacked, the windows stacked, BlobNet, the threshold, the bit
packing): device time of the operations launched inside the harness's
`bench.masks` range around each chunk's call, per chunk.

The same reading as metrics/masks_ms_per_chunk.py, for cells that bound
card_ms_per_frame rather than fps."""


def read(run):
    tr = run["trace"]
    if tr is None or not run["chunks"]:
        return None
    us = tr.issued_in("bench.masks")
    return us / 1e3 / run["chunks"] if us > 0 else None

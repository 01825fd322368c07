"""SORT over a chunk of windows (K7): the CUDA kernel's wrapper and its
plain PyTorch version.

`sort_scan(state, boxes, ts0, nwin, gamma, cfg)` runs the tracker of the
all-device stage over a chunk: for each of the R lanes (GoP ranges) and
each of the F windows in order, `tracker/sort.sort_step` (Kalman predict,
IoU costs, the overflow auction, update, lifecycle, births) on that
window's boxes at frame index ts0 + i * gamma, the state kept only for
windows below the lane's `nwin` (a short range's padding tail still emits
its outputs, computed from the unchanged state). It returns the new
`SortState` and the `SortOutputs` stacked to (R, F, ...): the program XLA
compiled on the TPU for the `lax.scan` of cova_tpu/pipeline/compressed.py,
vmapped over the ranges, with the auction's `while_loop` inside.

A CUDA tensor goes to the hand-written kernel (csrc/sort_kernel.cu: one
block of 256 threads a lane, the lane's state on chip for the whole
chunk, auction rounds of two barriers with a 64-bit atomicMax a bid, one
launch a chunk and no host synchronisation); a CPU tensor goes to
`sort_scan_plain`, the loop of `sort_step`s. There is no fallback between
the two. Both compute in the same order with one rounding an operation
(the Kalman filter of tracker/kalman.py has no `@` and no library inverse
for that reason), so the kernel equals the plain version bit for bit.
The inputs must be finite.
"""

from __future__ import annotations

import ctypes
import dataclasses
import inspect

import numpy as np
import torch

from cova_tpu_torch.config import SortConfig
from cova_tpu_torch.ops.assignment import solve_assignment_overflow
from cova_tpu_torch.ops.cuda import _build
from cova_tpu_torch.tracker.sort import SortOutputs, SortState, sort_step
from cova_tpu_torch.types import Boxes

# The kernel's limits: a thread a slot and a detection (at most 256 a
# block, which leaves the Kalman update its registers), and the lane's
# shared memory within Hopper's 227 KB a block.
KERNEL_MAX_TRACKS = 256
KERNEL_MAX_BOXES = 256
MAX_SMEM_BYTES = 232_448
# The auction as `sort_step` calls it: solve_assignment_overflow's
# defaults, and the tracker's overflow cost.
_AUCTION = inspect.signature(solve_assignment_overflow).parameters
AUCTION_EPS = _AUCTION["eps"].default
AUCTION_MAX_ITERS = _AUCTION["max_iters"].default
OVERFLOW_COST = 3.0


def _where_lane(live: torch.Tensor, new, old):
    """Per lane, the fields of `new` where `live`, else those of `old`."""
    out = {}
    for fld in dataclasses.fields(new):
        a, b = getattr(new, fld.name), getattr(old, fld.name)
        out[fld.name] = torch.where(live.view((-1,) + (1,) * (a.dim() - 1)), a, b)
    return type(new)(**out)


def sort_scan_plain(
    state: SortState, boxes: Boxes, ts0: torch.Tensor, nwin: torch.Tensor, gamma: int,
    cfg: SortConfig,
) -> tuple[SortState, SortOutputs]:
    """The plain version of the kernel on any device: `sort_step` window
    by window, the state carried only where i < nwin."""
    f = boxes.valid.shape[1]
    outs = []
    for i in range(f):
        st2, out = sort_step(state, boxes.map(lambda a: a[:, i]), ts0 + i * gamma, cfg)
        state = _where_lane(i < nwin, st2, state)
        outs.append(out)
    stacked = SortOutputs(**{
        fld.name: torch.stack([getattr(o, fld.name) for o in outs], dim=1)
        for fld in dataclasses.fields(SortOutputs)
    })
    return state, stacked


def shared_bytes(mt: int, md: int) -> int:
    """Shared memory a block of the kernel takes for MT slots and MD
    boxes (csrc/sort_kernel.cu's `shared_words`, 4 bytes each): two 7x7
    covariances a slot, the MD x MT profit matrix, 20 words a box (the
    auction's two 64-bit keys, two windows' boxes), 5 a slot and the
    warps' 16."""
    return 4 * (2 * mt * 49 + md * mt + 20 * md + 5 * mt + 16)


def check_kernel_shape(mt: int, md: int) -> None:
    """Raise ValueError unless the kernel takes MT slots and MD boxes a
    window. `sort_scan` applies it on every device, so a shape that runs
    on the CPU also runs on the card."""
    if not (1 <= mt <= KERNEL_MAX_TRACKS and 1 <= md <= KERNEL_MAX_BOXES):
        raise ValueError(f"sort_scan takes 1-{KERNEL_MAX_TRACKS} track slots and 1-"
                         f"{KERNEL_MAX_BOXES} boxes a window, got {mt} and {md}")
    if shared_bytes(mt, md) > MAX_SMEM_BYTES:
        raise ValueError(f"sort_scan at {mt} slots and {md} boxes needs "
                         f"{shared_bytes(mt, md)} bytes of shared memory a block, over "
                         f"the card's {MAX_SMEM_BYTES}")


_STATE_IN = ("mean", "cov", "exists", "active", "track_id", "start_ts", "last_match", "hits",
             "hit_streak", "time_since_update", "age", "id_counter", "frame_count")
_OUTPUTS = ("track_ltwh", "track_id", "track_id_post", "exists", "active", "predicted",
            "matched_det", "det_track_id", "death", "death_id", "death_start",
            "death_last_match", "death_tsu", "death_active")


class _SortArgs(ctypes.Structure):
    """csrc/sort_kernel.cu's SortArgs: the pointers, then the ints, then
    the floats."""

    _fields_ = (
        [(n, ctypes.c_void_p) for n in ("ltwh", "valid", "ts0", "nwin")]
        + [(n, ctypes.c_void_p) for n in _STATE_IN]
        + [(n + "_o", ctypes.c_void_p) for n in _STATE_IN]
        + [("o_" + n, ctypes.c_void_p) for n in _OUTPUTS]
        + [("rounds", ctypes.c_void_p), ("searches", ctypes.c_void_p)]
        + [(n, ctypes.c_int32) for n in ("lanes", "frames", "mt", "md", "gamma", "min_hits",
                                         "max_age", "max_iters", "quirk")]
        + [(n, ctypes.c_float) for n in ("iou_threshold", "eps", "overflow_cost")]
    )


def _lib() -> ctypes.CDLL:
    lib = _build.load("sort_kernel")
    lib.cova_sort_scan.argtypes = [ctypes.POINTER(_SortArgs), ctypes.c_void_p]
    lib.cova_sort_scan.restype = ctypes.c_int
    return lib


def _check_inputs(state: SortState, boxes: Boxes, ts0, nwin) -> tuple:
    """(R, F, MT, MD) after checking the shapes and types the kernel and
    the plain version share."""
    if boxes.ltwh.dim() != 4 or boxes.ltwh.shape[-1] != 4:
        raise ValueError(f"boxes.ltwh must be (R, F, MD, 4), got {tuple(boxes.ltwh.shape)}")
    r, f, md = boxes.ltwh.shape[:3]
    if f == 0:
        raise ValueError("sort_scan needs at least one window")
    mt = state.mean.shape[1]
    if tuple(boxes.valid.shape) != (r, f, md) or boxes.valid.dtype != torch.bool:
        raise ValueError(f"boxes.valid must be ({r}, {f}, {md}) bool, got "
                         f"{boxes.valid.dtype} {tuple(boxes.valid.shape)}")
    if boxes.ltwh.dtype != torch.float32:
        raise TypeError(f"boxes.ltwh must be float32, got {boxes.ltwh.dtype}")
    want = {"mean": ((r, mt, 7), torch.float32), "cov": ((r, mt, 7, 7), torch.float32),
            "exists": ((r, mt), torch.bool), "active": ((r, mt), torch.bool),
            "id_counter": ((r,), torch.int32), "frame_count": ((r,), torch.int32)}
    for name in _STATE_IN:
        shape, dtype = want.get(name, ((r, mt), torch.int32))
        t = getattr(state, name)
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"state.{name} must be {shape} {dtype}, got {tuple(t.shape)} "
                             f"{t.dtype}")
    for name, t in (("ts0", ts0), ("nwin", nwin)):
        if tuple(t.shape) != (r,) or t.dtype.is_floating_point:
            raise ValueError(f"{name} must be ({r},) integers, got {t.dtype} {tuple(t.shape)}")
    return r, f, mt, md


def empty_outputs(r: int, f: int, mt: int, md: int, device) -> SortOutputs:
    """Uninitialised SortOutputs of a chunk, each field with the plain
    version's shape and type: the kernel's output buffers."""
    bools = ("exists", "active", "predicted", "death", "death_active")
    special = {"track_ltwh": ((r, f, mt, 4), torch.float32),
               "matched_det": ((r, f, mt), torch.int64),
               "det_track_id": ((r, f, md), torch.int32)}
    out = {}
    for n in _OUTPUTS:
        shape, dtype = special.get(n, ((r, f, mt), torch.bool if n in bools else torch.int32))
        out[n] = torch.empty(shape, dtype=dtype, device=device)
    return SortOutputs(**out)


def sort_scan(
    state: SortState, boxes: Boxes, ts0: torch.Tensor, nwin: torch.Tensor, gamma: int,
    cfg: SortConfig, rounds: torch.Tensor | None = None,
    searches: torch.Tensor | None = None,
) -> tuple[SortState, SortOutputs]:
    """SORT over the F windows of a chunk, every lane at once: boxes with
    leading dims (R, F) (ltwh float32, valid bool), the state of R lanes,
    ts0 and nwin (R,) integers. Returns the new state and the outputs
    stacked to (R, F, ...). `rounds` and `searches`, optional (R, F)
    int32 CUDA tensors, receive the auction's rounds of each lane and
    window and its searches (the rows unassigned at the start of a round,
    summed over its rounds): what `solve_assignment_overflow` counts in
    its `rounds` and `row_rounds`.

    On CUDA this launches the kernel once on the current stream and
    counts the launch in `sort_scan.launches`; it raises if the kernel
    cannot build or launch. On the CPU it runs `sort_scan_plain`."""
    r, f, mt, md = _check_inputs(state, boxes, ts0, nwin)
    check_kernel_shape(mt, md)
    dev = boxes.ltwh.device
    if dev.type == "cpu":
        return sort_scan_plain(state, boxes, ts0, nwin, gamma, cfg)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if any(getattr(state, n).device != dev for n in _STATE_IN) or boxes.valid.device != dev:
        raise ValueError(f"the state and the boxes must lie on {dev}")
    for name, t in (("rounds", rounds), ("searches", searches)):
        if t is not None and (tuple(t.shape) != (r, f) or t.dtype != torch.int32
                              or t.device != dev or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous ({r}, {f}) int32 tensor on {dev}")

    keep = []  # every tensor whose pointer the kernel takes, alive until the launch

    def ptr(t: torch.Tensor) -> int:
        t = t.contiguous()
        keep.append(t)
        return t.data_ptr()

    new_state = SortState(**{n: torch.empty_like(getattr(state, n),
                                                 memory_format=torch.contiguous_format)
                             for n in _STATE_IN})
    outputs = empty_outputs(r, f, mt, md, dev)
    if r == 0:
        return new_state, outputs
    args = _SortArgs(
        ptr(boxes.ltwh), ptr(boxes.valid), ptr(ts0.to(dev, torch.int32)),
        ptr(nwin.to(dev, torch.int32)),
        *[ptr(getattr(state, n)) for n in _STATE_IN],
        *[ptr(getattr(new_state, n)) for n in _STATE_IN],
        *[ptr(getattr(outputs, n)) for n in _OUTPUTS],
        rounds.data_ptr() if rounds is not None else None,
        searches.data_ptr() if searches is not None else None,
        r, f, mt, md, int(gamma), int(cfg.min_hits), int(cfg.max_age), AUCTION_MAX_ITERS,
        int(bool(cfg.reproduce_from_x_quirk)),
        float(np.float32(cfg.iou_threshold)), float(np.float32(AUCTION_EPS)),
        float(np.float32(OVERFLOW_COST)),
    )
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = _lib().cova_sort_scan(ctypes.byref(args), stream)
    if rc != 0:
        raise RuntimeError(f"sort_kernel launch failed: cudaError {rc}")
    sort_scan.launches += 1
    return new_state, outputs


sort_scan.launches = 0

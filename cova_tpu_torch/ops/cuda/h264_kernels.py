"""H.264 reconstruction on the card: the wrappers of K8 `h264_inter`
(csrc/h264_inter.cu), K9 `h264_intra` (csrc/h264_intra.cu) and K10
`h264_deblock` (csrc/h264_deblock.cu).

Each takes the frame pool (slots x plane bytes, uint8), the slot of the
picture being rebuilt and its syntax (ops/h264/picture.Picture) and
writes the slot in place: K8 the inter macroblocks, K9 the intra and
I_PCM ones in waves, K10 the loop filter over the picture, a block a
macroblock row. A CUDA pool goes to the kernel, which is built by nvcc at
first use and counted in `.launches`; a CPU pool goes to the plain
version (ops/h264/). There is no fallback between the two: a build or
launch failure raises.

The kernels read the spec's tables from a header generated from
ops/h264/tables.py into the build directory.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from cova_tpu_torch.ops.cuda import _build
from cova_tpu_torch.ops.h264 import deblock, inter, intra, tables
from cova_tpu_torch.ops.h264 import transform as tf
from cova_tpu_torch.ops.h264.picture import Picture

_lock = threading.Lock()


class RecArgs(ctypes.Structure):
    """csrc/h264_common.cuh's RecArgs."""

    _fields_ = [
        ("pool", ctypes.c_void_p), ("plane", ctypes.c_longlong), ("cur", ctypes.c_int),
        ("W", ctypes.c_int), ("H", ctypes.c_int), ("mb_w", ctypes.c_int),
        ("mb_h", ctypes.c_int), ("mb", ctypes.c_void_p), ("cell", ctypes.c_void_p),
        ("ipred", ctypes.c_void_p), ("coef", ctypes.c_void_p), ("pcm_row", ctypes.c_void_p),
        ("pcm", ctypes.c_void_p), ("slices", ctypes.c_void_p), ("slot_of", ctypes.c_void_p),
        ("ls4", ctypes.c_void_p), ("ls8", ctypes.c_void_p), ("poc", ctypes.c_int),
        ("list", ctypes.c_void_p), ("n_list", ctypes.c_int), ("done", ctypes.c_void_p),
        ("ticket", ctypes.c_void_p),
    ]


def tables_header():
    """Write build/h264_tables.h from tables.py when its text changed;
    returns its path."""
    path = _build.BUILD / "h264_tables.h"
    text = tables.c_header()
    with _lock:
        if not path.exists() or path.read_text() != text:
            _build.BUILD.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(".tmp")
            tmp.write_text(text)
            tmp.replace(path)
    return path


def deps():
    return (tables_header(), _build.CSRC / "h264_common.cuh")


_fns: dict = {}


def _lib(name):
    if name not in _fns:
        fn = getattr(_build.load(name, deps=deps()), f"cova_{name}")
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return _fns[name]


def wave_order(mbs, mb_w):
    """Macroblock indices `mbs` sorted by wave x + 2y (then raster)."""
    x, y = mbs % mb_w, mbs // mb_w
    return mbs[torch.argsort((x + 2 * y) * (1 << 20) + mbs)]


def launch_args(pool, slot, pic: Picture, lst, done=None, ticket=None):
    """The RecArgs of a launch over macroblocks `lst` (int32; None for
    K10, which takes the picture's rows)."""
    n = pic.mb.shape[0]
    pcm_row = torch.full((n,), -1, dtype=torch.int32, device=pool.device)
    if pic.pcm_mb.numel():
        pcm_row[pic.pcm_mb] = torch.arange(pic.pcm_mb.numel(), dtype=torch.int32,
                                           device=pool.device)
    keep = [pcm_row]
    t = lambda x: x.data_ptr() if x is not None else None  # noqa: E731
    a = RecArgs(
        t(pool), pool.shape[1], slot, pic.width, pic.height, pic.mb_w, pic.mb_h,
        t(pic.mb), t(pic.cell), t(pic.ipred), t(pic.coef), t(pcm_row), t(pic.pcm),
        t(pic.slices), t(pic.slot_of), t(pic.ls4), t(pic.ls8), pic.poc, t(lst),
        lst.numel() if lst is not None else 0, t(done), t(ticket))
    return a, keep


def _check(pool, pic):
    for name in ("mb", "cell", "ipred", "coef", "slices", "ls4", "ls8"):
        x = getattr(pic, name)
        if x.dtype != torch.int32 or not x.is_contiguous() or x.device != pool.device:
            raise ValueError(f"{name} must be contiguous int32 on {pool.device}")
    if pic.slot_of.dtype != torch.int64 or pool.dtype != torch.uint8:
        raise ValueError("slot_of must be int64 and the pool uint8")
    if pool.shape[1] != pic.plane_bytes:
        raise ValueError(f"pool slots hold {pool.shape[1]} bytes, the picture "
                         f"{pic.plane_bytes}")


def _launch(name, pool, slot, pic, lst, done=None, ticket=None):
    _check(pool, pic)
    a, keep = launch_args(pool, slot, pic, lst, done, ticket)
    stream = torch.cuda.current_stream(pool.device).cuda_stream
    with torch.cuda.device(pool.device):
        rc = _lib(name)(ctypes.byref(a), stream)
    del keep
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")


def _flags(pic):
    f = pic.mb[:, 0]
    decoded = (f & tf.F_DECODED) != 0
    return decoded & ((f & tf.F_INTRA) == 0), decoded & ((f & tf.F_INTRA) != 0)


def h264_inter(pool: torch.Tensor, slot: int, pic: Picture):
    """K8: the inter macroblocks of `pic` into pool[slot]."""
    if pool.device.type == "cpu":
        return inter.reconstruct_inter(pool, slot, pic)
    lst = _flags(pic)[0].nonzero().flatten().to(torch.int32)
    if lst.numel():
        _launch("h264_inter", pool, slot, pic, lst)
        h264_inter.launches += 1


def h264_intra(pool: torch.Tensor, slot: int, pic: Picture):
    """K9: the intra and I_PCM macroblocks of `pic` into pool[slot], in
    waves, after K8."""
    if pool.device.type == "cpu":
        return intra.reconstruct_intra(pool, slot, pic)
    sel = _flags(pic)[1]
    mbs = sel.nonzero().flatten()
    if mbs.numel():
        lst = wave_order(mbs, pic.mb_w).to(torch.int32)
        done = (~sel).to(torch.int32)
        ticket = torch.zeros(1, dtype=torch.int32, device=pool.device)
        _launch("h264_intra", pool, slot, pic, lst, done, ticket)
        h264_intra.launches += 1


def h264_deblock(pool: torch.Tensor, slot: int, pic: Picture):
    """K10: the loop filter over pool[slot], in place."""
    if pool.device.type == "cpu":
        return deblock.deblock(pool, slot, pic)
    # Each row's progress counter, then the row ticket.
    rows = torch.zeros(pic.mb_h + 1, dtype=torch.int32, device=pool.device)
    _launch("h264_deblock", pool, slot, pic, None, rows[:-1], rows[-1:])
    h264_deblock.launches += 1


h264_inter.launches = 0
h264_intra.launches = 0
h264_deblock.launches = 0

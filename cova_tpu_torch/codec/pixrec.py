"""The port's selective pixel decoder: H.264 reconstruction on a torch
device (the role NVDEC plays in the reference, and libavcodec in the JAX
package's `PixelDecoder`).

The host decodes each access unit's syntax (csrc/rec: the port's copy of
the shared entropy decoder, which keeps the levels, intra modes, QPs,
motion and slice headers); the device rebuilds the picture: inter
prediction and residual (K8), intra prediction in macroblock waves (K9),
then the loop filter (K10), in place on the frame, which then serves as
a reference. On a CUDA device the three are the hand-written kernels
(ops/cuda/h264_kernels.py); on the CPU their plain versions.

Frames come out in POC order, each with the pts of its own access unit,
cropped as the SPS says: the smallest POC leaves once more frames wait
than the SPS's reorder depth allows (its VUI max_num_reorder_frames, else
the level's DPB size), and all of them at an IDR and at flush. Scope:
progressive 4:2:0 8-bit streams (CABAC or CAVLC, I/P/B slices, several
slices a picture, the 8x8 transform and scaling matrices, explicit and
implicit weighted prediction, direct modes, long-term references, any
disable_deblocking_filter_idc, I_PCM). Anything else raises
`UnsupportedStreamError` before a frame is emitted: field pictures
(PAFF), MBAFF, other chroma formats or bit depths, separate colour
planes, transform bypass, constrained intra prediction, SP/SI slices,
MMCO 5.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes

import numpy as np
import torch

from cova_tpu_torch import trace
from cova_tpu_torch.codec import StreamGeometryError, lib
from cova_tpu_torch.ops.h264 import tables
from cova_tpu_torch.ops.h264.picture import S_REF_PIC, SLICE_INTS, S_SCALE4, S_SCALE8, Picture

# The device of a decoder made without one: the card, unless a caller
# that was asked for another (a script's --device) says so around its
# work (default_device), so that the copied modules that decode pixels
# (pipeline/naive.py, utils/dataset.py) follow it.
_default_device = "cuda"


@contextlib.contextmanager
def default_device(device):
    """Decoders made without a device inside this block decode on
    `device`."""
    global _default_device
    old, _default_device = _default_device, str(device)
    try:
        yield
    finally:
        _default_device = old


_UNSUPPORTED = -100


_SCOPE = ("stream outside the pixel decoder's scope (field or MBAFF pictures, chroma "
          "other than 4:2:0, more than 8 bits, separate colour planes, transform bypass, "
          "constrained intra prediction, SP/SI slices or MMCO 5)")


class UnsupportedStreamError(RuntimeError):
    """The stream uses a coding tool outside the decoder's scope."""


def check_stream(demux, device=None) -> None:
    """Raise before any work unless `demux`'s stream can be decoded on
    `device`: RuntimeError for a CUDA device that is absent,
    UnsupportedStreamError for a stream outside the scope (read from its
    first access unit)."""
    dec = PixelDecoder(demux.extradata(), device=device)
    try:
        dec.probe(demux.read_sample(0))
    finally:
        dec.close()


def _bind(L):
    if getattr(L, "_rec_bound", False):
        return L
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    L.cova_rec_create.restype = vp
    L.cova_rec_create.argtypes = [vp, i32]
    L.cova_rec_destroy.argtypes = [vp]
    L.cova_rec_send.argtypes = [vp, vp, i32]
    L.cova_rec_send.restype = i32
    L.cova_rec_info.argtypes = [vp, vp]
    L.cova_rec_copy.argtypes = [vp] * 10
    L._rec_bound = True
    return L


class Syntax:
    """One picture's syntax as host numpy arrays (RecPicture)."""

    def __init__(self, h):
        L = lib()
        info = np.zeros(16, np.int32)
        L.cova_rec_info(h, info.ctypes.data)
        self.mb_w, self.mb_h, self.pic_id, self.poc, idr, *self.crop = info[:9].tolist()
        self.idr = bool(idr)
        ns, nc, npcm, ndpb, self.reorder = info[9:14].tolist()
        n = self.mb_w * self.mb_h
        self.mb = np.empty((n, 8), np.int32)
        self.cell = np.empty((n, 16, 6), np.int16)
        self.ipred = np.empty((n, 16), np.int8)
        self.cpos = np.empty(nc, np.int32)
        self.cval = np.empty(nc, np.int16)
        self.pcm_mb = np.empty(npcm, np.int32)
        self.pcm = np.empty((npcm, 384), np.uint8)
        self.slices = np.empty((ns, SLICE_INTS), np.int32)
        self.dpb = np.empty(ndpb, np.int32)
        L.cova_rec_copy(h, *(a.ctypes.data for a in (
            self.mb, self.cell, self.ipred, self.cpos, self.cval, self.pcm_mb, self.pcm,
            self.slices, self.dpb)))

    def picture(self, device, slot_of_pic) -> Picture:
        """The syntax as a Picture on `device`; slot_of_pic maps picture
        identities to pool slots."""
        n = self.mb.shape[0]
        ns = self.slices.shape[0]
        ids = self.slices[:, S_REF_PIC:S_REF_PIC + 64].reshape(ns, 2, 32)
        slot_of = np.zeros((ns, 2, 32), np.int64)
        for (s, lx, r), pid in np.ndenumerate(ids):
            if pid >= 0:
                if pid not in slot_of_pic:
                    raise RuntimeError(f"reference picture {pid} is not in the DPB")
                slot_of[s, lx, r] = slot_of_pic[pid]
        ls4 = np.empty((ns, 6, 6, 16), np.int32)
        ls8 = np.empty((ns, 2, 6, 64), np.int32)
        for s in range(ns):
            ls4[s], ls8[s] = tables.level_scale(self.slices[s, S_SCALE4:S_SCALE4 + 96],
                                                self.slices[s, S_SCALE8:S_SCALE8 + 128])
        dev = torch.device(device)
        tracing = trace.enabled()
        sent = []  # bytes of each host-to-device copy, while tracing

        def up(a, dtype=None):
            a = np.ascontiguousarray(a)
            if tracing:
                sent.append(a.nbytes)
            t = torch.from_numpy(a).to(dev)
            return t if dtype is None else t.to(dtype)

        coef = torch.zeros(n * 384, dtype=torch.int32, device=dev)
        if self.cpos.size:
            coef[up(self.cpos, torch.long)] = up(self.cval, torch.int32)
        pic = Picture(
            mb_w=self.mb_w, mb_h=self.mb_h, poc=self.poc, mb=up(self.mb),
            cell=up(self.cell, torch.int32), ipred=up(self.ipred, torch.int32),
            coef=coef.view(n, 384), pcm_mb=up(self.pcm_mb, torch.long), pcm=up(self.pcm),
            slices=up(self.slices), slot_of=up(slot_of), ls4=up(ls4), ls8=up(ls8))
        if tracing:
            trace.count("pixdec.uploads", len(sent))
            trace.count("pixdec.upload_bytes", sum(sent))
        return pic


def reconstruct(pool, slot, pic: Picture):
    """Rebuild one picture into pool[slot]: K8, K9, then K10 on a CUDA
    pool, their plain versions on a CPU pool."""
    if pool.device.type == "cuda":
        from cova_tpu_torch.ops.cuda import h264_kernels as K

        K.h264_inter(pool, slot, pic)
        K.h264_intra(pool, slot, pic)
        K.h264_deblock(pool, slot, pic)
        return
    from cova_tpu_torch.ops.h264 import deblock, inter, intra, transform

    res = transform.residual(pic.coef, pic.mb, pic.ls4, pic.ls8)
    inter.reconstruct_inter(pool, slot, pic, res)
    intra.reconstruct_intra(pool, slot, pic, res)
    deblock.deblock(pool, slot, pic)


class PixelDecoder:
    """Selective pixel decoder with the interface of the JAX package's
    libavcodec one: send(au, pts), flush(), pop(width, height), close().

    device: "cuda" (the default, or default_device's; raises without a
    card) or "cpu".
    export_mvs is the JAX package's validation oracle for the shared
    entropy decoder and is not offered here."""

    def __init__(self, extradata, export_mvs: bool = False, device=None):
        if export_mvs:
            raise ValueError("export_mvs is not offered by the port's pixel decoder")
        self.device = torch.device(device or _default_device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("the pixel decoder's device is CUDA, and no CUDA device "
                               'is available (pass device="cpu" for the CPU)')
        if not extradata:
            raise RuntimeError("the pixel decoder needs the stream's avcC extradata")
        L = _bind(lib())
        buf = (ctypes.c_uint8 * len(extradata)).from_buffer_copy(extradata)
        self._h = L.cova_rec_create(buf, len(extradata))
        self._destroy = L.cova_rec_destroy
        if not self._h:
            raise RuntimeError("not an avcC record")
        self._pool = None
        self._free: list[int] = []
        self._slot_of_pic: dict[int, int] = {}
        self._held: set[int] = set()
        self._pending: list[tuple] = []  # (poc, pts, slot, pic_id, crop)
        self._out = collections.deque()

    # --- frame buffers ----------------------------------------------------
    def _slot(self, plane):
        if self._pool is None or self._pool.shape[1] != plane:
            if self._pool is not None and (self._pending or self._held):
                raise StreamGeometryError("the coded picture size changed mid-stream")
            self._pool = torch.zeros((8, plane), dtype=torch.uint8, device=self.device)
            self._free = list(range(8))
            self._slot_of_pic.clear()
        if not self._free:
            old = self._pool
            self._pool = torch.zeros((2 * old.shape[0], plane), dtype=torch.uint8,
                                     device=self.device)
            self._pool[:old.shape[0]] = old
            self._free = list(range(old.shape[0], 2 * old.shape[0]))
        return self._free.pop(0)

    def _release(self):
        live = self._held | {p[3] for p in self._pending}
        for pid in [p for p in self._slot_of_pic if p not in live]:
            self._free.append(self._slot_of_pic.pop(pid))
        self._free.sort()

    def _emit(self, n):
        """Output the n smallest-POC pending frames, in POC order."""
        self._pending.sort(key=lambda p: p[0])
        for poc, pts, slot, pid, crop in self._pending[:n]:
            mb_w, mb_h, (cl, cr, ct, cb) = crop
            W, H = 16 * mb_w, 16 * mb_h
            frame = self._pool[slot]
            y = frame[:W * H].view(H, W)[ct:H - cb, cl:W - cr]
            u = frame[W * H:W * H * 5 // 4].view(H // 2, W // 2)[ct // 2:(H - cb) // 2,
                                                                 cl // 2:(W - cr) // 2]
            v = frame[W * H * 5 // 4:].view(H // 2, W // 2)[ct // 2:(H - cb) // 2,
                                                            cl // 2:(W - cr) // 2]
            with trace.span("cova.pixdec.copy_out"):
                planes = [p.cpu().numpy().copy() for p in (y, u, v)]
            if trace.enabled():
                trace.count("pixdec.copy_out_bytes", sum(p.nbytes for p in planes))
            self._out.append((pts, *planes))
        del self._pending[:n]
        self._release()

    # --- the interface ----------------------------------------------------
    def send(self, au: bytes, pts: int = 0) -> int:
        L = lib()
        buf = (ctypes.c_uint8 * len(au)).from_buffer_copy(au)
        with trace.span("cova.pixdec.syntax"):
            rc = L.cova_rec_send(self._h, buf, len(au))
            if rc == _UNSUPPORTED:
                raise UnsupportedStreamError(_SCOPE)
            if rc != 0:
                raise RuntimeError(f"decode error rc={rc}")
            syn = Syntax(self._h)
        if not (syn.mb[:, 0] & 1).all():
            raise RuntimeError("a slice of the picture is missing")
        if syn.idr:  # no earlier picture is a reference any more
            self._held = set()
            self._emit(len(self._pending))
        plane = 16 * syn.mb_w * 16 * syn.mb_h * 3 // 2
        slot = self._slot(plane)
        with trace.span("cova.pixdec.upload"):
            pic = syn.picture(self.device, self._slot_of_pic)
        with trace.span("cova.pixdec.launch"):
            reconstruct(self._pool, slot, pic)
        trace.count("pixdec.pictures")
        self._slot_of_pic[syn.pic_id] = slot
        self._held = set(syn.dpb.tolist())
        self._pending.append((syn.poc, pts, slot, syn.pic_id, (syn.mb_w, syn.mb_h,
                                                                syn.crop)))
        if len(self._pending) > syn.reorder:
            self._emit(len(self._pending) - syn.reorder)
        else:
            self._release()
        return len(self._out)

    def probe(self, au: bytes) -> None:
        """Decode the syntax of one access unit and raise
        UnsupportedStreamError if the stream is outside the decoder's
        scope; nothing is reconstructed (a fresh decoder's first sample)."""
        buf = (ctypes.c_uint8 * len(au)).from_buffer_copy(au)
        rc = lib().cova_rec_send(self._h, buf, len(au))
        if rc == _UNSUPPORTED:
            raise UnsupportedStreamError(_SCOPE)
        if rc != 0:
            raise RuntimeError(f"decode error rc={rc}")

    def flush(self) -> int:
        self._emit(len(self._pending))
        return len(self._out)

    def pop(self, width: int, height: int):
        """Pop the oldest output frame as (pts, y, u, v) or None."""
        if not self._out:
            return None
        pts, y, u, v = self._out[0]
        if y.shape != (height, width):
            raise StreamGeometryError(
                f"decoded frame is {y.shape[1]}x{y.shape[0]}, expected {width}x{height} "
                "(mid-stream resolution change?)")
        self._out.popleft()
        return pts, y, u, v

    def close(self):
        if getattr(self, "_h", None):
            self._destroy(self._h)
            self._h = None
        self._pool = None

    def __del__(self):
        self.close()

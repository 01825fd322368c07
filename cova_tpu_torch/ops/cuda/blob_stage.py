"""The tail of a BlobNet encoder stage (K4): the CUDA kernel's wrapper and
its plain PyTorch version.

A stage of BlobNet's encoder is a 3x3 convolution per timestep and then
its tail: relu, BatchNorm, the 2x2 max pool zero-padded top/left where
the pooled size was odd, and PointWiseTemporal (two TxT mixes over the T
axis, each followed by relu, the residual add and a last relu).
`blob_stage(y, bn, pwt, batch)` computes that tail from the convolution's
output y (batch * T, C, H, W) and returns the stage output (batch, T, C,
Hp, Wp), contiguous.

A CUDA tensor goes to the hand-written kernel (csrc/blob_stage.cu: one
read of y, one write of the output, the mixes in registers; the layout,
channels-last or NCHW, taken from y's strides); a CPU tensor goes to
`blob_stage_plain`, the eager sequence BlobNet ran before the kernel.
There is no fallback between the two: what the kernel does not take
raises. It computes eval mode only (BatchNorm's running statistics, no
dropout) and has no backward; BlobNet's forward runs the plain version in
train mode and on the CPU.

The kernel rounds in another order than cuDNN's BatchNorm and cuBLAS's
K = 4 products (BatchNorm as (x - mean) * (weight / sqrt(var + eps)) +
bias, the mixes summed t = 0..3 with fused multiply-adds), so it agrees
with the plain version to rounding, not bit for bit. The inputs must be
finite (the kernel's relu and max do not carry a NaN).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from cova_tpu_torch.ops.cuda import _build

# Timesteps a window and mixes a stage the kernel holds (csrc/blob_stage.cu
# kT, kLayers).
KERNEL_T = 4
KERNEL_LAYERS = 2


def pool_pad(x: torch.Tensor) -> torch.Tensor:
    """MaxPool 2x2 (floor) over H, W of (N, C, H, W), then zero-pad
    top/left where the unpooled dim was odd."""
    h, w = x.shape[-2:]
    if h >= 2 and w >= 2:
        y = F.max_pool2d(x, 2)
    else:  # a size-1 dim pools to size 0 (torch refuses that) and pads to 1
        y = x.new_zeros(x.shape[:-2] + (h // 2, w // 2))
    return F.pad(y, (w % 2, 0, h % 2, 0))


def blob_stage_plain(y: torch.Tensor, norm, pwt, batch: int, generator=None) -> torch.Tensor:
    """The stage's tail as eager PyTorch, in any mode and on any device:
    y (batch * T, C, H, W) -> (batch, T, C, Hp, Wp). `norm` is the
    BatchNorm, a callable on (N, C, H, W) (the module itself in eval mode;
    BlobNet passes its Flax-style batch norm, which in train mode uses
    and updates the batch statistics); `pwt` the stage's PointWiseTemporal
    (dropout from `generator` in train mode)."""
    y = pool_pad(norm(F.relu(y)))
    return pwt(y.reshape((batch, y.shape[0] // batch) + y.shape[1:]), generator)


class _Args(ctypes.Structure):
    """csrc/blob_stage.cu's BlobStageArgs, field for field."""

    _fields_ = [
        ("y", ctypes.c_void_p), ("stride", ctypes.c_longlong * 4),
        ("batch", ctypes.c_int), ("c", ctypes.c_int), ("h", ctypes.c_int), ("w", ctypes.c_int),
        ("bn_weight", ctypes.c_void_p), ("bn_bias", ctypes.c_void_p),
        ("bn_mean", ctypes.c_void_p), ("bn_var", ctypes.c_void_p),
        ("eps", ctypes.c_float), ("mix", ctypes.c_void_p * KERNEL_LAYERS),
        ("out", ctypes.c_void_p),
    ]


def _lib() -> ctypes.CDLL:
    lib = _build.load("blob_stage")
    lib.cova_blob_stage.argtypes = [ctypes.POINTER(_Args), ctypes.c_void_p]
    lib.cova_blob_stage.restype = ctypes.c_int
    return lib


def _pooled(h: int, w: int) -> tuple:
    return h // 2 + h % 2, w // 2 + w % 2


def _bn_tensors(bn) -> tuple:
    return bn.weight, bn.bias, bn.running_mean, bn.running_var


def _refusal(y: torch.Tensor, bn, pwt, batch: int) -> str | None:
    """Why `blob_stage` does not take these arguments, or None if it
    does: y float32 (batch * 4, C, H, W) on the CPU or CUDA; `bn` a
    BatchNorm2d in eval mode with weights and running statistics, float32
    (C,) each; `pwt` a PointWiseTemporal in eval mode with 2 mixes,
    float32 (4, 4) each; all on y's device and contiguous; no gradient
    asked for. On CUDA besides: fewer than 2**31 output cells a timestep
    (the kernel's 32-bit cell index)."""
    if y.dtype != torch.float32:
        return f"y must be float32, got {y.dtype}"
    if y.device.type not in ("cpu", "cuda"):
        return f"unsupported device {y.device}"
    if y.dim() != 4 or batch < 0 or y.shape[0] != batch * KERNEL_T:
        return f"y must be (batch * {KERNEL_T}, C, H, W) with batch {batch}, got {tuple(y.shape)}"
    if bn.training or pwt.training:
        return "the kernel computes eval mode (running statistics, no dropout)"
    c = y.shape[1]
    params = _bn_tensors(bn)
    if any(p is None for p in params):
        return "BatchNorm needs its weights and running statistics"
    mixes = list(pwt.mix)
    if len(mixes) != KERNEL_LAYERS:
        return f"the kernel holds {KERNEL_LAYERS} mixes, got {len(mixes)}"
    for name, ts, shape in (("BatchNorm", params, (c,)),
                            ("mix", mixes, (KERNEL_T, KERNEL_T))):
        for p in ts:
            if (tuple(p.shape) != shape or p.dtype != torch.float32 or p.device != y.device
                    or not p.is_contiguous()):
                return (f"{name} tensors must be contiguous float32 {shape} on {y.device}, got "
                        f"{p.dtype} {tuple(p.shape)} on {p.device}")
    if torch.is_grad_enabled() and any(p.requires_grad for p in (y, *params, *mixes)):
        return "the kernel has no backward: run it under torch.no_grad()"
    if y.device.type == "cuda":
        hp, wp = _pooled(*y.shape[2:])
        if batch * c * hp * wp >= 2**31:
            return f"{batch * c * hp * wp} output cells a timestep; the kernel takes < 2**31"
    return None


def blob_stage(y: torch.Tensor, bn, pwt, batch: int) -> torch.Tensor:
    """The stage's tail in eval mode: y (batch * 4, C, H, W) float32, the
    convolution's output in any strides -> (batch, 4, C, Hp, Wp)
    contiguous float32, Hp = H // 2 + H % 2 (likewise Wp). Raises
    ValueError on what it does not take (`_refusal`).

    On CUDA this launches the kernel once on the current stream and
    counts the launch in `blob_stage.launches`; it raises if the kernel
    cannot build or launch. On the CPU it runs `blob_stage_plain`."""
    why = _refusal(y, bn, pwt, batch)
    if why is not None:
        raise ValueError(why)
    if y.device.type == "cpu":
        return blob_stage_plain(y, bn, pwt, batch)
    c, h, w = y.shape[1:]
    hp, wp = _pooled(h, w)
    out = torch.empty((batch, KERNEL_T, c, hp, wp), dtype=torch.float32, device=y.device)
    args = _Args(
        y.data_ptr(), (ctypes.c_longlong * 4)(*y.stride()), batch, c, h, w,
        *[p.data_ptr() for p in _bn_tensors(bn)], float(bn.eps),
        (ctypes.c_void_p * KERNEL_LAYERS)(*[m.data_ptr() for m in pwt.mix]), out.data_ptr(),
    )
    stream = torch.cuda.current_stream(y.device).cuda_stream
    with torch.cuda.device(y.device):
        rc = _lib().cova_blob_stage(ctypes.byref(args), stream)
    if rc != 0:
        raise RuntimeError(f"blob_stage launch failed: cudaError {rc}")
    blob_stage.launches += 1
    return out


blob_stage.launches = 0

"""An upsampling block of BlobNet's decoder (K12): the CUDA kernel's
wrapper and its plain PyTorch version.

A decoder block takes the previous block's output x (already normalised)
and, after the first block, the encoder's skip, and computes relu of
their concatenation, dropout (train mode), the 4x4 stride-2 VALID
ConvTranspose2d, the centre crop/pad to the target plane, and then
BatchNorm, or on the last block (the one without a BatchNorm) the 1x1
head and the sigmoid: (B, Cout, th, tw), or (B, th, tw) probabilities.

A CUDA tensor goes to the hand-written kernel (csrc/blob_up.cu: x and the
skip read in place, the transposed convolution as four 2x2 sub-pixel
phases computed only at the kept positions, bias and BatchNorm or head
and sigmoid in the epilogue, one store); `blob_up_plain` is the eager
sequence BlobNet ran before the kernel, in any mode and on any device.
There is no fallback between the two: what the kernel does not take
raises, the CPU among it. It computes eval mode only (BatchNorm's running
statistics, no dropout) and has no backward; BlobNet's forward runs the
plain version in train mode and on the CPU.

All of the kernel's arithmetic is float32 (no TF32); it sums over the
input channels and the four taps in another order than cuDNN's
backward-data engine, so it agrees with the plain version to rounding,
not bit for bit.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from cova_tpu_torch.ops.batch_norm import batch_norm
from cova_tpu_torch.ops.cuda import _build

# Output channels a block of the kernel computes (csrc/blob_up.cu kCt)
# and input channels a slice (kCs).
KERNEL_COUT = 16
KERNEL_CS = 8


def crop_or_pad_center(x: torch.Tensor, th: int, tw: int) -> torch.Tensor:
    """Center crop/pad the last two dims to (th, tw); the extra element
    goes first."""
    h, w = x.shape[-2:]
    dh, dw = h - th, w - tw
    if dh > 0:
        x = x[..., dh // 2 + dh % 2 : h - dh // 2, :]
    elif dh < 0:
        d = -dh
        x = F.pad(x, (0, 0, d // 2 + d % 2, d // 2))
    if dw > 0:
        x = x[..., dw // 2 + dw % 2 : w - dw // 2]
    elif dw < 0:
        d = -dw
        x = F.pad(x, (d // 2 + d % 2, d // 2))
    return x


def crop_offset(full: int, target: int) -> int:
    """The full-size coordinate of `crop_or_pad_center`'s first output
    along one axis of `full` elements cut or padded to `target`: positive
    for a crop, negative for a pad."""
    d = full - target
    return d // 2 + d % 2 if d >= 0 else -((-d) // 2 + (-d) % 2)


def blob_up_plain(x: torch.Tensor, skip, convt, bn, head, target, dropout=None,
                  generator=None, process_group=None) -> torch.Tensor:
    """The block as eager PyTorch, in any mode and on any device: x
    (B, C1, h, w) and `skip` (B, C2, h, w) or None -> (B, Cout, th, tw)
    normalised by `bn` (the Flax-style `batch_norm`, over the global batch
    of `process_group` where given), or with `bn` None the last block's
    (B, th, tw) float32 probabilities through `head` (the 1x1 Conv2d) and
    the sigmoid. `dropout(t, generator)`, where given, applies train
    mode's dropout to the block's input."""
    if skip is not None:
        x = torch.cat([x, skip], dim=1)
    x = F.relu(x)
    if dropout is not None:
        x = dropout(x, generator)
    x = crop_or_pad_center(convt(x), *target)
    if bn is not None:
        return batch_norm(bn, x, process_group)
    return torch.sigmoid(head(x).to(torch.float32))[:, 0]


class _Args(ctypes.Structure):
    """csrc/blob_up.cu's BlobUpArgs, field for field."""

    _fields_ = [
        ("x", ctypes.c_void_p), ("x_stride", ctypes.c_longlong * 4),
        ("skip", ctypes.c_void_p), ("skip_stride", ctypes.c_longlong * 4),
        ("batch", ctypes.c_int), ("c1", ctypes.c_int), ("c2", ctypes.c_int),
        ("h", ctypes.c_int), ("w", ctypes.c_int),
        ("weight", ctypes.c_void_p), ("bias", ctypes.c_void_p), ("cout", ctypes.c_int),
        ("bn_weight", ctypes.c_void_p), ("bn_bias", ctypes.c_void_p),
        ("bn_mean", ctypes.c_void_p), ("bn_var", ctypes.c_void_p), ("eps", ctypes.c_float),
        ("head_weight", ctypes.c_void_p), ("head_bias", ctypes.c_void_p),
        ("th", ctypes.c_int), ("tw", ctypes.c_int), ("oy", ctypes.c_int), ("ox", ctypes.c_int),
        ("out", ctypes.c_void_p),
    ]


def _lib() -> ctypes.CDLL:
    lib = _build.load("blob_up")
    lib.cova_blob_up.argtypes = [ctypes.POINTER(_Args), ctypes.c_void_p]
    lib.cova_blob_up.restype = ctypes.c_int
    return lib


def packed_weight(convt) -> torch.Tensor:
    """`convt`'s (Cin, Cout, 4, 4) weight as the kernel stages it: (Cout /
    16, Cin rounded up to KERNEL_CS, 16 taps, 16 channels), zeros past
    Cin. Kept on the module and made again only when the weight's storage
    or version changes (a move, a load, an optimizer step)."""
    weight = convt.weight
    key = (weight.data_ptr(), weight._version)
    held = convt.__dict__.get("_blob_up_packed")
    if held is not None and held[0] == key:
        return held[1]
    cin, cout = weight.shape[:2]
    with torch.no_grad():
        w = weight.reshape(cin, cout // KERNEL_COUT, KERNEL_COUT, 16).permute(1, 0, 3, 2)
        w = F.pad(w, (0, 0, 0, 0, 0, -cin % KERNEL_CS)).contiguous()
    convt.__dict__["_blob_up_packed"] = (key, w)
    return w


def _bn_tensors(bn) -> tuple:
    return bn.weight, bn.bias, bn.running_mean, bn.running_var


def _largest_offset(t: torch.Tensor) -> int:
    """The largest element offset of (B, C, h, w) tensor t within one
    channel: what the kernel indexes in 32 bits."""
    b, _, h, w = t.shape
    s = t.stride()
    return (b - 1) * s[0] + (h - 1) * s[2] + (w - 1) * s[3]


def _refusal(x: torch.Tensor, skip, convt, bn, head, target) -> str | None:
    """Why `blob_up` does not take these arguments, or None if it does:
    x float32 (B, C1, h, w), `skip` None or float32 (B, C2, h, w), in any
    strides; `convt` a ConvTranspose2d of C1 + C2 inputs and a multiple of
    16 outputs, kernel 4, stride 2, no padding, dilation or groups, with a
    bias; either `bn` (a BatchNorm2d in eval mode with weights and
    running statistics) or `head` (a 1x1 Conv2d of one output with a
    bias, after exactly 16 channels: a block of the kernel holds 16), not
    both; every parameter float32, contiguous and on x's device; a target
    plane that is not empty; element offsets within a channel of x and
    the skip under 2**31; no gradient asked for; x on CUDA."""
    if x.dtype != torch.float32 or (skip is not None and skip.dtype != torch.float32):
        return f"x and the skip must be float32, got {x.dtype}, {getattr(skip, 'dtype', None)}"
    if x.dim() != 4:
        return f"x must be (B, C, h, w), got {tuple(x.shape)}"
    b, c1, h, w = x.shape
    c2 = 0
    if skip is not None:
        if skip.dim() != 4 or skip.shape[0] != b or tuple(skip.shape[2:]) != (h, w):
            return f"the skip must be ({b}, C, {h}, {w}), got {tuple(skip.shape)}"
        c2 = skip.shape[1]
    if not isinstance(convt, torch.nn.ConvTranspose2d):
        return f"convt must be a ConvTranspose2d, got {type(convt).__name__}"
    if (convt.kernel_size != (4, 4) or convt.stride != (2, 2) or convt.padding != (0, 0)
            or convt.output_padding != (0, 0) or convt.dilation != (1, 1)
            or convt.groups != 1 or convt.bias is None):
        return "the kernel computes a 4x4 stride-2 VALID ConvTranspose2d with a bias"
    cout = convt.out_channels
    if convt.in_channels != c1 + c2 or cout % KERNEL_COUT != 0:
        return (f"the transposed convolution must take {c1 + c2} channels and give a multiple "
                f"of {KERNEL_COUT}, got {convt.in_channels} -> {cout}")
    if (bn is None) == (head is None):
        return "a block has a BatchNorm or (the last block) the head, one of the two"
    if bn is not None:
        if bn.training:
            return "the kernel computes eval mode (running statistics, no dropout)"
        params = _bn_tensors(bn)
        if any(p is None for p in params):
            return "BatchNorm needs its weights and running statistics"
        shapes = [(cout,)] * 4
    else:
        if cout != KERNEL_COUT:
            return f"the last block must give {KERNEL_COUT} channels to the head, got {cout}"
        if (not isinstance(head, torch.nn.Conv2d) or head.kernel_size != (1, 1)
                or head.out_channels != 1 or head.in_channels != cout or head.bias is None
                or head.groups != 1):
            return f"the head must be a 1x1 Conv2d of {cout} channels to 1, with a bias"
        params = (head.weight, head.bias)
        shapes = [(1, cout, 1, 1), (1,)]
    params = (convt.weight, convt.bias, *params)
    shapes = [(c1 + c2, cout, 4, 4), (cout,), *shapes]
    for p, shape in zip(params, shapes):
        if (tuple(p.shape) != shape or p.dtype != torch.float32 or p.device != x.device
                or not p.is_contiguous()):
            return (f"parameters must be contiguous float32 on {x.device}: {shape} got "
                    f"{p.dtype} {tuple(p.shape)} on {p.device}")
    if skip is not None and skip.device != x.device:
        return f"the skip must be on {x.device}, got {skip.device}"
    th, tw = target
    if th <= 0 or tw <= 0:
        return f"the target plane must not be empty, got {target}"
    if max(_largest_offset(t) for t in (x, skip) if t is not None) >= 2**31:
        return "element offsets within a channel must be under 2**31"
    if torch.is_grad_enabled() and any(p.requires_grad for p in (x, skip, *params)
                                       if p is not None):
        return "the kernel has no backward: run it under torch.no_grad()"
    if x.device.type != "cuda":
        return f"the kernel runs on CUDA only, got {x.device}: run blob_up_plain"
    return None


def blob_up(x: torch.Tensor, skip, convt, bn, head, target) -> torch.Tensor:
    """The block in eval mode on CUDA: x (B, C1, h, w) float32 in any
    strides, `skip` (B, C2, h, w) or None, `target` (th, tw) -> (B, Cout,
    th, tw) contiguous float32 after `bn`, or with `head` (the last block)
    the (B, th, tw) probabilities. Raises ValueError on what it does not
    take (`_refusal`).

    Launches the kernel once on the current stream and counts the launch
    in `blob_up.launches`; raises if the kernel cannot build or launch."""
    why = _refusal(x, skip, convt, bn, head, target)
    if why is not None:
        raise ValueError(why)
    b, c1, h, w = x.shape
    th, tw = target
    cout = convt.out_channels
    shape = (b, th, tw) if head is not None else (b, cout, th, tw)
    out = torch.empty(shape, dtype=torch.float32, device=x.device)
    if bn is not None:
        bn_ptrs, eps, head_ptrs = [p.data_ptr() for p in _bn_tensors(bn)], float(bn.eps), [0, 0]
    else:
        bn_ptrs, eps, head_ptrs = [0] * 4, 0.0, [head.weight.data_ptr(), head.bias.data_ptr()]
    s = (0, 0, 0, 0) if skip is None else skip.stride()
    args = _Args(
        x.data_ptr(), (ctypes.c_longlong * 4)(*x.stride()),
        0 if skip is None else skip.data_ptr(), (ctypes.c_longlong * 4)(*s),
        b, c1, 0 if skip is None else skip.shape[1], h, w,
        packed_weight(convt).data_ptr(), convt.bias.data_ptr(), cout, *bn_ptrs, eps, *head_ptrs,
        th, tw, crop_offset(2 * h + 2, th), crop_offset(2 * w + 2, tw), out.data_ptr(),
    )
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = _lib().cova_blob_up(ctypes.byref(args), stream)
    if rc != 0:
        raise RuntimeError(f"blob_up launch failed: cudaError {rc}")
    blob_up.launches += 1
    return out


blob_up.launches = 0

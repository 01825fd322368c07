"""MOG2 background subtraction over a chunk of frames: the CUDA kernel's
wrapper and its plain PyTorch version.

`mog2_chunk(frames, weight, mean, var, ...)` runs the per-pixel
Gaussian-mixture recurrence (Zivkovic 2004, as
cova_tpu/utils/mog.py::_mog2_step) over a (F, H, W) uint8 luma chunk,
updating the (H, W, K) float32 mixture state in place, and returns the
(F, H, W) bool foreground. A CUDA tensor goes to the hand-written kernel
(csrc/mog2_kernel.cu); a CPU tensor goes to `mog2_chunk_plain`, the plain
step frame by frame. There is no fallback between the two.

The kernel keeps one thread per pixel with its K = 4 components in
registers for the whole chunk, and does of the plain step only the work
whose result is read: the distance keys d2 / var only where two or more
components match (with one match the owner is that component), one rho
(the owner's), the weakest component only where nothing matched, and the
ranking only where the owner holds neither more than 1 - bg_ratio + 0.02
of the weights (background whatever the order) nor, as the lightest
component, less than (1 - bg_ratio - 0.02) / 4 (foreground whatever the
order). Its divisions are the sequence nvcc's own division runs for
operands far from the exponent range's ends, without the range check,
the four weights sharing one reciprocal of their sum; `mog2_div_pairs`
holds that sequence against `__fdiv_rn` on the card.

Both compute in the same order with one rounding per operation (no fused
multiply-add but inside a division), so the kernel equals the plain
version bit for bit, state included: the mixture weights are summed and
accumulated left to right, ties rank as in a stable descending sort (to
the lower index), and argmins pick the lowest index. rho =
alpha / max(w, eps) divides a tensor by a tensor (torch turns a Python
scalar over a tensor into a reciprocal times the scalar, one ulp away).

The contract for a state handed in from outside: finite values, weights
that are not negative (the verdict's short cuts and the cheaper ranking
rest on a running sum that never falls). Nothing else is asked of it:
variances outside [var_min, var_max], weights that do not sum to 1 and
constants out of the ordinary are taken as the plain version takes them
(a chunk's first frame, and any operand outside the short division's
proven range, goes through `__fdiv_rn`).
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from cova_tpu_torch.ops.cuda import _build

# Components a pixel the kernel holds in registers.
KERNEL_K = 4
# Floor of a variance or weight under a division (cova_tpu/utils/mog.py).
EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class Mog2Params:
    """The recurrence's constants (cova_tpu/utils/mog.py defaults: the
    reference's cv2 MOG2(history=9000, varThreshold=32), no shadows)."""

    k: int = 4
    history: int = 9000
    var_threshold: float = 32.0
    bg_ratio: float = 0.9
    var_init: float = 15.0
    var_min: float = 4.0
    var_max: float = 75.0

    def floats(self) -> tuple:
        """(alpha, var_threshold, bg_ratio, var_init, var_min, var_max,
        eps) rounded to float32, as both versions use them."""
        vals = (1.0 / self.history, self.var_threshold, self.bg_ratio, self.var_init,
                self.var_min, self.var_max, EPS)
        return tuple(float(np.float32(v)) for v in vals)


def mog2_init(frame: torch.Tensor, params: Mog2Params = Mog2Params()):
    """Initial (weight, mean, var), each (H, W, K) float32 on the frame's
    device: weights 1/K, every mean the frame's luma, variances var_init."""
    h, w = frame.shape
    k = params.k
    dev = frame.device
    weight = torch.full((h, w, k), 1.0 / k, dtype=torch.float32, device=dev)
    mean = frame.to(torch.float32)[..., None].expand(h, w, k).contiguous()
    var = torch.full((h, w, k), params.var_init, dtype=torch.float32, device=dev)
    return weight, mean, var


def _argmin_first(x: torch.Tensor) -> torch.Tensor:
    """Index of the smallest value over the last axis, the lowest index
    on ties, by a left-to-right scan."""
    best = x[..., 0]
    idx = torch.zeros(best.shape, dtype=torch.int64, device=x.device)
    for j in range(1, x.shape[-1]):
        better = x[..., j] < best
        idx = torch.where(better, j, idx)
        best = torch.where(better, x[..., j], best)
    return idx


def _sum_left(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis as ((x0 + x1) + x2) + ..."""
    s = x[..., 0]
    for j in range(1, x.shape[-1]):
        s = s + x[..., j]
    return s


def mog2_step_plain(state, x: torch.Tensor, params: Mog2Params = Mog2Params()):
    """One frame of MOG2: state (weight, mean, var) (H, W, K) float32, x
    (H, W) uint8. Returns ((weight, mean, var), fg (H, W) bool); the
    operations of cova_tpu/utils/mog.py::_mog2_step in the kernel's
    order."""
    weight, mean, var = state
    k = weight.shape[-1]
    alpha, var_threshold, bg_ratio, var_init, var_min, var_max, eps = params.floats()
    kk = torch.arange(k, device=x.device)
    xf = x.to(torch.float32)[..., None]
    d = xf - mean
    d2 = d * d
    match = d2 < var_threshold * var
    inf = torch.full((), float("inf"), dtype=torch.float32, device=x.device)
    dist_key = torch.where(match, d2 / torch.clamp(var, min=eps), inf)
    owner = _argmin_first(dist_key)
    any_match = match.any(dim=-1)
    onehot = ((kk == owner[..., None]) & any_match[..., None]).to(torch.float32)

    weight = weight + alpha * (onehot - weight)
    alpha_t = torch.full((), alpha, dtype=torch.float32, device=x.device)
    rho = alpha_t / torch.clamp(weight, min=eps)
    mean = mean + onehot * rho * (xf - mean)
    var = var + onehot * rho * (d2 - var)
    var = torch.clamp(var, var_min, var_max)

    weakest = _argmin_first(weight)
    repl = (kk == weakest[..., None]) & ~any_match[..., None]
    weight = torch.where(repl, alpha_t, weight)
    mean = torch.where(repl, xf, mean)
    var = torch.where(repl, torch.full((), var_init, device=x.device), var)
    weight = weight / _sum_left(weight)[..., None]

    # Rank of each component in a stable descending sort of the weights.
    wi, wj = weight[..., :, None], weight[..., None, :]
    before = (wj > wi) | ((wj == wi) & (kk[None, :] < kk[:, None]))
    rank = before.sum(dim=-1)
    w_sorted = torch.zeros_like(weight).scatter_(-1, rank, weight)
    cum = w_sorted[..., 0]
    n_bg = (cum < bg_ratio).to(torch.int64)
    for r in range(1, k):
        cum = cum + w_sorted[..., r]
        n_bg = n_bg + (cum < bg_ratio).to(torch.int64)
    n_bg = n_bg + 1
    owner_rank = torch.gather(rank, -1, owner[..., None])[..., 0]
    fg = ~any_match | (owner_rank >= n_bg)
    return (weight, mean, var), fg


def mog2_chunk_plain(frames, weight, mean, var, params: Mog2Params = Mog2Params()):
    """The plain version of the kernel on any device: `mog2_step_plain`
    frame by frame, the state written back into weight/mean/var."""
    state = (weight, mean, var)
    fg = torch.empty(frames.shape, dtype=torch.bool, device=frames.device)
    for i in range(frames.shape[0]):
        state, fg[i] = mog2_step_plain(state, frames[i], params)
    for dst, src in zip((weight, mean, var), state):
        dst.copy_(src)
    return fg


def _lib() -> ctypes.CDLL:
    lib = _build.load("mog2_kernel")
    lib.cova_mog2_chunk.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, *[ctypes.c_float] * 7,
        ctypes.c_void_p,
    ]
    lib.cova_mog2_chunk.restype = ctypes.c_int
    lib.cova_mog2_div_pairs.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_void_p,
    ]
    lib.cova_mog2_div_pairs.restype = ctypes.c_int
    return lib


def mog2_chunk(frames: torch.Tensor, weight: torch.Tensor, mean: torch.Tensor,
               var: torch.Tensor, params: Mog2Params = Mog2Params()) -> torch.Tensor:
    """MOG2 over frames (F, H, W) uint8 with the state weight/mean/var
    (H, W, K) float32, updated in place; returns (F, H, W) bool
    foreground. The state must be finite with weights that are not
    negative.

    On CUDA this launches the kernel on the current stream and counts the
    launch in `mog2_chunk.launches`; it raises if the kernel cannot build
    or launch. On the CPU it runs `mog2_chunk_plain`."""
    if frames.dim() != 3 or frames.dtype != torch.uint8:
        raise TypeError(f"frames must be (F, H, W) uint8, got {frames.dtype} "
                        f"{tuple(frames.shape)}")
    f, h, w = frames.shape
    for name, t in (("weight", weight), ("mean", mean), ("var", var)):
        if t.dtype != torch.float32 or t.dim() != 3 or tuple(t.shape[:2]) != (h, w):
            raise ValueError(f"{name} must be ({h}, {w}, K) float32, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if t.shape != weight.shape or t.device != frames.device:
            raise ValueError("weight, mean and var must share a shape and the frames' device")
    if params.k != weight.shape[-1]:
        raise ValueError(f"state has {weight.shape[-1]} components, params.k is {params.k}")
    if frames.device.type == "cpu":
        return mog2_chunk_plain(frames, weight, mean, var, params)
    if frames.device.type != "cuda":
        raise ValueError(f"unsupported device {frames.device}")
    if params.k != KERNEL_K:
        raise ValueError(f"the kernel holds K = {KERNEL_K} components, not {params.k}")
    if not all(t.is_contiguous() for t in (frames, weight, mean, var)):
        raise ValueError("frames and state must be contiguous")
    fg = torch.empty((f, h, w), dtype=torch.bool, device=frames.device)
    if f == 0 or h * w == 0:
        return fg
    stream = torch.cuda.current_stream(frames.device).cuda_stream
    with torch.cuda.device(frames.device):
        rc = _lib().cova_mog2_chunk(
            frames.data_ptr(), weight.data_ptr(), mean.data_ptr(), var.data_ptr(),
            fg.data_ptr(), f, h * w, *params.floats(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"mog2_kernel launch failed: cudaError {rc}")
    mog2_chunk.launches += 1
    return fg


mog2_chunk.launches = 0


def mog2_div_pairs(a: torch.Tensor, b: torch.Tensor):
    """The kernel's short division beside the card's IEEE division: for
    float32 CUDA tensors a, b of one shape returns (a / b by the kernel's
    routine, a / b by `__fdiv_rn`). The kernel relies on the two being
    equal for a divisor in [2**-30, 2**30] and a dividend that is 0 or in
    [2**-60, 2**60]. A check of the card, with no plain version: it raises
    on CPU tensors."""
    for t in (a, b):
        if t.device.type != "cuda" or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("mog2_div_pairs takes contiguous float32 CUDA tensors")
    if a.shape != b.shape or a.device != b.device:
        raise ValueError("a and b must share a shape and a device")
    quick, ieee = torch.empty_like(a), torch.empty_like(a)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    with torch.cuda.device(a.device):
        rc = _lib().cova_mog2_div_pairs(a.data_ptr(), b.data_ptr(), quick.data_ptr(),
                                        ieee.data_ptr(), a.numel(), stream)
    if rc != 0:
        raise RuntimeError(f"mog2_kernel division check failed to launch: cudaError {rc}")
    return quick, ieee

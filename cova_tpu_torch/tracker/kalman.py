"""Constant-velocity Kalman filter for SORT, batched over leading dims
(PyTorch port of cova_tpu/tracker/kalman.py).

State x = [u, v, s, r, u', v', s'] — box center, scale (area), aspect
ratio and their velocities (aspect ratio has no velocity):

  F = I7 with F[0,4] = F[1,5] = F[2,6] = 1 (dt = 1 frame)
  Q = diag(1, 1, 1, 1, .01, .01, .0001)
  H = [I4 | 0]
  R = diag(1, 1, 10, 10)
  P0 = diag(10, 10, 10, 10, 1e4, 1e4, 1e4)

The update uses the Joseph-form covariance. Both steps are written as
elementwise operations in a stated order (no `@`, no matrix inverse), so
they give the same bits on the CPU and on the card, where the CUDA SORT
kernel (csrc/sort_kernel.cu) repeats them operation for operation.
"""

from __future__ import annotations

import numpy as np
import torch

# The diagonals of Q and R; F and H enter only through their sparsity.
_Q_DIAG = np.array([1, 1, 1, 1, 0.01, 0.01, 0.0001], np.float32)
_R_DIAG = np.array([1, 1, 10, 10], np.float32)
_P0 = np.diag(np.array([10, 10, 10, 10, 1e4, 1e4, 1e4], np.float32))


def _const(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a, dtype=like.dtype, device=like.device)


def bbox_to_z(ltwh: torch.Tensor) -> torch.Tensor:
    """(..., 4) ltwh -> (..., 4) measurement [cx, cy, area, aspect]."""
    l, t, w, h = (ltwh[..., i] for i in range(4))
    return torch.stack(
        [l + w / 2.0, t + h / 2.0, w * h, w / torch.clamp(h, min=1e-12)], dim=-1
    )


def _sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root, on any device: the
    float64 root rounded to float32 (double rounding is harmless for a
    square root, 53 >= 2 * 24 + 2 bits). Torch's vectorised float32 sqrt on
    the CPU is not correctly rounded (an ulp off for about 0.6 % of
    values on AVX-512), while XLA's, CUDA's sqrtf and the SORT kernel's
    __fsqrt_rn are."""
    return torch.sqrt(x.to(torch.float64)).to(x.dtype)


def x_to_bbox(x: torch.Tensor, reproduce_quirk: bool = True) -> torch.Tensor:
    """(..., 7) state -> (..., 4) ltwh.

    reproduce_quirk=True replicates the reference's `from_x`, which uses
    width/2 for the vertical center offset; False computes the
    geometrically correct top."""
    s = torch.clamp(x[..., 2], min=1e-12)
    r = torch.clamp(x[..., 3], min=1e-12)
    w = _sqrt_rn(s * r)
    h = s / torch.clamp(w, min=1e-12)
    cx, cy = x[..., 0], x[..., 1]
    top_off = w / 2.0 if reproduce_quirk else h / 2.0
    return torch.stack([cx - w / 2.0, cy - top_off, w, h], dim=-1)


def kalman_init(z: torch.Tensor):
    """Init (mean, cov) from a measurement. Leading dims broadcast."""
    mean = torch.cat([z, z.new_zeros(z.shape[:-1] + (3,))], dim=-1)
    cov = _const(_P0, z).expand(z.shape[:-1] + (7, 7))
    return mean, cov


def kalman_predict(mean: torch.Tensor, cov: torch.Tensor):
    """Predict step with the reference's scale-velocity clamp: if
    s + s' <= 0, zero s' before the transition.

    F·x, F·P·Fᵀ by the sparsity of F (row i < 3 of F·P is P[i] + P[i+4],
    then column j < 3 likewise), then Q added on the diagonal: each
    entry one rounded addition, the same on any device, and equal to the
    dense products (every other term is an exact zero)."""
    m6 = torch.where(mean[..., 6] + mean[..., 2] <= 0.0, 0.0, mean[..., 6])
    vel = torch.stack([mean[..., 4], mean[..., 5], m6], dim=-1)
    mean_p = torch.cat([mean[..., :3] + vel, mean[..., 3:6], m6[..., None]], dim=-1)
    fp = torch.cat([cov[..., :3, :] + cov[..., 4:, :], cov[..., 3:, :]], dim=-2)
    cov_p = torch.cat([fp[..., :, :3] + fp[..., :, 4:], fp[..., :, 3:]], dim=-1)
    cov_p.diagonal(dim1=-2, dim2=-1).add_(_const(_Q_DIAG, cov))
    return mean_p, cov_p


def _matmul_ordered(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b over the last two axes, each entry summed over k in
    ascending order, ((a0 b0 + a1 b1) + a2 b2) + ..., every product and
    sum rounded on its own (no fused multiply-add, no blocking)."""
    out = a[..., :, :1] * b[..., :1, :]
    for k in range(1, a.shape[-1]):
        out = out + a[..., :, k : k + 1] * b[..., k : k + 1, :]
    return out


def _inverse(s: torch.Tensor) -> torch.Tensor:
    """S⁻¹ of (..., N, N) matrices by Gaussian elimination without
    pivoting on [S | I], then back substitution, in the loop order written
    here (row r's multiplier m[r][p] / m[p][p], columns ascending; back
    substitution over ascending columns). Unpivoted elimination is stable
    for SORT's innovation covariance S = H·P·Hᵀ + R, symmetric positive
    definite with R >= 1 on its diagonal; S is even diagonal there (F, Q,
    H and R never couple two coordinates), and then every multiplier is
    0 and S⁻¹ holds the correctly rounded 1 / S[a][a]."""
    n = s.shape[-1]
    m = [[s[..., r, c] for c in range(n)] for r in range(n)]
    eye = torch.eye(n, dtype=s.dtype, device=s.device)
    rhs = [eye[r].expand(s.shape[:-1]) for r in range(n)]
    for p in range(n):
        for r in range(p + 1, n):
            f = m[r][p] / m[p][p]
            for c in range(p + 1, n):
                m[r][c] = m[r][c] - f * m[p][c]
            rhs[r] = rhs[r] - f[..., None] * rhs[p]
    x = [None] * n
    for r in reversed(range(n)):
        acc = rhs[r]
        for c in range(r + 1, n):
            acc = acc - m[r][c][..., None] * x[c]
        x[r] = acc / m[r][r][..., None]
    return torch.stack(x, dim=-2)


def kalman_update(mean: torch.Tensor, cov: torch.Tensor, z: torch.Tensor):
    """Joseph-form measurement update, in a fixed order:

      y = z - H·x;  S = H·P·Hᵀ + R (R on the diagonal);  K = (P·Hᵀ)·S⁻¹
      x' = x + K·y (summed over the 4 measurement axes in order)
      P' = (I - K·H)·P·(I - K·H)ᵀ + (K·R)·Kᵀ

    with every product by `_matmul_ordered` (the 7-term ones over all
    seven axes, zeros of I - K·H included), K·R as K scaled by R's
    diagonal, and S⁻¹ by `_inverse`. No `@` and no library inverse: the
    result is the same on the CPU and on the card, and the CUDA SORT
    kernel (csrc/sort_kernel.cu) computes it in the same order."""
    r_diag = _const(_R_DIAG, mean)
    y = z - mean[..., :4]
    s = cov[..., :4, :4].clone()
    s.diagonal(dim1=-2, dim2=-1).add_(r_diag)
    k = _matmul_ordered(cov[..., :, :4], _inverse(s))  # (..., 7, 4)
    ky = k[..., 0] * y[..., None, 0]
    for a in range(1, 4):
        ky = ky + k[..., a] * y[..., None, a]
    mean_u = mean + ky
    kh = torch.cat([k, k.new_zeros(k.shape[:-1] + (3,))], dim=-1)
    ikh = torch.eye(7, dtype=cov.dtype, device=cov.device) - kh
    joseph = _matmul_ordered(_matmul_ordered(ikh, cov), ikh.transpose(-1, -2))
    cov_u = joseph + _matmul_ordered(k * r_diag[..., None, :], k.transpose(-1, -2))
    return mean_u, cov_u

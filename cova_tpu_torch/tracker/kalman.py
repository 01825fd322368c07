"""Constant-velocity Kalman filter for SORT, batched over leading dims
(PyTorch port of cova_tpu/tracker/kalman.py).

State x = [u, v, s, r, u', v', s'] — box center, scale (area), aspect
ratio and their velocities (aspect ratio has no velocity):

  F = I7 with F[0,4] = F[1,5] = F[2,6] = 1 (dt = 1 frame)
  Q = diag(1, 1, 1, 1, .01, .01, .0001)
  H = [I4 | 0]
  R = diag(1, 1, 10, 10)
  P0 = diag(10, 10, 10, 10, 1e4, 1e4, 1e4)

The update uses the Joseph-form covariance.
"""

from __future__ import annotations

import numpy as np
import torch

_F = np.eye(7, dtype=np.float32)
_F[0, 4] = _F[1, 5] = _F[2, 6] = 1.0
_Q = np.diag(np.array([1, 1, 1, 1, 0.01, 0.01, 0.0001], np.float32))
_H = np.zeros((4, 7), np.float32)
_H[:4, :4] = np.eye(4)
_R = np.diag(np.array([1, 1, 10, 10], np.float32))
_P0 = np.diag(np.array([10, 10, 10, 10, 1e4, 1e4, 1e4], np.float32))


def _const(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a, dtype=like.dtype, device=like.device)


def bbox_to_z(ltwh: torch.Tensor) -> torch.Tensor:
    """(..., 4) ltwh -> (..., 4) measurement [cx, cy, area, aspect]."""
    l, t, w, h = (ltwh[..., i] for i in range(4))
    return torch.stack(
        [l + w / 2.0, t + h / 2.0, w * h, w / torch.clamp(h, min=1e-12)], dim=-1
    )


def x_to_bbox(x: torch.Tensor, reproduce_quirk: bool = True) -> torch.Tensor:
    """(..., 7) state -> (..., 4) ltwh.

    reproduce_quirk=True replicates the reference's `from_x`, which uses
    width/2 for the vertical center offset; False computes the
    geometrically correct top."""
    s = torch.clamp(x[..., 2], min=1e-12)
    r = torch.clamp(x[..., 3], min=1e-12)
    w = torch.sqrt(s * r)
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
    s + s' <= 0, zero s' before the transition."""
    vs = torch.where(mean[..., 6] + mean[..., 2] <= 0.0, 0.0, mean[..., 6])
    mean = torch.cat([mean[..., :6], vs[..., None]], dim=-1)
    f = _const(_F, mean)
    mean_p = mean @ f.T
    cov_p = f @ cov @ f.T + _const(_Q, cov)
    return mean_p, cov_p


def kalman_update(mean: torch.Tensor, cov: torch.Tensor, z: torch.Tensor):
    """Joseph-form measurement update."""
    h = _const(_H, mean)
    r = _const(_R, mean)
    y = z - mean @ h.T  # innovation (..., 4)
    s = h @ cov @ h.T + r  # (..., 4, 4)
    k = cov @ h.T @ torch.linalg.inv(s)  # (..., 7, 4)
    mean_u = mean + (k @ y[..., None])[..., 0]
    ikh = torch.eye(7, dtype=cov.dtype, device=cov.device) - k @ h
    cov_u = ikh @ cov @ ikh.transpose(-1, -2) + k @ r @ k.transpose(-1, -2)
    return mean_u, cov_u

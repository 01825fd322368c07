"""Core tensor types for the compressed-domain pipeline (PyTorch port of
cova_tpu/types.py).

Variable-length box lists are fixed-capacity struct-of-arrays with a
validity mask, so every tensor of a chunk has a static shape.

Geometry convention: ``(left, top, width, height)`` in whatever unit the
stage runs at (macroblock units for the compressed stage — the 80x45 grid
for 1280x720 video — pixels after the x16 upscale in the aggregator).
"""

from __future__ import annotations

import dataclasses

import torch

# Fixed capacities, as in the JAX package.
MAX_BOXES_PER_FRAME = 32  # CC components surviving the area threshold
MAX_TRACKS = 64  # concurrent SORT track slots per stream

# Sentinel for invalid / padded entries.
INVALID_ID = -1


@dataclasses.dataclass
class Boxes:
    """A fixed-capacity batch of boxes (struct-of-arrays).

    All fields share leading dims ``(...)`` and a capacity axis ``K``:
      ltwh:  (..., K, 4) float32 — left, top, width, height
      valid: (..., K)    bool
      area:  (..., K)    float32 — box w*h
      class_id: (..., K) int32
      conf:  (..., K)    float32
      track_id: (..., K) int32 (INVALID_ID if unassigned)
    """

    ltwh: torch.Tensor
    valid: torch.Tensor
    area: torch.Tensor
    class_id: torch.Tensor
    conf: torch.Tensor
    track_id: torch.Tensor

    def map(self, fn) -> "Boxes":
        """Apply `fn` to every field (the tree_map of the JAX version)."""
        return Boxes(
            **{f.name: fn(getattr(self, f.name)) for f in dataclasses.fields(self)}
        )


@dataclasses.dataclass
class TrackRecord:
    """Host-side record of a finished track.

    history: list of (timestamp_seconds, ltwh-in-MB-units) samples.
    """

    track_id: int
    start_ts: float
    end_ts: float
    seen: bool
    history: list  # [(ts, (l, t, w, h)), ...]


@dataclasses.dataclass
class Detection:
    """Host-side oracle detection."""

    ts: float
    left: float
    top: float
    width: float
    height: float
    class_id: int
    conf: float = 0.0

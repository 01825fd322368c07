"""Canonical digests of what a job hands between layers, so that a run's
answers can be held to the expected ones byte for byte."""

from __future__ import annotations

import hashlib

import numpy as np


def sha(data: bytes, n: int = 32) -> str:
    return hashlib.sha256(data).hexdigest()[:n]


def picture(y, u, v) -> str:
    """One decoded picture: the digest of its three planes' sha256s."""
    hy, hu, hv = (hashlib.sha256(np.ascontiguousarray(p).tobytes()).hexdigest()
                  for p in (y, u, v))
    return sha((hy + hu + hv).encode())


def track_calls(calls) -> str:
    """The aggregator's submit_track calls of a job, in order:
    (range_start, oldest, record) with the record's id, start, end, seen
    flag and history of (ts, (l, t, w, h))."""
    h = hashlib.sha256()
    for range_start, oldest, rec in calls:
        parts = [repr(float(range_start)), repr(float(oldest)), str(int(rec.track_id)),
                 repr(float(rec.start_ts)), repr(float(rec.end_ts)), str(bool(rec.seen))]
        for ts, box in rec.history:
            parts.append(repr(float(ts)))
            parts.extend(repr(float(x)) for x in box)
        h.update((",".join(parts) + "\n").encode())
    return h.hexdigest()[:32]

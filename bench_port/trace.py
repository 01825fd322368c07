"""Reduction of a torch.profiler Chrome trace to what the per-layer
metrics read: the device's activity (kernels, copies, sets), the host
ranges the harness marks with record_function, and the launches that
tie a kernel to the range that issued it."""

from __future__ import annotations

import dataclasses
import json

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclasses.dataclass
class Trace:
    device: list  # (start_us, end_us, name, correlation)
    ranges: list  # (start_us, end_us, name, tid) of the harness's ranges
    launches: dict  # correlation -> (ts_us, tid)

    @classmethod
    def load(cls, path, prefix: str = "bench.") -> "Trace":
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        device, ranges, launches = [], [], {}
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
            corr = (e.get("args") or {}).get("correlation")
            if cat in DEVICE_CATS:
                device.append((ts, ts + dur, e["name"], corr))
            elif cat == "cuda_runtime" and corr is not None:
                launches[corr] = (ts, e.get("tid"))
            elif cat == "user_annotation" and e["name"].startswith(prefix):
                ranges.append((ts, ts + dur, e["name"], e.get("tid")))
        device.sort()
        return cls(device, ranges, launches)

    def busy_us(self) -> float:
        """Length of the union of the device's activity."""
        total, end = 0.0, None
        for s, e, _, _ in self.device:
            if end is None or s > end:
                total += e - s
                end = e
            elif e > end:
                total += e - end
                end = e
        return total

    def kernel_us(self, names) -> float:
        """Device time of the operations whose name holds one of `names`."""
        return sum(e - s for s, e, n, _ in self.device if any(k in n for k in names))

    def by_name(self) -> list:
        sums: dict = {}
        for s, e, n, _ in self.device:
            sums[n] = sums.get(n, 0.0) + (e - s)
        return sorted(sums.items(), key=lambda kv: -kv[1])

    def issued_in(self, range_name: str) -> float:
        """Device time of the operations launched inside the named host
        ranges (by the launch's time and thread)."""
        spans = [(s, e, tid) for s, e, n, tid in self.ranges if n == range_name]
        total = 0.0
        for s, e, _, corr in self.device:
            hit = self.launches.get(corr)
            if hit is None:
                continue
            ts, tid = hit
            if any(a <= ts <= b and t == tid for a, b, t in spans):
                total += e - s
        return total

    def gaps(self, lo: float, hi: float) -> list:
        """(start, end) of the device's idle stretches inside [lo, hi]."""
        out, cur = [], lo
        for s, e, _, _ in self.device:
            if e <= cur:
                continue
            if s > cur:
                out.append((cur, min(s, hi)))
            cur = max(cur, e)
            if cur >= hi:
                break
        if cur < hi:
            out.append((cur, hi))
        return [(a, b) for a, b in out if b > a]

    def host_at(self, t: float) -> str:
        """The innermost harness range open at time t, on any thread."""
        best = None
        for s, e, n, _ in self.ranges:
            if s <= t <= e and (best is None or e - s < best[1] - best[0]):
                best = (s, e, n)
        return best[2] if best else "host: outside the marked ranges"

"""Device time launched from one thread inside a window of host time.

torch.profiler records CPU operations, and with them the harness's
record_function ranges, only on the thread that started it; launches from
any other thread it still records, under the low 32 bits of the thread's
pthread id read as a signed 32-bit number and written without its sign
(so 2**32 less those bits where the top one is set), or under its native
id where it saw that thread run an operation.
CovaPipeline calls the oracle from its pixel stage's threads, so a range
around the oracle is not in the trace. An oracle module that keeps, a
call, the calling thread's ids and the call's start and end in Unix ns
(as oracles/rtdetr.py's `take()` does under "windows") has the device
time of what the call launched read here: the operations whose launch
came from that thread between start and end, on the trace's timeline
(Unix ns = baseTimeNanoseconds + 1000 * ts).
"""

from __future__ import annotations

import bisect
import pathlib
import re

EDGE_BYTES = 1 << 16


def base_ns(run) -> int | None:
    """baseTimeNanoseconds of the run's Chrome trace (run.py writes it to
    the cell's temporary directory; the key lies in the file's head or
    tail, outside the events)."""
    path = pathlib.Path(run["cell"].tmp) / "trace.json"
    if not path.is_file():
        return None
    size = path.stat().st_size
    with open(path, "rb") as f:
        for at in (0, max(0, size - EDGE_BYTES)):
            f.seek(at)
            found = re.search(rb'"baseTimeNanoseconds"\s*:\s*(\d+)', f.read(EDGE_BYTES))
            if found:
                return int(found.group(1))
    return None


def windows(run, part: str) -> list:
    """(native id, pthread low bits, start ns, end ns) of each window
    named `part` that the run's oracle frames kept."""
    return [w[1:] for job in run["jobs"] for frame in job.frames
            if isinstance(frame[5], dict) for w in frame[5].get("windows", ()) if w[0] == part]


def issued_in(run, part: str) -> float | None:
    """Microseconds of device time of the operations launched inside the
    windows named `part`, by the launching thread and the launch's time;
    None without a trace, windows or its base time."""
    tr = run["trace"]
    spans = windows(run, part)
    if tr is None or not spans or run.get("cell") is None:
        return None
    base = base_ns(run)
    if base is None:
        return None
    by_tid: dict = {}
    for native, low, start, end in spans:
        for tid in {native, low, (1 << 32) - low}:
            by_tid.setdefault(tid, []).append(((start - base) / 1e3, (end - base) / 1e3))
    for w in by_tid.values():
        w.sort()
    total = 0.0
    for s, e, _, corr in tr.device:
        hit = tr.launches.get(corr)
        if hit is None or hit[1] not in by_tid:
            continue
        w = by_tid[hit[1]]
        i = bisect.bisect_right(w, (hit[0], float("inf"))) - 1
        if i >= 0 and w[i][0] <= hit[0] <= w[i][1]:
            total += e - s
    return total

"""The port's tracer: spans and counters at the pipeline's stage
boundaries, on the clock of torch.profiler's Chrome trace.

Off by default. `enable()` / `disable()` switch it; `take()` returns what
it recorded and clears it. Off, `span(...)` returns a shared no-op context
and `count(...)` returns at once. On, each span is kept in memory with its
name, id, parent (the innermost span open on the calling thread, or the
one passed as `parent=`, for work handed to another thread), run id (one
per root span: `CovaPipeline.run()` opens one, and the spans of one job
share it), the OS thread id (`threading.get_native_id()`, the `tid` the
profiler writes for a thread it has seen run CPU ops) and the thread's
pthread id (`threading.get_ident()`, whose low 32 bits are the `tid` it
writes on a launch from any other thread; `profiler_tid` picks the one a
trace uses), start and end, and the calling thread's CPU ns; spans
opened with `process=True` also keep the process's CPU ns. Counters are
summed per run under a name.

Start and end are `time.perf_counter_ns()` plus one offset to Unix ns,
taken at `enable()`. torch.profiler's Chrome trace places an event at
`baseTimeNanoseconds + 1000 * ts` Unix ns, so `chrome_events` puts the
program's spans on the timeline of the card's kernels, copies and
launches.

`timed(...)` is a span that reads the clock whether tracing is on or off:
the pipeline's `StageTimers` add up its `seconds`, so a timer and the
spans that bound it are the same clock reads.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time

_on = False
_offset_ns = 0
_lock = threading.Lock()
_ids = itertools.count(1)
_spans: list = []
_counters: dict = {}  # run id -> {name: total}
_local = threading.local()


def enable() -> None:
    """Record spans and counters from now on."""
    global _on, _offset_ns
    _offset_ns = time.time_ns() - time.perf_counter_ns()
    _on = True


def disable() -> None:
    global _on
    _on = False


def enabled() -> bool:
    return _on


def take() -> dict:
    """What was recorded since the last take, and clear it:
    {"spans": [record, ...], "counters": {run id: {name: total}}}. A
    record is a dict: name, id, parent, run, tid, ident, start, end (Unix ns),
    cpu (the thread's CPU ns), and proc (the process's CPU ns) and attrs
    where the span has them."""
    global _spans, _counters
    with _lock:
        out = {"spans": _spans, "counters": _counters}
        _spans, _counters = [], {}
    return out


def _stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


_NOOP = _Noop()


class _Span:
    __slots__ = ("name", "attrs", "parent", "root", "process", "rec", "id", "run", "start",
                 "end", "cpu0", "proc0")

    def __init__(self, name, rec, parent=None, root=False, process=False):
        self.name, self.rec, self.parent, self.root = name, rec, parent, root
        self.process, self.attrs = process, None
        self.start = self.end = 0

    def set(self, **attrs) -> None:
        """Attach attributes to the span's record."""
        if self.rec:
            self.attrs = {**(self.attrs or {}), **attrs}

    def __enter__(self):
        if self.rec:
            st = _stack()
            if self.parent is None and st:
                self.parent = st[-1]
            self.id = next(_ids)
            self.run = self.id if self.root else getattr(self.parent, "run", None)
            st.append(self)
            self.cpu0 = time.thread_time_ns()
            if self.process:
                self.proc0 = time.process_time_ns()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end = time.perf_counter_ns()
        if self.rec:
            r = {"name": self.name, "id": self.id,
                 "parent": None if self.root or self.parent is None else self.parent.id,
                 "run": self.run, "tid": threading.get_native_id(),
                 "ident": threading.get_ident(),
                 "start": self.start + _offset_ns, "end": self.end + _offset_ns,
                 "cpu": time.thread_time_ns() - self.cpu0}
            if self.process:
                r["proc"] = time.process_time_ns() - self.proc0
            if self.attrs:
                r["attrs"] = self.attrs
            st = _stack()
            if self in st:  # and whatever an exception left open above it
                del st[st.index(self):]
            with _lock:
                _spans.append(r)
        return False

    @property
    def seconds(self) -> float:
        return (self.end - self.start) / 1e9


def span(name: str, parent=None, root: bool = False):
    """A context that records one span while tracing is on; `set(...)`
    attaches attributes. `parent`: the span to hang it under where that
    is not the innermost one open on this thread (work handed to another
    thread); `root`: a new run."""
    if not _on:
        return _NOOP
    if not (isinstance(parent, _Span) and parent.rec):
        parent = None
    return _Span(name, True, parent, root)


def timed(name: str, process: bool = False) -> _Span:
    """A span that reads the clock whether tracing is on or off (its
    `seconds` after the block), and is recorded only while it is on.
    `process`: also record the process's CPU ns."""
    return _Span(name, _on, process=process)


def count(name: str, n: int = 1) -> None:
    """Add n to the counter `name` of the calling thread's run."""
    if not _on:
        return
    st = _stack()
    run = st[-1].run if st else None
    with _lock:
        per = _counters.setdefault(run, {})
        per[name] = per.get(name, 0) + n


def profiler_tid(s: dict, tids) -> int:
    """The `tid` under which a torch.profiler trace holding the thread ids
    `tids` writes the events of span record `s`'s thread: its native id
    where the trace has it, else the low 32 bits of its pthread id (how
    the profiler writes a launch from a thread on which it saw no CPU op)
    where the trace has those, else the native id."""
    if s["tid"] in tids:
        return s["tid"]
    low = s["ident"] & 0xFFFFFFFF
    return low if low in tids else s["tid"]


def chrome_events(record: dict, base_ns: int, tids=frozenset()) -> list:
    """A record of `take()` as Chrome trace events on the timeline of a
    torch.profiler trace whose `baseTimeNanoseconds` is base_ns:
    ts = (unix_ns - base_ns) / 1000, each span on its thread's track of
    that trace (`profiler_tid`; `tids`: the trace's thread ids in this
    process), so a thread's spans sit over the launches it made. Each
    run's counters ride on the arguments of its root span."""
    pid = os.getpid()
    counters = record.get("counters", {})
    out = []
    for s in record["spans"]:
        args = {k: s[k] for k in ("id", "parent", "run", "cpu", "proc") if s.get(k) is not None}
        args.update(s.get("attrs") or {})
        if s["parent"] is None and s["run"] == s["id"] and s["run"] in counters:
            args["counters"] = counters[s["run"]]
        out.append({"ph": "X", "cat": "cova", "name": s["name"], "pid": pid,
                    "tid": profiler_tid(s, tids), "ts": (s["start"] - base_ns) / 1000,
                    "dur": (s["end"] - s["start"]) / 1000, "args": args})
    return out


def export_chrome(prof, record: dict, path) -> None:
    """Write one Chrome trace to `path`: the profiler's events and the
    program's spans (`record`, from take()) on one timeline."""
    path = str(path)
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    pid = os.getpid()
    tids = {e["tid"] for e in doc["traceEvents"] if e.get("pid") == pid and "tid" in e}
    doc["traceEvents"] += chrome_events(record, int(doc["baseTimeNanoseconds"]), tids)
    with open(path, "w") as f:
        json.dump(doc, f)

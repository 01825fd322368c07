"""The port's tracer (cova_tpu_torch/trace.py) on the CPU: nothing is
recorded while it is off; spans nest, across the pixel stage's threads
too, with one run id a `CovaPipeline.run()`; the pipeline's `StageTimers`
are the sums of the spans that bound them, tracing on or off; every span
and counter of the pipeline appears, and the counts repeat; the spans sit
on torch.profiler's timeline; `run_cova --trace` writes one Chrome trace.
"""

import collections
import concurrent.futures
import json
import pathlib
import threading
import time

import pytest
import torch
from torch import nn

from cova_tpu_torch import run_cova, trace
from cova_tpu_torch.config import CompressedStageConfig, CovaConfig, ParallelConfig, SortConfig
from cova_tpu_torch.models.blobnet import load_artifact
from cova_tpu_torch.models.yolov4 import YoloDetector
from cova_tpu_torch.pipeline.cova import CovaPipeline

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
SMALL = REPO / "cova_tpu_torch" / "data" / "synth_small.mp4"
SYNTH = REPO / "artifacts" / "blobnet_synth.npz"
# 60 frames a range: the pixel stage decodes the GoP's first pictures
# and hands two of them to the oracle.
MAX_FRAMES = 60

SPANS = {
    "cova.run", "cova.prepare", "cova.entdec", "cova.entdec.range", "cova.masks",
    "cova.mirror", "cova.mirror.wait", "cova.mirror.cc", "cova.mirror.track", "cova.finish",
    "cova.pixel_stage", "cova.pixdec.prefetch", "cova.pixdec", "cova.pixdec.range",
    "cova.pixdec.syntax", "cova.pixdec.upload", "cova.pixdec.launch", "cova.pixdec.copy_out",
    "cova.oracle.wait", "cova.oracle", "cova.oracle.pre", "cova.oracle.net", "cova.oracle.post",
}
# The CPU run's counters: its BlobNet stages and decoder blocks run the
# plain versions, so `blobnet.stages_fused` (a K4 launch) and
# `blobnet.up_fused` (a K12 launch) never appear.
COUNTERS = {"entdec.frames", "masks.chunks", "pixdec.pictures", "pixdec.uploads",
            "pixdec.upload_bytes", "pixdec.copy_out_bytes", "oracle.frames",
            "oracle.detections", "blobnet.stages", "blobnet.up_blocks"}
# StageTimers field -> the spans whose seconds it sums (pixel_decode is
# the decode's wall less the oracle's).
TIMERS = {"entropy_decode": "cova.entdec", "device_dispatch": "cova.masks",
          "host_mirror": "cova.mirror", "pixel_stage": "cova.pixel_stage",
          "oracle": "cova.oracle"}


@pytest.fixture(autouse=True)
def _tracer_off():
    trace.disable()
    trace.take()
    yield
    trace.disable()
    trace.take()


def _detector():
    """A stub oracle with YoloDetector's stages: the frame resized to 32
    pixels, an identity network, no boxes."""

    def post(x):
        n = x.shape[0]
        return (torch.zeros(n, 0, 4), torch.zeros(n, 0), torch.zeros(n, 0, dtype=torch.int32),
                torch.zeros(n, 0, dtype=torch.bool))

    return YoloDetector(nn.Identity(), post, 32, "cpu")


def _run(tmp_path, name):
    _, sd, meta = load_artifact(SYNTH, "cpu")
    cfg = CovaConfig(
        parallel=ParallelConfig(num_ranges=2), sort=SortConfig(min_hits=3, max_age=10),
        compressed=CompressedStageConfig(
            cc_threshold=2, mask_threshold=0.6,
            use_nnz_channel=bool(meta.get("use_nnz_channel", False)),
            signed_mv=bool(meta.get("signed_mv", False))),
        last="full")
    return CovaPipeline(str(SMALL), str(tmp_path / name), cfg, sd, detector=_detector(),
                        device="cpu", log=lambda *_: None).run(max_frames=MAX_FRAMES)


def _sums(spans, timers_of):
    """Each StageTimers field as the sum of its spans' seconds, in the
    order they closed."""
    by = collections.defaultdict(list)
    for name, seconds in spans:
        by[name].append(seconds)
    out = {field: sum(by[name]) for field, name in timers_of.items()}
    out["pixel_decode"] = sum(by["cova.pixdec"]) - sum(by["cova.oracle"])
    return out


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    trace.disable()
    trace.take()
    trace.enable()
    try:
        res = _run(tmp_path_factory.mktemp("traced"), "on")
    finally:
        trace.disable()
    return res, trace.take()


def test_off_records_nothing():
    assert not trace.enabled()
    with trace.span("a") as sp:
        sp.set(x=1)
        trace.count("c", 3)
    with trace.timed("b") as t:
        time.sleep(0.001)
    assert t.seconds > 0
    assert trace.span("a") is trace.span("b")  # the shared no-op
    assert trace.take() == {"spans": [], "counters": {}}


def test_spans_nest_across_threads_with_one_run_id_a_root():
    trace.enable()
    tids = set()
    for _ in range(2):
        with trace.span("root", root=True) as root:
            root.set(k=1)
            trace.count("n")
            with trace.timed("stage") as stage:
                def work(i):
                    with trace.span("range", parent=stage):
                        with trace.span("leaf"):
                            trace.count("n", i)
                    return threading.get_native_id()

                with concurrent.futures.ThreadPoolExecutor(3) as ex:
                    tids |= set(ex.map(work, range(1, 4)))
    with trace.span("outside"):
        trace.count("n", 10)
    rec = trace.take()
    spans = {s["id"]: s for s in rec["spans"]}
    roots = [s for s in rec["spans"] if s["name"] == "root"]
    assert len(roots) == 2 and roots[0]["run"] != roots[1]["run"]
    assert all(r["parent"] is None and r["run"] == r["id"] and r["attrs"] == {"k": 1}
               for r in roots)
    above = {"root": [], "stage": ["root"], "range": ["stage", "root"],
             "leaf": ["range", "stage", "root"], "outside": []}
    for s in rec["spans"]:
        chain, p = [], s
        while p["parent"] is not None:
            p = spans[p["parent"]]
            chain.append(p["name"])
        assert chain == above[s["name"]], (s["name"], chain)
        assert s["run"] == (None if s["name"] == "outside" else p["run"])
    leaves = [s for s in rec["spans"] if s["name"] == "leaf"]
    assert {s["tid"] for s in leaves} == tids
    assert all(spans[s["parent"]]["tid"] == s["tid"] for s in leaves)
    assert all(spans[s["parent"]]["ident"] == s["ident"] for s in leaves)
    assert all(s["start"] <= s["end"] and s["cpu"] >= 0 for s in rec["spans"])
    # Counters are summed per run; the threads' under their parent's run.
    assert {run: c["n"] for run, c in rec["counters"].items()} == {
        roots[0]["run"]: 7, roots[1]["run"]: 7, None: 10}


def test_pipeline_records_every_span_and_counter(traced):
    res, rec = traced
    names = collections.Counter(s["name"] for s in rec["spans"])
    assert set(names) == SPANS
    assert names["cova.run"] == 1
    run = next(s for s in rec["spans"] if s["name"] == "cova.run")
    assert run["attrs"] == {"frames": res.num_frames, "ranges": 2, "streams": 1}
    assert {s["run"] for s in rec["spans"]} == {run["id"]}
    assert set(rec["counters"]) == {run["id"]}
    counts = rec["counters"][run["id"]]
    assert set(counts) == COUNTERS
    assert counts["entdec.frames"] == res.num_frames
    assert counts["oracle.frames"] == res.pixel_frames == names["cova.oracle"]
    assert counts["oracle.detections"] == 0  # the stub oracle keeps no box
    assert counts["pixdec.pictures"] == names["cova.pixdec.syntax"]
    assert counts["pixdec.pictures"] == res.decoded_dependency + res.decoded_inference
    assert counts["masks.chunks"] == names["cova.masks"]
    assert counts["blobnet.stages"] == 4 * counts["masks.chunks"]
    assert counts["blobnet.up_blocks"] == 4 * counts["masks.chunks"]
    # Syntax.picture's uploads: 11 a picture with nonzero levels, else 9.
    assert 9 * counts["pixdec.pictures"] <= counts["pixdec.uploads"] <= \
        11 * counts["pixdec.pictures"]
    for s in rec["spans"]:
        if s["name"] in ("cova.entdec", "cova.pixel_stage"):
            assert s["proc"] >= 0
        if s["name"] == "cova.entdec.range":
            assert s["attrs"]["frames"] > 0 and s["attrs"]["gops"] == 1


def test_pixel_stage_spans_hang_under_the_stage_across_threads(traced):
    _, rec = traced
    by_id = {s["id"]: s for s in rec["spans"]}

    def parent(s):
        return by_id[s["parent"]]["name"]

    stage = next(s for s in rec["spans"] if s["name"] == "cova.pixel_stage")
    ranges = [s for s in rec["spans"] if s["name"] == "cova.pixdec.range"]
    assert ranges and all(parent(s) == "cova.pixdec" for s in ranges)
    assert all(by_id[r["parent"]]["parent"] == stage["id"] for r in ranges)
    assert all(s["tid"] != stage["tid"] for s in ranges)
    for name, up in (("cova.pixdec.syntax", "cova.pixdec.range"),
                     ("cova.pixdec.upload", "cova.pixdec.range"),
                     ("cova.pixdec.launch", "cova.pixdec.range"),
                     ("cova.oracle.wait", "cova.pixdec.range"),
                     ("cova.oracle", "cova.pixdec.range"),
                     ("cova.oracle.pre", "cova.oracle"), ("cova.oracle.net", "cova.oracle"),
                     ("cova.oracle.post", "cova.oracle"),
                     ("cova.mirror.wait", "cova.mirror"), ("cova.mirror.cc", "cova.mirror"),
                     ("cova.entdec.range", "cova.entdec"), ("cova.prepare", "cova.run")):
        kids = [s for s in rec["spans"] if s["name"] == name]
        assert kids and all(parent(s) == up for s in kids), name
    for s in rec["spans"]:
        if s["parent"] is not None:
            p = by_id[s["parent"]]
            assert p["start"] <= s["start"] <= s["end"] <= p["end"], s["name"]


def test_stage_timers_are_the_sums_of_their_spans_tracing_on(traced):
    res, rec = traced
    spans = [(s["name"], (s["end"] - s["start"]) / 1e9) for s in rec["spans"]]
    want = _sums(spans, TIMERS)
    for field, value in want.items():
        assert getattr(res.timers, field) == value, field


def test_stage_timers_are_the_sums_of_their_spans_tracing_off(tmp_path, monkeypatch):
    made = []
    timed = trace.timed

    def keep(name, *a, **kw):
        made.append(timed(name, *a, **kw))
        return made[-1]

    monkeypatch.setattr(trace, "timed", keep)
    res = _run(tmp_path, "off")
    assert trace.take() == {"spans": [], "counters": {}}
    # Off, a timed span is kept by nobody: the same clock reads feed the
    # timers. Their order of closing is the order of their ends.
    spans = [(s.name, s.seconds) for s in sorted(made, key=lambda s: s.end)]
    assert {n for n, _ in spans} == {"cova.entdec", "cova.masks", "cova.mirror",
                                     "cova.pixel_stage", "cova.pixdec", "cova.oracle"}
    want = _sums(spans, TIMERS)
    for field, value in want.items():
        assert getattr(res.timers, field) == value, field


def test_counts_repeat_between_runs(traced, tmp_path):
    _, first = traced
    trace.enable()
    _run(tmp_path, "again")
    trace.disable()
    second = trace.take()
    (a,), (b,) = first["counters"].values(), second["counters"].values()
    assert a == b
    assert a["pixdec.uploads"] > 0


def test_spans_sit_on_the_profilers_timeline(tmp_path):
    from torch.profiler import ProfilerActivity, profile, record_function

    trace.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(5):
            with trace.span("outer", root=True):
                with record_function("probe"):
                    time.sleep(0.02)
    trace.disable()
    path = tmp_path / "t.json"
    trace.export_chrome(prof, trace.take(), path)
    events = json.loads(path.read_text())["traceEvents"]
    probes = sorted((e for e in events if e.get("name") == "probe"), key=lambda e: e["ts"])
    outers = sorted((e for e in events if e.get("cat") == "cova"), key=lambda e: e["ts"])
    assert len(probes) == len(outers) == 5
    starts, ends = [], []
    for probe, outer in zip(probes, outers):
        # Microseconds on the trace's clock: each probe inside its span,
        # within 1 ms at each end.
        assert outer["name"] == "outer" and outer["dur"] >= 20_000
        assert outer["ts"] - 1000 <= probe["ts"] <= probe["ts"] + probe["dur"] <= \
            outer["ts"] + outer["dur"] + 1000
        starts.append(abs(probe["ts"] - outer["ts"]))
        ends.append(abs((probe["ts"] + probe["dur"]) - (outer["ts"] + outer["dur"])))
    # The clocks agree within 1 ms: the closest of five pairs, so that a
    # thread descheduled between the two reads does not decide it.
    assert min(starts) < 1000 and min(ends) < 1000


def test_spans_go_on_the_track_the_profiler_gives_their_thread():
    # The profiler writes a thread's events under its native id where it
    # saw the thread run a CPU op, else a launch under the low 32 bits of
    # the thread's pthread id: each span follows its thread there.
    spans = [{"name": n, "id": i, "parent": None, "run": None, "tid": tid,
              "ident": (7 << 32) | low, "start": 5_000, "end": 9_000, "cpu": 0}
             for i, (n, tid, low) in enumerate(
                 (("native", 11, 4242), ("pthread", 12, 4242), ("unseen", 13, 4343)), 1)]
    events = trace.chrome_events({"spans": spans, "counters": {}}, 1_000, {11, 4242})
    assert [(e["name"], e["tid"]) for e in events] == [
        ("native", 11), ("pthread", 4242), ("unseen", 13)]
    assert all(e["ts"] == 4.0 and e["dur"] == 4.0 for e in events)


def test_run_cova_writes_one_chrome_trace(tmp_path):
    out = tmp_path / "trace.json"
    run_cova.main([str(SMALL), str(tmp_path / "out"), "--device", "cpu",
                   "--max-frames", "40", "--trace", str(out)])
    assert not trace.enabled()
    events = json.loads(out.read_text())["traceEvents"]
    ours = [e for e in events if e.get("cat") == "cova"]
    assert len(ours) < len(events)  # the profiler's events are there too
    (run,) = [e for e in ours if e["name"] == "cova.run"]
    assert run["args"]["counters"]["entdec.frames"] == run["args"]["frames"]
    inside = [e for e in ours if e is not run]
    assert inside and all(run["ts"] <= e["ts"] and e["ts"] + e["dur"] <= run["ts"] + run["dur"]
                          + 1e-3 for e in inside)

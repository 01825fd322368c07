"""BENCHMARK.json against the harness: every metric has its reader,
every cell reports set-up, another end-to-end metric and the end-to-end
metric each of its per-layer metrics moves, and every configuration names
an oracle whose module the harness can drive."""

import importlib.util
import json

from bench_port import check, oracles, run

BENCH = json.loads((run.ROOT / "BENCHMARK.json").read_text())


class _Cell:
    def __init__(self, spec):
        self.bench, self.cell = BENCH, spec


def test_every_metric_has_a_reader():
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        path = run.HERE / "metrics" / f"{m['name']}.py"
        spec = importlib.util.spec_from_file_location("reader", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        assert callable(mod.read), m["name"]


def test_each_cell_reports_what_its_metrics_move():
    for w in BENCH["workloads"]:
        cell = _Cell(w)
        e2e = {m["name"] for m in run.cell_metrics(cell, "end_to_end")}
        layers = run.cell_metrics(cell, "per_layer")
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert layers, w["name"]
        for m in layers:
            assert m["moves"] in e2e, (w["name"], m["name"])


def test_readers_leave_out_what_they_cannot_read():
    # No trace and no frames: every reader returns None, never 0.
    empty = dict(cell=None, jobs=[], window_s=1.0, trace=None, peak_flops=1.0, setup_s=None,
                 frames=0, chunks=0, pictures=0, oracle_frames=0, model_flops=0)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        path = run.HERE / "metrics" / f"{m['name']}.py"
        spec = importlib.util.spec_from_file_location("reader", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        assert mod.read(empty) is None, m["name"]


def test_every_config_names_an_oracle_with_the_whole_contract():
    for c in BENCH["configs"]:
        conf = json.loads((run.ROOT / c["file"]).read_text())
        oracle = oracles.load(conf)
        assert set(oracle.FOLD) == set(oracle.LIMITS), c["name"]
        assert not set(oracle.LIMITS) & set(check.LIMITS), c["name"]
        assert oracle.flops() > 0, c["name"]
        for name in ("__call__", "take"):
            assert callable(getattr(oracle.Program, name, None)), (c["name"], name)
        for name in ("outputs", "numbers", "control"):
            assert callable(getattr(oracle.Reference, name, None)), (c["name"], name)

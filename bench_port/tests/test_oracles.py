"""The oracle chosen by the configuration (CPU): the lookup by
`oracle.arch`, its refusals, YOLOv4's module on one picture, and a toy
oracle that the test alone defines, reached by the same lookup and run
through the oracle's part of the comparison."""

import json
import operator
import shutil
import sys
import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from bench_port import check, oracles, run

SEED = 2**31 + 1234


def test_yolov4_counts_its_frame():
    assert oracles.load({"oracle": {"arch": "yolov4"}}).flops() == 128_389_482_496


def _cell_dir(tmp_path, oracle):
    """A checkout of one cell whose configuration's oracle is `oracle`."""
    conf = json.loads((run.HERE / "configs" / "cova-synth720.json").read_text())
    conf["name"], conf["oracle"] = "probe", oracle
    here = tmp_path / "bench_port"
    (here / "configs").mkdir(parents=True)
    (here / "traffic").mkdir()
    (here / "configs" / "probe.json").write_text(json.dumps(conf))
    shutil.copy(run.HERE / "traffic" / "full.json", here / "traffic")
    cell = {"name": "probe.full", "config": "probe", "traffic": "full", "chips": 1}
    (tmp_path / "BENCHMARK.json").write_text(json.dumps({"workloads": [cell]}))
    return here


@pytest.mark.parametrize("arch,said", [(None, "names no oracle arch"),
                                       ("nosuchdetector", "'nosuchdetector' has no module"),
                                       ("yolov4.x", "'yolov4.x' is not a module name")])
def test_set_up_refuses_a_config_without_an_oracle_module(tmp_path, monkeypatch, arch, said):
    oracle = dict(json.loads((run.HERE / "configs" / "cova-synth720.json").read_text())["oracle"])
    oracle.pop("arch")
    if arch is not None:
        oracle["arch"] = arch
    here = _cell_dir(tmp_path, oracle)
    monkeypatch.setattr(run, "ROOT", tmp_path)
    monkeypatch.setattr(run, "HERE", here)
    # The checkout holds no clip: a refusal after the streams were read
    # would be a FileNotFoundError, not the oracle's.
    with pytest.raises(ValueError, match=said):
        run.Cell("probe.full", SEED, device="cpu")


def _pictures(n, h=48, w=64):
    g = np.random.default_rng(7)
    return [tuple(g.integers(0, 256, s, dtype=np.uint8) for s in ((h, w), (h // 2, w // 2),
                                                                  (h // 2, w // 2)))
            for _ in range(n)]


def test_yolov4_module_holds_the_program_to_the_reference_on_a_picture():
    """The module's program (the port's detector on the CPU) against its
    plain reference through the comparison: within its limits."""
    oracle = oracles.load({"oracle": {"arch": "yolov4"}})
    conf = json.loads((run.HERE / "configs" / "cova-synth720.json").read_text())["oracle"]
    program = oracle.Program(conf, SEED, "cpu")
    y, u, v = _pictures(1, 720, 1280)[0]
    recs = program([(0.5, y, u, v)])
    heads = program.take()
    assert [tuple(h.shape) for h in heads] == [(1, 76, 76, 255), (1, 38, 38, 255),
                                              (1, 19, 19, 255)]
    assert all(h.device.type == "cpu" for h in heads)
    reference = oracle.Reference(conf, program.weights, "cpu")
    n = check.oracle_numbers(oracle, reference, [((0, 0), y, u, v, recs, heads)], {})
    assert set(n) == set(oracle.LIMITS)
    assert check.verdict(n, oracle.LIMITS), n


class _ToyProgram:
    """The toy's detector: the luma pooled 4 x 4 is its one head, and each
    of the `boxes` largest cells a box."""

    def __init__(self, conf, seed, device):
        self.conf, self.weights, self._head = conf, None, None

    def __call__(self, frames):
        recs = []
        for ts, y, u, v in frames:
            x = torch.from_numpy(y).float()[None, None] / 255.0
            self._head = F.avg_pool2d(x, 4)
            recs += _toy_boxes([self._head], self.conf["boxes"])
        return recs

    def take(self):
        head, self._head = self._head, None
        return (head,)


class _ToyReference:
    def __init__(self, conf, weights, device):
        self.conf = conf

    def outputs(self, y, u, v):
        h, w = y.shape
        x = torch.from_numpy(y.astype(np.float64) / 255.0)
        return [x.reshape(h // 4, 4, w // 4, 4).mean((1, 3)).float()[None, None]]

    def numbers(self, ref, outs, recs, frame_hw):
        return {"head_gap": check.head_gap(outs, ref),
                "detections_off": check.detections_off(recs, [
                    (b.class_id, b.confidence, b.left, b.top, b.width, b.height)
                    for b in _toy_boxes(outs, self.conf["boxes"])])}

    def control(self, y, u, v):
        ref = self.outputs(y, u, v)
        return {"head_gap": check.head_gap([r.half() for r in ref], ref), "detections_off": 0}


def _toy_boxes(heads, k):
    flat = heads[0].flatten()
    top = torch.topk(flat, k).indices.tolist()
    w = heads[0].shape[-1]
    return [check.Box(0, float(flat[i]), 4.0 * (i % w), 4.0 * (i // w), 4.0, 4.0) for i in top]


@pytest.fixture
def toy(monkeypatch):
    mod = types.ModuleType("bench_port.oracles.toy")
    mod.LIMITS = {"head_gap": 1e-5, "detections_off": 0}
    mod.FOLD = {"head_gap": max, "detections_off": operator.add}
    mod.flops = lambda: 48 * 64
    mod.Program, mod.Reference = _ToyProgram, _ToyReference
    monkeypatch.setitem(sys.modules, mod.__name__, mod)
    return mod


def _toy_frames(oracle, conf):
    program = oracle.Program(conf, SEED, "cpu")
    frames = []
    for i, (y, u, v) in enumerate(_pictures(3)):
        recs = program([(i / 30, y, u, v)])
        frames.append(((0, i), y, u, v, recs, program.take()))
    return frames, oracle.Reference(conf, program.weights, "cpu")


def test_a_toy_oracle_runs_through_the_comparison(toy):
    conf = {"arch": "toy", "boxes": 5}
    oracle = oracles.load({"name": "toy-config", "oracle": conf})
    assert oracle is toy
    frames, reference = _toy_frames(oracle, conf)

    sound = check.oracle_numbers(oracle, reference, frames, {})
    assert sound["detections_off"] == 0 and sound["head_gap"] < oracle.LIMITS["head_gap"]
    assert check.verdict(sound, oracle.LIMITS)

    shifted = [(k, y, u, v, recs, tuple(h + 1e-3 for h in outs))
               for k, y, u, v, recs, outs in frames]
    bad = check.oracle_numbers(oracle, reference, shifted, {})
    assert bad["head_gap"] > oracle.LIMITS["head_gap"]
    assert not check.verdict(bad, oracle.LIMITS)

    (k, y, u, v, recs, outs), *rest = frames
    dropped = check.oracle_numbers(oracle, reference, [(k, y, u, v, recs[:-1], outs)] + rest, {})
    assert dropped["detections_off"] == 1
    assert not check.verdict(dropped, oracle.LIMITS)


def test_the_reference_runs_once_a_picture(toy):
    conf = {"arch": "toy", "boxes": 2}
    oracle = oracles.load({"oracle": conf})
    frames, reference = _toy_frames(oracle, conf)
    calls = []
    outputs = reference.outputs
    reference.outputs = lambda *a: calls.append(1) or outputs(*a)
    outputs_of = {}
    check.oracle_numbers(oracle, reference, frames + frames, outputs_of)
    assert len(calls) == len(outputs_of) == len(frames)

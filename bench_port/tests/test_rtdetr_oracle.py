"""The RT-DETR-R50 oracle module (oracles/rtdetr.py) on the CPU: its
frame's operations against torch.utils.flop_counter and K11's formula;
the program held to its plain reference on one 720p picture, within its
limits, and a dropped decoder layer, the valid mask skipped and K11's
locations read with align_corners True not; `queries_off` tolerant of a
near-tie at the last selected place and not of a token out of place;
K11's bytes from the sampling locations; the seeded weights; the
reference's copies; the per-layer readers on a run."""

import functools
import json
import types

import numpy as np
import pytest
import torch

from bench_port import check, oracles, run

SEED = 2**31 + 4321
CONF = json.loads((run.HERE / "configs" / "cova-synth720-rtdetr.json").read_text())


@pytest.fixture(scope="module")
def oracle():
    return oracles.load(CONF)


@pytest.fixture(scope="module")
def frame(oracle):
    """One 720p picture (the synth scene's background with a bright
    rectangle) through the program, and the reference on it."""
    torch.set_num_threads(4)
    program = oracle.Program(CONF["oracle"], SEED, "cpu")
    y = np.load(run.ROOT / "artifacts" / "synth_bg.npy").repeat(2, 0).repeat(2, 1)
    y[200:420, 300:700] = 235
    u = np.full((360, 640), 128, np.uint8)
    v = u.copy()
    v[100:210, 150:350] = 200
    recs = program([(0.25, y, u, v)])
    outs = program.take()
    reference = oracle.Reference(CONF["oracle"], program.weights, "cpu")
    return program, reference, (y, u, v), recs, outs


def test_flops_are_the_counters_and_k11s(oracle):
    from torch.utils.flop_counter import FlopCounterMode

    from cova_tpu_torch.models.rtdetr import RTDETR

    torch.set_num_threads(4)
    model = RTDETR().eval()
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        model(torch.rand(1, 640, 640, 3))
    k11 = 6 * oracle.msda_ops(300, 8 * 3 * 4, 32)
    assert k11 == 6 * 10 * 300 * 96 * 32
    assert oracle.flops() == counter.get_total_flops() + k11 == 137_835_315_200


def test_program_within_its_limits_on_a_picture(oracle, frame):
    program, reference, (y, u, v), recs, outs = frame
    assert {k: tuple(outs[k].shape) for k in ("memory", "scores", "indices", "logits", "boxes")} \
        == {"memory": (8400, 256), "scores": (8400,), "indices": (300,), "logits": (300, 80),
            "boxes": (300, 4)}
    assert all(outs[k].device.type == "cpu" for k in ("memory", "logits"))
    work = [oracle.msda_work(*launch) for launch in outs["msda"]]
    assert len(work) == 6 and all(ops == 9_216_000 for ops, _ in work)
    assert all(4_000_000 < nbytes < 6_000_000 for _, nbytes in work)
    assert recs and all(r.confidence > 0.25 for r in recs)
    numbers = check.oracle_numbers(oracle, reference, [((0, 0), y, u, v, recs, outs)], {})
    assert set(numbers) == set(oracle.LIMITS)
    assert check.verdict(numbers, oracle.LIMITS), numbers


def _layers(program):
    return program.model.decoder.decoder.layers


@pytest.mark.parametrize("fault", ["dropped_layer", "valid_mask_skipped", "align_corners"])
def test_planted_faults_are_not_correct(oracle, frame, monkeypatch, fault):
    program, reference, (y, u, v), _, _ = frame
    if fault == "dropped_layer":
        monkeypatch.setattr(_layers(program)[3], "forward", lambda tgt, *a: tgt)
    elif fault == "valid_mask_skipped":
        monkeypatch.setattr(program.model.decoder, "valid_mask",
                            torch.ones_like(program.model.decoder.valid_mask))
    else:
        for layer in _layers(program):
            attn = layer.cross_attn
            monkeypatch.setattr(attn, "ms_deformable_attn_core",
                                functools.partial(attn.ms_deformable_attn_core,
                                                  align_corners=True))
    recs = program([(0.25, y, u, v)])
    outs = program.take()
    numbers = check.oracle_numbers(oracle, reference, [((0, 0), y, u, v, recs, outs)], {})
    assert not check.verdict(numbers, oracle.LIMITS), numbers


def test_queries_off_takes_a_near_tie_and_not_a_swap(oracle, frame):
    _, reference, (y, u, v), recs, outs = frame
    ref = reference.outputs(y, u, v)
    scores = ref["sel"]["scores"][0]
    order = torch.argsort(scores, descending=True)
    last, first_out = order[299], order[300]
    picked = outs["indices"].clone()
    picked[picked == last] = first_out
    for below, off in ((0.5 * oracle.QUERY_TOL, 0), (100 * oracle.QUERY_TOL, 1)):
        planted = {**ref, "sel": {**ref["sel"], "scores": ref["sel"]["scores"].clone()}}
        planted["sel"]["scores"][0, first_out] = scores[last] - below
        n = reference.numbers(planted, {**outs, "indices": picked}, recs, y.shape)
        assert n["queries_off"] == off, (below, n)


def test_k11_bytes_count_the_rows_the_samples_touch(oracle):
    shapes = [(4, 4), (2, 2)]
    value_shape = (1, 20, 2, 32)
    # One query: every sample of head 0 and head 1 at the centre of cell
    # (1, 1) of each level (one row a level), box size 0.
    boxes = torch.tensor([[[1.5 / 4, 1.5 / 4, 0.0, 0.0]]])
    offsets = torch.zeros(1, 1, 2 * 2 * 2 * 2)
    ops, nbytes = oracle.msda_work(value_shape, shapes, boxes, offsets, 2, 2)
    # Level 0: (1, 1) exactly -> corners (1, 1), (2, 1), (1, 2), (2, 2);
    # level 1: loc 0.375 * 2 - 0.5 = 0.25 -> corners (0..1, 0..1): 4 rows
    # a level and head.
    rows = 2 * (4 + 4)
    assert ops == 10 * 1 * 8 * 32
    assert nbytes == 4 * (rows * 32 + 4 + 3 * 8 + 64)
    far = oracle.msda_work(value_shape, shapes, torch.tensor([[[9.0, 9.0, 0.0, 0.0]]]),
                           offsets, 2, 2)[1]
    assert far == 4 * (4 + 3 * 8 + 64)  # no row inside any map


def test_seeded_weights_repeat_and_load(oracle):
    from cova_tpu_torch.models.rtdetr import RTDETR

    cfg = oracle.config(CONF["oracle"])
    a = oracle.seeded_state(7, "cpu", cfg, -4.3)
    b = oracle.seeded_state(7, "cpu", cfg, -4.3)
    assert a.keys() == RTDETR(cfg).state_dict().keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert float(a["decoder.dec_score_head.5.bias"][0]) == pytest.approx(-4.3)
    assert not torch.equal(a["backbone.conv1.conv1_1.conv.weight"],
                           oracle.seeded_state(8, "cpu", cfg, -4.3)[
                               "backbone.conv1.conv1_1.conv.weight"])


def test_reference_copies_are_the_same_file():
    assert (run.HERE / "ref" / "rtdetr_ref.py").read_bytes() == \
        (run.ROOT / "tests" / "rtdetr_plain.py").read_bytes()


def _reader(name):
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, run.HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_readers_on_a_run(tmp_path):
    from bench_port.trace import Trace

    # The trace's timeline starts at 1e12 ns. Launches: two K11 kernels
    # from thread 7 (its native id) at 0.5 and 0.6 us, an op at 2.5 us
    # from the thread whose pthread id's low bits are 2**32 - 4242 (the
    # trace writes 4242), one from thread 9 at 3.0 us; each runs 10 us.
    (tmp_path / "trace.json").write_text('{"traceEvents": [], "baseTimeNanoseconds": 1000000000000}')
    k11 = "(anonymous namespace)::ms_deform_attn_kernel(MsdaArgs)"
    tr = Trace(device=[(0.0, 10.0, k11, 1), (20.0, 30.0, k11, 2), (40.0, 50.0, "other", 3),
                       (60.0, 70.0, "other", 4)],
               ranges=[], launches={1: (0.5, 7), 2: (0.6, 7), 3: (2.5, 4242), 4: (3.0, 9)})
    base = 10**12

    def ns(us):
        return base + int(us * 1e3)

    low = 2**32 - 4242
    windows = [("oracle", 7, low, ns(0.0), ns(4.0)), ("bench.rtdetr.decoder", 7, low, ns(0.4),
                                                       ns(1.0)),
               ("bench.rtdetr.encoder", 7, low, ns(2.0), ns(2.9))]
    # Two K11 launches whose inputs msda_work counts (test above): one
    # query whose samples touch 16 value rows, and one whose samples touch
    # none; bytes bound both.
    offsets = torch.zeros(1, 1, 16)
    launches = [((1, 20, 2, 32), [(4, 4), (2, 2)], torch.tensor([[[1.5 / 4, 1.5 / 4, 0.0, 0.0]]]),
                 offsets, 2, 2),
                ((1, 20, 2, 32), [(4, 4), (2, 2)], torch.tensor([[[9.0, 9.0, 0.0, 0.0]]]),
                 offsets, 2, 2)]
    least = (4 * (16 * 32 + 4 + 24 + 64) + 4 * (4 + 24 + 64)) / 3.35e12
    job = types.SimpleNamespace(frames=[(0.0, None, None, None, [],
                                         {"msda": launches, "windows": windows})])
    r = dict(trace=tr, jobs=[job], oracle_frames=2, peak_flops=67e12,
             cell=types.SimpleNamespace(tmp=tmp_path))
    assert _reader("msda_roofline_pct")(r) == pytest.approx(100 * least / 20e-6)
    # Thread 9's launch falls inside the window but is another thread's.
    assert _reader("rtdetr_card_ms_per_frame")(r) == pytest.approx(30e-3 / 2)
    assert _reader("rtdetr_decoder_card_ms_per_frame")(r) == pytest.approx(20e-3 / 2)
    assert _reader("rtdetr_encoder_card_ms_per_frame")(r) == pytest.approx(10e-3 / 2)
    # A run of another oracle keeps neither K11 work nor windows.
    yolo = types.SimpleNamespace(frames=[(0.0, None, None, None, [], ())])
    for name in ("msda_roofline_pct", "rtdetr_card_ms_per_frame",
                 "rtdetr_encoder_card_ms_per_frame", "rtdetr_decoder_card_ms_per_frame"):
        assert _reader(name)({**r, "jobs": [yolo]}) is None, name

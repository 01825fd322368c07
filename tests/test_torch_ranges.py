"""The port's range plan (cova_tpu_torch/pipeline/ranges.py) against the
JAX package's CovaPipeline on the CPU: the plan's bounds equal
`CovaPipeline._range_bounds`, its range starts equal what the JAX
pipeline's run hands each stream's aggregator in `set_ranges` (captured
on the instance), and each range's window count is
(count - T) // gamma + 1 at gamma 1 and 2, on the committed 720p render,
a PAFF scene, a B-frame render of the synth scene, a `max_frames` clamp,
more ranges than GoPs and two streams of `CovaPipeline.multi`."""

import dataclasses
import importlib.util
import pathlib
import subprocess

import pytest

import cova_tpu.config as jcfg
import cova_tpu.pipeline.cova as jcova
import cova_tpu_torch.config as tcfg
from cova_tpu_torch.codec import Mp4Demuxer
from cova_tpu_torch.pipeline.ranges import RangePlan

REPO = pathlib.Path(__file__).resolve().parent.parent
SYNTH_720P = REPO / "cova_tpu_torch" / "data" / "synth_1800.mp4"
PAFF_A, PAFF_B = (80, 46, 300, 30), (80, 46, 240, 16)


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _paff(tmp, key):
    from cova_tpu_torch.utils.mp4loop import mux_rec_to_mp4

    pg = _load("paff_gen", REPO / "cova_tpu" / "csrc" / "tools" / "paff_gen.py")
    rec, mp4 = tmp / f"{key}.rec", tmp / f"{key}.mp4"
    pg.scenario_pipeline(*key).write_rec(str(rec))
    mux_rec_to_mp4(str(rec), str(mp4))
    return str(mp4)


def _bframes(tmp):
    """The B-frame CABAC render of test_host_tracking_synth_bframes_match_jax."""
    csrc = REPO / "cova_tpu" / "csrc"
    try:
        subprocess.run(["make", "-s", "-C", str(csrc), "tools/encode_yuv"],
                       check=True, capture_output=True)
    except (OSError, subprocess.CalledProcessError) as e:
        pytest.skip(f"encode_yuv cannot be built here: {e}")
    ms = _load("make_synth", REPO / "examples" / "make_synth.py")
    return ms.render(str(tmp / "synth.mp4"), frames=90)


# name -> (inputs, ranges a stream, max_frames)
CASES = {
    "720p-R4": (["720p"], 4, None),
    "720p-R8": (["720p"], 8, None),
    "paff": ([PAFF_A], 2, None),
    "bframes": (["bframes"], 2, None),
    "max-frames": (["720p"], 4, 100),
    "more-ranges-than-gops": ([PAFF_B], 16, None),
    "multi": ([PAFF_A, PAFF_B], 2, None),
}


class _Stop(Exception):
    """Ends the JAX pipeline's run once it has handed out its ranges."""


@pytest.fixture
def jax_pipeline(monkeypatch):
    """JAX's CovaPipeline (`multi` for several inputs) without BlobNet's
    Flax init, which the range plan does not need."""
    monkeypatch.setattr(jcova, "create_blobnet", lambda key, cfg: (None, None))

    def make(paths, num_ranges, out):
        cfg = jcfg.CovaConfig(parallel=jcfg.ParallelConfig(num_ranges=num_ranges),
                              last="select")
        return jcova.CovaPipeline.multi(
            [(p, str(out / f"jax{i}"), None) for i, p in enumerate(paths)], cfg,
            log=lambda *_: None)

    return make


@pytest.mark.parametrize("case", list(CASES))
def test_plan_matches_jax_pipeline(case, jax_pipeline, tmp_path):
    inputs, r, max_frames = CASES[case]
    paths = [str(SYNTH_720P) if x == "720p" else _bframes(tmp_path) if x == "bframes"
             else _paff(tmp_path, x) for x in inputs]
    jpipe = jax_pipeline(paths, r, tmp_path)
    starts = []
    for s in jpipe.streams:
        def record(range_starts):
            starts.append(range_starts)
            if len(starts) == len(jpipe.streams):
                raise _Stop
        s.aggregator.set_ranges = record
    with pytest.raises(_Stop):
        jpipe.run(max_frames)
    bounds = jpipe._range_bounds()
    if max_frames:
        bounds = [(sx, s, min(c, max_frames)) for sx, s, c in bounds]

    demuxers = [Mp4Demuxer(p) for p in paths]
    try:
        for gamma in (1, 2):
            c = tcfg.CovaConfig()
            cfg = dataclasses.replace(
                c, parallel=tcfg.ParallelConfig(num_ranges=r),
                compressed=dataclasses.replace(c.compressed, gamma=gamma))
            plan = RangePlan.build(demuxers, cfg, max_frames)
            assert plan.bounds == bounds
            assert [[rs for rs, (sx, _, _) in zip(plan.range_starts, plan.bounds) if sx == i]
                    for i in range(len(paths))] == starts
            t = cfg.video.timestep
            assert plan.windows == [max(0, (n - t) // gamma + 1) for _, _, n in bounds]
            assert sum(plan.windows) > 0
    finally:
        for d in demuxers:
            d.close()
    assert len(bounds) == r * len(paths)
    if case == "more-ranges-than-gops":
        assert bounds[-1][2] == 0
    if max_frames:
        assert max(n for _, _, n in bounds) == max_frames

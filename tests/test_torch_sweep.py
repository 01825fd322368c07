"""The PyTorch port's sweep harness (cova_tpu_torch/examples/
sweep_accuracy.py) against the JAX package's examples/sweep_accuracy.py on
the CPU, on the first 150 frames of each range of the committed synth
render (cova_tpu_torch/data/synth_1800.mp4).

* the render is the committed one: its sha256, 1800 samples, a 80x45
  macroblock grid, the recipe sidecar;
* `SweepContext`'s geometry, metadata and ground-truth lookup equal
  JAX's; `probs` on the CPU within PROBS_TOL of JAX's;
* `run_config`'s four CSVs byte-identical to JAX's `run_config` on the
  same probabilities and configuration, and the report dicts equal.

tests/test_torch_sweep_pipeline.py holds the replay against the port's
full pipeline.
"""

import dataclasses
import hashlib
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from cova_tpu_torch.codec import Mp4Demuxer
from cova_tpu_torch.examples import sweep_accuracy as tsweep

# The suite runs one test worker per core: keep torch to one thread each.
torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
VIDEO = REPO / "cova_tpu_torch" / "data" / "synth_1800.mp4"
GT = REPO / "golden" / "synth" / "dnn_gt.csv"
WEIGHTS = REPO / "artifacts" / "blobnet_synth.npz"
RENDER_SHA256 = "ba8e20d4061c8bf4b67102d46ecc033f774339e6b804ce23d8ea9e761e0d2160"
CSVS = ("track", "dnn", "assoc", "stationary")
NMAX = 150
# BlobNet on the CPU, port against JAX: float32 sums in other orders
# (3.3e-6 measured on this prefix).
PROBS_TOL = 1e-5
SYNTH_POINT = dict(mask_threshold=0.6, cc_threshold=2, min_hits=40, max_age=45)
SHORT_POINT = dict(mask_threshold=0.6, cc_threshold=2, min_hits=3, max_age=10)


def _jax_sweep():
    spec = importlib.util.spec_from_file_location(
        "jax_sweep_accuracy", REPO / "examples" / "sweep_accuracy.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _CacheDirOnly:
    """`pathlib` for the JAX example with its fixed probability cache
    directory moved under the test's temporary directory."""

    def __init__(self, root):
        self.root = root

    def Path(self, p, *rest):
        return self.root if str(p) == "/tmp/cova_sweep_cache" else pathlib.Path(p, *rest)


@pytest.fixture(scope="module")
def jsweep(tmp_path_factory):
    mod = _jax_sweep()
    mod.pathlib = _CacheDirOnly(tmp_path_factory.mktemp("jax_cache"))
    return mod


@pytest.fixture(scope="module")
def jctx(jsweep):
    return jsweep.SweepContext(str(VIDEO), gt_csv=GT, dataset="synth", max_frames=NMAX)


@pytest.fixture(scope="module")
def tctx():
    return tsweep.SweepContext(VIDEO, gt_csv=GT, dataset="synth", max_frames=NMAX,
                               device="cpu")


@pytest.fixture(scope="module")
def jprobs(jctx):
    return jctx.probs(WEIGHTS, use_nnz=True, signed_mv=True)


@pytest.fixture(scope="module")
def tprobs(tctx):
    return tctx.probs(WEIGHTS, use_nnz=True, signed_mv=True, cache=False)


def test_committed_render():
    assert hashlib.sha256(VIDEO.read_bytes()).hexdigest() == RENDER_SHA256
    recipe = (VIDEO.parent / (VIDEO.name + ".recipe")).read_text()
    spec = importlib.util.spec_from_file_location("make_synth", REPO / "examples" / "make_synth.py")
    make_synth = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(make_synth)
    assert recipe == f"{make_synth.RECIPE} seed=11 frames=1800"
    d = Mp4Demuxer(str(VIDEO))
    assert (d.num_samples, d.width, d.height) == (1800, 1280, 720)
    assert (d.mb_width, d.mb_height) == (80, 45)
    d.close()


def test_context_matches_jax(jctx, tctx):
    for name in ("bounds", "range_starts", "frame_info", "sample_sec", "duration",
                 "mb_h", "mb_w"):
        assert getattr(tctx, name) == getattr(jctx, name), name
    np.testing.assert_array_equal(tctx.pts_sec, jctx.pts_sec)
    for a, b in zip(tctx.metadata_for(True), jctx.metadata_for(True)):
        np.testing.assert_array_equal(a, b)
    # The frame lookup (round-trip parse) and the metric's frame (pandas'
    # default parse).
    assert sorted(tctx.gt_by_ts) == sorted(jctx.gt_by_ts)
    for ts, recs in jctx.gt_by_ts.items():
        assert [dataclasses.astuple(r) for r in tctx.gt_by_ts[ts]] == [
            dataclasses.astuple(r) for r in recs]
    assert tctx.gt_df.index.tobytes() == jctx.gt_df.index.to_numpy().tobytes()
    for col in ("left", "top", "width", "height", "class_id"):
        np.testing.assert_array_equal(tctx.gt_df[col], jctx.gt_df[col].to_numpy(float))


def test_probs_match_jax(jprobs, tprobs):
    assert [p.shape for p in tprobs] == [p.shape for p in jprobs]
    assert all(p.dtype == np.float32 for p in tprobs)
    err = max(float(np.abs(a - b).max()) for a, b in zip(tprobs, jprobs))
    assert err <= PROBS_TOL
    thr = SYNTH_POINT["mask_threshold"]
    for a, b in zip(tprobs, jprobs):
        flipped = (a > thr) != (b > thr)
        assert not (flipped & (np.abs(b - thr) > 1e-4)).any()


@pytest.mark.parametrize("point,window", [
    (SYNTH_POINT, {}),
    (SHORT_POINT, {}),
    (SHORT_POINT, {"ts_start": 20.0, "ts_end": 40.0}),
])
def test_run_config_matches_jax(jsweep, jctx, tctx, jprobs, tprobs, point, window, tmp_path):
    jrep = jctx.run_config(jprobs, jsweep.make_cfg(use_nnz=True, **point),
                           out_dir=str(tmp_path / "jax"), **window)
    cfg = tsweep.make_cfg(use_nnz=True, **point)
    rep = tctx.run_config(jprobs, cfg, out_dir=str(tmp_path / "torch"), **window)
    own = tctx.run_config(tprobs, cfg, out_dir=str(tmp_path / "own"), **window)
    assert rep == jrep and own == jrep
    for name in CSVS:
        ref = (tmp_path / "jax" / f"{name}.csv").read_bytes()
        assert (tmp_path / "torch" / f"{name}.csv").read_bytes() == ref, name
        assert (tmp_path / "own" / f"{name}.csv").read_bytes() == ref, name
    assert rep["frames"] == 4 * NMAX and rep["dead_tracks"] > 0

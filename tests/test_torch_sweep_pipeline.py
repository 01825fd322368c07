"""The PyTorch port's sweep harness (cova_tpu_torch/examples/
sweep_accuracy.py) against the port's own pipeline on the CPU, on the
first 150 frames of each range of the committed synth render
(cova_tpu_torch/data/synth_1800.mp4).

* `run_config`'s four CSVs byte-identical to `CovaPipeline(last="full")`
  on the same prefix, the JAX package's libavcodec `PixelDecoder` handed
  to the port's pipeline (the port's codec has none): the port's
  counterpart of test_accuracy_golden.py::TestSweepHarness. The
  replay's ground truth is the oracle's output at the frames the
  pipeline decoded, which is all the replay reads;
* the probabilities' disk cache is the port's own, keyed by the torch
  device.
"""

import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from cova_tpu.codec import PixelDecoder as JaxPixelDecoder
from cova_tpu_torch.examples import sweep_accuracy as tsweep
from cova_tpu_torch.models import bgdet as tbg
from cova_tpu_torch.models.blobnet import load_artifact
from cova_tpu_torch.pipeline import cova as tcova

# The suite runs one test worker per core: keep torch to one thread each.
torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
VIDEO = REPO / "cova_tpu_torch" / "data" / "synth_1800.mp4"
GT = REPO / "golden" / "synth" / "dnn_gt.csv"
WEIGHTS = REPO / "artifacts" / "blobnet_synth.npz"
CSVS = ("track", "dnn", "assoc", "stationary")
NMAX = 150
SHORT_POINT = dict(mask_threshold=0.6, cc_threshold=2, min_hits=3, max_age=10)


@pytest.fixture(scope="module")
def tprobs():
    ctx = tsweep.SweepContext(VIDEO, gt_csv=GT, dataset="synth", max_frames=NMAX,
                              device="cpu")
    return ctx.probs(WEIGHTS, use_nnz=True, signed_mv=True, cache=False)


def test_replay_matches_full_pipeline(tprobs, monkeypatch, tmp_path):
    """The port's counterpart of test_accuracy_golden.py::TestSweepHarness:
    the host replay and its ground-truth lookup stand in for the full
    pipeline, CSV for CSV."""
    monkeypatch.setattr(tcova, "PixelDecoder", JaxPixelDecoder)
    _, sd, meta = load_artifact(WEIGHTS, "cpu")
    cfg = tsweep.make_cfg(use_nnz=True, **SHORT_POINT)
    cfg = dataclasses.replace(
        cfg, compressed=dataclasses.replace(cfg.compressed, signed_mv=bool(meta["signed_mv"])))
    det = tbg.StaticBackgroundDetector(tbg.load_background(REPO / "artifacts" / "synth_bg.npy"),
                                       bus_area=2500)
    res = tcova.CovaPipeline(str(VIDEO), str(tmp_path / "pipe"), cfg, sd, detector=det,
                             device="cpu", log=lambda *_: None).run(max_frames=NMAX)
    ctx = tsweep.SweepContext(VIDEO, gt_csv=tmp_path / "pipe" / "dnn.csv", dataset="synth",
                              max_frames=NMAX, device="cpu")
    rep = ctx.run_config(tprobs, cfg, out_dir=str(tmp_path / "replay"))
    for name in CSVS:
        a = (tmp_path / "pipe" / f"{name}.csv").read_bytes()
        assert (tmp_path / "replay" / f"{name}.csv").read_bytes() == a, name
    assert len((tmp_path / "pipe" / "dnn.csv").read_text().splitlines()) > 1
    assert rep["inference_frames"] == res.decoded_inference == res.pixel_frames
    assert rep["dead_tracks"] == res.dead_tracks and rep["dropped"] == res.dropped
    assert rep["decode_filter_rate"] == round(res.decode_filter_rate, 4)


def test_probs_disk_cache_is_the_ports( monkeypatch, tmp_path):
    assert tsweep.CACHE_DIR.name == "cova_torch_sweep_cache"
    monkeypatch.setattr(tsweep, "CACHE_DIR", tmp_path / "cache")
    n = 12  # frames a range: 9 windows each

    def ctx():
        return tsweep.SweepContext(VIDEO, gt_csv=GT, dataset="synth", max_frames=n,
                                   device="cpu")

    first = ctx()
    got = first.probs(WEIGHTS, use_nnz=True, signed_mv=True)
    path = first.cache_file(WEIGHTS, True, 128, True)
    assert list((tmp_path / "cache").glob("probs_*.npz")) == [path]
    assert [p.shape for p in got] == [(n - 3, 45, 80)] * 4
    # A second context reads the file: BlobNet is not run again.
    ctx2 = ctx()
    monkeypatch.setattr("cova_tpu_torch.pipeline.compressed.compressed_probs_step", None)
    for a, b in zip(ctx2.probs(WEIGHTS, use_nnz=True, signed_mv=True), got):
        np.testing.assert_array_equal(a, b)
    # Another device, or another contract, has its own file.
    ctx2.device = "cuda"
    assert ctx2.cache_file(WEIGHTS, True, 128, True) != path
    ctx2.device = "cpu"
    assert ctx2.cache_file(WEIGHTS, True, 128, False) != path

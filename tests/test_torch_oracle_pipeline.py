"""The PyTorch port's pipeline through its pixel stage and oracle, against
the JAX package, on the CPU.

The port's codec library carries no pixel decoder (it builds
csrc/pixdec_stub.cc, without libavcodec). These tests hand the port's
pipeline modules the JAX package's `PixelDecoder`, which is the same
shared C++ built with libavcodec; nothing else is replaced. Then:

* `CovaPipeline` to the end (last="full") with the port's
  `StaticBackgroundDetector` on a 300-frame render of the synth scene
  (examples/make_synth.py), at the examples/reproduce_synth.py operating
  point: track, dnn, assoc and stationary CSVs byte-identical to the JAX
  pipeline's, with detections in dnn.csv;
* `NaivePipeline` (every frame through the oracle): dnn.csv equal to
  JAX's;
* `build_background` equal to JAX's;
* without a pixel decoder, last="full" refuses to start, and the CLI with
  $COVA_YOLO_WEIGHTS runs to the end with a decoder and refuses without.
"""

import importlib.util
import pathlib
import subprocess

import numpy as np
import pytest
import torch

import cova_tpu.config as jcfg
import cova_tpu_torch.config as tcfg
from cova_tpu.codec import PixelDecoder as JaxPixelDecoder
from cova_tpu.models import bgdet as jbg
from cova_tpu.models.blobnet import load_artifact as jax_load_artifact
from cova_tpu.pipeline.cova import CovaPipeline as JaxCovaPipeline
from cova_tpu.pipeline.naive import NaivePipeline as JaxNaivePipeline
from cova_tpu_torch.models import bgdet as tbg
from cova_tpu_torch.models.blobnet import load_artifact
from cova_tpu_torch.pipeline import cova as tcova
from cova_tpu_torch.pipeline import naive as tnaive
from cova_tpu_torch.utils import dataset as tdataset

# The suite runs one test worker per core: keep torch to one thread each.
torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
ARTIFACTS = REPO / "artifacts"
SYNTH = ARTIFACTS / "blobnet_synth.npz"
CSVS = ("track", "dnn", "assoc", "stationary")
# examples/reproduce_synth.py's operating point.
CC, MASK, MIN_HITS, MAX_AGE, BUS_AREA = 2, 0.6, 40, 45, 2500
FRAMES = 300


@pytest.fixture(scope="module")
def synth_video(tmp_path_factory):
    csrc = REPO / "cova_tpu" / "csrc"
    try:
        subprocess.run(["make", "-s", "-C", str(csrc), "tools/encode_yuv"],
                       check=True, capture_output=True)
    except (OSError, subprocess.CalledProcessError) as e:
        pytest.skip(f"encode_yuv cannot be built here: {e}")
    spec = importlib.util.spec_from_file_location(
        "make_synth", REPO / "examples" / "make_synth.py"
    )
    ms = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ms)
    out = tmp_path_factory.mktemp("synth") / "synth.mp4"
    return ms.build_synth(str(out), frames=FRAMES)


@pytest.fixture
def pixel_decoder(monkeypatch):
    """The JAX package's libavcodec PixelDecoder in the port's modules
    that decode pixels."""
    for mod in (tcova, tnaive, tdataset):
        monkeypatch.setattr(mod, "PixelDecoder", JaxPixelDecoder)


def _cfg(mod, meta, last=None):
    return mod.CovaConfig(
        parallel=mod.ParallelConfig(num_ranges=4),
        sort=mod.SortConfig(min_hits=MIN_HITS, max_age=MAX_AGE),
        compressed=mod.CompressedStageConfig(
            cc_threshold=CC,
            mask_threshold=MASK,
            use_nnz_channel=bool(meta.get("use_nnz_channel", False)),
            signed_mv=bool(meta.get("signed_mv", False)),
        ),
        last=last,
    )


def _csvs(out_dir):
    return {name: (out_dir / f"{name}.csv").read_bytes() for name in CSVS}


def _bg():
    return np.load(ARTIFACTS / "synth_bg.npy")


def test_full_pipeline_with_bgdet_matches_jax(synth_video, pixel_decoder, tmp_path):
    _, sd, meta = load_artifact(SYNTH, "cpu")
    _, jvars, _ = jax_load_artifact(str(SYNTH))
    quiet = dict(log=lambda *_: None)
    res = tcova.CovaPipeline(
        synth_video, str(tmp_path / "torch"), _cfg(tcfg, meta), sd,
        detector=tbg.StaticBackgroundDetector(tbg.load_background(
            ARTIFACTS / "synth_bg.npy"), bus_area=BUS_AREA),
        device="cpu", **quiet,
    ).run()
    jres = JaxCovaPipeline(
        synth_video, str(tmp_path / "jax"), _cfg(jcfg, meta), jvars,
        detector=jbg.StaticBackgroundDetector(_bg(), bus_area=BUS_AREA), **quiet,
    ).run()
    assert _csvs(tmp_path / "torch") == _csvs(tmp_path / "jax")
    for key in ("num_frames", "dropped", "decoded_dependency", "decoded_inference",
                "dead_tracks", "pixel_frames"):
        assert getattr(res, key) == getattr(jres, key), key
    assert res.num_frames == FRAMES and res.pixel_frames > 0
    dnn = (tmp_path / "torch" / "dnn.csv").read_text().splitlines()
    assert len(dnn) > 1  # the oracle's detections reached the aggregator
    assert res.timers.pixel_stage > 0


def test_naive_pipeline_matches_jax(synth_video, pixel_decoder, tmp_path):
    det = tbg.StaticBackgroundDetector(_bg(), bus_area=BUS_AREA)
    jdet = jbg.StaticBackgroundDetector(_bg(), bus_area=BUS_AREA)
    quiet = dict(log=lambda *_: None)
    n = FRAMES // 2
    res = tnaive.NaivePipeline(synth_video, str(tmp_path / "torch"), det, **quiet).run(n)
    jres = JaxNaivePipeline(synth_video, str(tmp_path / "jax"), jdet, **quiet).run(n)
    assert (res.num_frames, res.num_detections) == (jres.num_frames, jres.num_detections)
    assert res.num_frames >= n - 4 and res.num_detections > 0  # B-frames in flight
    got = (tmp_path / "torch" / "dnn.csv").read_bytes()
    assert got == (tmp_path / "jax" / "dnn.csv").read_bytes()


def test_build_background_matches_jax(synth_video, pixel_decoder, tmp_path):
    quiet = dict(log=lambda *_: None)
    bg = tbg.build_background(synth_video, max_frames=60, **quiet)
    ref = jbg.build_background(synth_video, max_frames=60, **quiet)
    assert bg.dtype == np.uint8 and bg.shape == (360, 640)
    np.testing.assert_array_equal(bg, ref)
    tbg.save_background(tmp_path / "bg" / "bg.npy", bg)
    np.testing.assert_array_equal(tbg.load_background(tmp_path / "bg" / "bg.npy"), bg)


def test_full_run_refuses_stub_decoder(synth_video, tmp_path):
    _, sd, meta = load_artifact(SYNTH, "cpu")
    pipe = tcova.CovaPipeline(
        synth_video, str(tmp_path / "out"), _cfg(tcfg, meta), sd,
        detector=tbg.StaticBackgroundDetector(_bg()), log=lambda *_: None,
        device="cpu",
    )
    with pytest.raises(RuntimeError, match="needs the selective pixel decoder"):
        pipe.run()
    assert not (tmp_path / "out" / "track.csv").read_text()  # nothing ran


TINY_CFG = """
[net]
width=64
height=64
channels=3

[convolutional]
batch_normalize=1
filters=8
size=3
stride=2
pad=1
activation=leaky

[maxpool]
size=2
stride=2

[convolutional]
filters=27
size=1
stride=1
pad=1
activation=linear

[yolo]
mask=0,1,2
anchors=10,14, 23,27, 37,58, 81,82, 135,169, 344,319
classes=4
num=6
"""


@pytest.mark.parametrize("decoder", ["libavcodec", "stub"])
def test_run_cova_cli_with_yolo(synth_video, tmp_path, monkeypatch, capsys, decoder):
    """$COVA_YOLO_WEIGHTS + $COVA_YOLO_CFG (a small darknet cfg): the CLI
    builds the oracle and runs to the end (last="full") when a pixel
    decoder opens, and refuses with the stub."""
    from cova_tpu_torch import run_cova
    from cova_tpu_torch.models.darknet_cfg import create_darknet

    cfg = tmp_path / "tiny.cfg"
    cfg.write_text(TINY_CFG)
    model, _ = create_darknet(str(cfg), device="cpu")
    total = sum(p.numel() for k, p in model.state_dict().items()
                if not k.endswith("num_batches_tracked"))
    weights = tmp_path / "tiny.weights"
    buf = np.random.default_rng(0).normal(0, 0.5, total).astype(np.float32)
    buf = np.abs(buf) + 0.5  # BN variances stay positive
    weights.write_bytes(np.zeros(5, np.int32).tobytes() + buf.tobytes())
    monkeypatch.setenv("COVA_YOLO_WEIGHTS", str(weights))
    monkeypatch.setenv("COVA_YOLO_CFG", str(cfg))
    if decoder == "libavcodec":
        monkeypatch.setattr(tcova, "PixelDecoder", JaxPixelDecoder)
    out = tmp_path / "out"
    argv = [synth_video, str(out), "--device", "cpu", "--max-frames", "120"]
    if decoder == "stub":
        with pytest.raises(RuntimeError, match="needs the selective pixel decoder"):
            run_cova.main(argv)
        return
    run_cova.main(argv)
    printed = capsys.readouterr().out
    assert "using YOLOv4 oracle" in printed, printed
    for name in CSVS:
        assert (out / f"{name}.csv").exists()
    assert len((out / "dnn.csv").read_text().splitlines()) > 1

"""The PyTorch port's synth report (cova_tpu_torch/examples/reproduce_synth.py
and the sweep harness's CLI) on the CPU.

* reproduce_synth --replay on a prefix of the committed render
  (cova_tpu_torch/data/synth_1800.mp4): the report carries the JAX
  script's keys, and the sweep CLI at the dataset's operating point
  prints the same in-domain row;
* the two routes of reproduce_synth on a 120-frame render of the synth
  scene (examples/make_synth.py), the JAX package's libavcodec
  `PixelDecoder` handed to the port's modules that decode pixels: the
  full flow and --replay on its ground truth write the same CSVs and
  report;
* slow: the committed render is what build_synth makes, byte for byte;
  the full clip's report equals the committed float32 reference
  (cova_tpu_torch/data/synth_1800_report_cpu.json, which chip_smoke.py
  holds the card to) and the JAX package's sweep harness on the same
  render, and holds the bands of the committed TPU report that this
  render's float32 path meets.
"""

import importlib.util
import json
import pathlib
import subprocess
import sys

import pytest
import torch

from cova_tpu.codec import PixelDecoder as JaxPixelDecoder
from cova_tpu_torch import codec as tcodec
from cova_tpu_torch.examples import reproduce_synth as tsynth
from cova_tpu_torch.examples import sweep_accuracy as tsweep
from cova_tpu_torch.models.blobnet import load_meta_npz
from cova_tpu_torch.pipeline import cova as tcova
from cova_tpu_torch.pipeline import naive as tnaive
from cova_tpu_torch.utils import dataset as tdataset

# The suite runs one test worker per core: keep torch to one thread each.
torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
VIDEO = REPO / "cova_tpu_torch" / "data" / "synth_1800.mp4"
REFERENCE = REPO / "cova_tpu_torch" / "data" / "synth_1800_report_cpu.json"
CSVS = ("track", "dnn", "assoc", "stationary")
FRAMES = 120
# Frames a range of the committed render: one chunk of 128 windows, the
# least the probability pass runs, and past the operating point's min_hits.
PREFIX = 131


def _jax_example(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _csvs(d):
    return {name: (pathlib.Path(d) / f"{name}.csv").read_bytes() for name in CSVS}


@pytest.fixture(scope="module")
def synth_video(tmp_path_factory):
    csrc = REPO / "cova_tpu" / "csrc"
    try:
        subprocess.run(["make", "-s", "-C", str(csrc), "tools/encode_yuv"],
                       check=True, capture_output=True)
    except (OSError, subprocess.CalledProcessError) as e:
        pytest.skip(f"encode_yuv cannot be built here: {e}")
    out = tmp_path_factory.mktemp("synth") / "synth.mp4"
    return _jax_example("make_synth").build_synth(str(out), frames=FRAMES)


@pytest.fixture
def pixel_decoder(monkeypatch):
    for mod in (tcodec, tcova, tnaive, tdataset):
        monkeypatch.setattr(mod, "PixelDecoder", JaxPixelDecoder)


def test_replay_prefix_report(tmp_path, capsys, monkeypatch):
    report = tsynth.main([str(tmp_path / "out"), "--replay", "--device", "cpu",
                          "--max-frames", str(PREFIX)])
    assert json.loads((tmp_path / "out" / "report.json").read_text()) == report
    tpu = json.loads((REPO / "golden" / "synth" / "report.json").read_text())
    assert set(tpu) <= set(report) and set(tpu["zeroshot_demo_weights"]) == set(
        report["zeroshot_demo_weights"])
    assert report["route"] == "replay" and report["frames"] == 4 * PREFIX
    assert report["input"] == "cova_tpu_torch/data/synth_1800.mp4"
    assert report["decode_filter_rate"] < 1.0 and report["dead_tracks"] > 0
    for tag in ("cova", "cova_zeroshot"):
        assert len((tmp_path / "out" / tag / "track.csv").read_text().splitlines()) > 1, tag
    assert {k: report["zeroshot_demo_weights"][k] for k in tsynth.METRICS} != {
        k: report[k] for k in tsynth.METRICS}
    # The sweep CLI at the dataset's operating point prints the in-domain
    # row first.
    monkeypatch.setattr(tsweep, "CACHE_DIR", tmp_path / "cache")
    capsys.readouterr()
    tsweep.main(["--device", "cpu", "--max-frames", str(PREFIX)])
    line = capsys.readouterr().out.splitlines()[0]
    assert line.startswith("defaults: ")
    printed = json.loads(line[len("defaults: "):])
    assert {k: printed[k] for k in printed if k in report} == {
        k: report[k] for k in printed if k in report}


def test_reproduce_synth_full_route_matches_replay(synth_video, pixel_decoder, monkeypatch,
                                                  tmp_path):
    """The full flow (naive ground truth, CovaPipeline to the end) and
    --replay with that ground truth as the oracle's output write the same
    CSVs and report. The tracker's horizon is cut to the 120-frame clip's
    (a range is 30 frames)."""
    monkeypatch.setattr(tsynth, "MIN_HITS", 3)
    monkeypatch.setattr(tsynth, "MAX_AGE", 10)
    full = tsynth.main([str(tmp_path / "full"), "--input", synth_video, "--device", "cpu",
                        "--no-zeroshot"])
    replay = tsynth.main([str(tmp_path / "replay"), "--input", synth_video, "--device", "cpu",
                          "--no-zeroshot", "--replay",
                          "--gt", str(tmp_path / "full" / "naive" / "dnn.csv")])
    assert (full.pop("route"), replay.pop("route")) == ("full", "replay")
    assert full == replay
    assert full["frames"] == FRAMES and "zeroshot_demo_weights" not in full
    assert _csvs(tmp_path / "full" / "cova") == _csvs(tmp_path / "replay" / "cova")
    for name in ("track", "dnn"):
        assert len((tmp_path / "full" / "cova" / f"{name}.csv").read_text().splitlines()) > 1


@pytest.mark.slow
def test_committed_render_is_rebuilt_byte_for_byte(tmp_path):
    csrc = REPO / "cova_tpu" / "csrc"
    subprocess.run(["make", "-s", "-C", str(csrc), "tools/encode_yuv"], check=True,
                   capture_output=True)
    out = _jax_example("make_synth").build_synth(str(tmp_path / "synth.mp4"), frames=1800,
                                                 seed=11)
    assert pathlib.Path(out).read_bytes() == VIDEO.read_bytes()
    recipe = VIDEO.parent / (VIDEO.name + ".recipe")
    assert pathlib.Path(out + ".recipe").read_text() == recipe.read_text()


class _CacheDirOnly:
    """`pathlib` for the JAX example with its fixed probability cache
    directory moved under the test's temporary directory."""

    def __init__(self, root):
        self.root = root

    def Path(self, p, *rest):
        return self.root if str(p) == "/tmp/cova_sweep_cache" else pathlib.Path(p, *rest)


@pytest.mark.slow
def test_full_clip_report(tmp_path):
    torch.set_num_threads(8)
    report = tsynth.main([str(tmp_path / "out"), "--replay", "--device", "cpu"])
    assert report == json.loads(REFERENCE.read_text())
    # The JAX package's sweep harness on the same render and ground truth.
    jsweep = _jax_example("sweep_accuracy")
    jsweep.pathlib = _CacheDirOnly(tmp_path / "jax_cache")
    jctx = jsweep.SweepContext(str(VIDEO), gt_csv=REPO / "golden" / "synth" / "dnn_gt.csv",
                               dataset="synth")
    for weights, row in ((tsynth.SYNTH_WEIGHTS, report),
                         (tsynth.DEMO_WEIGHTS, report["zeroshot_demo_weights"])):
        meta = load_meta_npz(weights)
        probs = jctx.probs(weights, use_nnz=bool(meta.get("use_nnz_channel", False)),
                           signed_mv=bool(meta.get("signed_mv", False)))
        cfg = jsweep.make_cfg(use_nnz=bool(meta.get("use_nnz_channel", False)),
                              **tsweep.OPERATING_POINTS["synth"])
        rep = jctx.run_config(probs, cfg)
        keys = [k for k in row if k in rep]
        assert {k: row[k] for k in keys} == {k: rep[k] for k in keys}
    # The committed TPU report's bands (tests/test_accuracy_golden.py) that
    # the float32 path meets on this render. It misses BP >= 0.98, GC <=
    # 1.7 and the zero-shot BP gap of 0.15 (0.9562, 1.756, 0.091): the
    # reference's own numbers (PERF.md, Findings).
    assert report["decode_filter_rate"] >= 0.65
    assert report["inference_filter_rate"] >= 0.98
    z = report["zeroshot_demo_weights"]
    assert z["bp_accuracy"] < report["bp_accuracy"]
    assert z["gc_error"] >= report["gc_error"] * 1.5

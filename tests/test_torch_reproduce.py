"""The PyTorch port's `reproduce_accuracy` against the JAX package's
examples/reproduce_accuracy.py on the CPU, on a 120-frame render of the
synth scene (examples/make_synth.py; the demo clip the script is made
for is not in the repository), with the JAX package's libavcodec
`PixelDecoder` handed to the port's modules that decode pixels (the
port's codec has none): the naive ground truth, the pipeline's CSVs and
the --holdout report equal, the split moved to 2 s in both scripts (the
windows of tests/test_accuracy_golden.py::TestGoldenMetricsHoldout on a
4 s clip).
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
from cova_tpu_torch.examples import reproduce_accuracy as treproduce
from cova_tpu_torch.pipeline import cova as tcova
from cova_tpu_torch.pipeline import naive as tnaive
from cova_tpu_torch.utils import dataset as tdataset

# The suite runs one test worker per core: keep torch to one thread each.
torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
CSVS = ("track", "dnn", "assoc", "stationary")
FRAMES = 120


def _jax_example(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


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


def _csvs(d):
    return {name: (pathlib.Path(d) / f"{name}.csv").read_bytes() for name in CSVS}


def test_reproduce_accuracy_holdout_matches_jax(synth_video, pixel_decoder, monkeypatch,
                                                tmp_path):
    """Every row of the report (whole clip, held-out suffix, prefix)."""
    jax_script = _jax_example("reproduce_accuracy")
    for mod in (treproduce, jax_script):
        monkeypatch.setattr(mod, "HOLDOUT_SPLIT_FRAMES", 60)
        monkeypatch.setattr(mod, "HOLDOUT_SPLIT_SECONDS", 2.0)
    report = treproduce.main([str(tmp_path / "torch"), "--input", synth_video, "--holdout",
                              "--device", "cpu"])
    monkeypatch.setattr(sys, "argv", ["reproduce_accuracy.py", str(tmp_path / "jax"),
                                      synth_video, "--holdout"])
    jax_script.main()
    ref = json.loads((tmp_path / "jax" / "report.json").read_text())
    assert report == ref
    assert json.loads((tmp_path / "torch" / "report.json").read_text()) == ref
    assert report["num_slots_holdout"] > 0 and report["num_slots_prefix"] > 0
    assert (tmp_path / "torch" / "naive" / "dnn.csv").read_bytes() == (
        tmp_path / "jax" / "naive" / "dnn.csv").read_bytes()
    assert _csvs(tmp_path / "torch" / "cova") == _csvs(tmp_path / "jax" / "cova")

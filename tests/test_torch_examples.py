"""The PyTorch port's accuracy CLIs against the JAX package's examples on
the CPU: `accuracy` and `run_experiment` (a JSON config with a directory of
ground-truth CSVs), the latter on a 120-frame render of the synth scene
(examples/make_synth.py) with the JAX package's libavcodec
`PixelDecoder` handed to the port's modules that decode pixels (the
port's codec has none). Outputs equal: printed lines, summaries, and
the aggregator CSVs byte for byte. The routes that decode pixels refuse
the port's own codec. (tests/test_torch_reproduce.py holds
`reproduce_accuracy` against JAX's, tests/test_torch_synth_report.py
`reproduce_synth`.)
"""

import importlib.util
import json
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

from cova_tpu.codec import PixelDecoder as JaxPixelDecoder
from cova_tpu_torch import codec as tcodec
from cova_tpu_torch.examples import accuracy as taccuracy
from cova_tpu_torch.examples import reproduce_accuracy as treproduce
from cova_tpu_torch.examples import reproduce_synth as tsynth
from cova_tpu_torch.examples import run_experiment as texperiment
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


@pytest.mark.parametrize("golden,extra", [
    ("synth", ["--region", "lower right"]),
    ("demo", []),
    ("demo2", ["--targets", "2,5", "--region", "upper right"]),
])
def test_accuracy_cli_matches_jax(golden, extra, monkeypatch, capsys):
    g = REPO / "golden" / golden
    duration = json.loads((g / "report.json").read_text()).get("duration_seconds", 60.0)
    argv = [str(g / "dnn_gt.csv"), str(g), str(duration)] + extra
    taccuracy.main(argv)
    got = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["accuracy.py"] + argv)
    _jax_example("accuracy").main()
    assert got == capsys.readouterr().out
    assert "slots evaluated:" in got


def _experiment(root, video, gt_dir):
    out = pathlib.Path(root)
    stem = pathlib.Path(video).stem
    (out / stem).mkdir(parents=True)
    # The stand-in oracle's background, so no run builds its own.
    shutil.copy(REPO / "artifacts" / "synth_bg.npy", out / stem / "background.npy")
    cfg = {
        "output_root": str(out),
        "dataset": "synth",
        "inputs": [{"path": video, "bus_area": 2500}],
        "ground_truth": str(gt_dir),
        "blobnet_weights": str(REPO / "artifacts" / "blobnet_synth.npz"),
        # One range: the 120-frame clip is one GoP.
        "cova": {"parallel": {"num_ranges": 1}, "sort": {"min_hits": 3, "max_age": 10}},
    }
    path = out.parent / f"{out.name}.json"
    path.write_text(json.dumps(cfg))
    return path, out / stem


def test_run_experiment_matches_jax(synth_video, pixel_decoder, monkeypatch, tmp_path):
    gt_dir = tmp_path / "gt"
    gt_dir.mkdir()
    # Any dnn.csv serves as <stem>.csv: both runs score against it.
    shutil.copy(REPO / "golden" / "synth" / "dnn_gt.csv", gt_dir / "synth.csv")
    tcfg, tout = _experiment(tmp_path / "torch", synth_video, gt_dir)
    jcfg, jout = _experiment(tmp_path / "jax", synth_video, gt_dir)
    summary = texperiment.main([str(tcfg), "--device", "cpu"])
    monkeypatch.setattr(sys, "argv", ["run_experiment.py", str(jcfg)])
    _jax_example("run_experiment").main()
    ref = json.loads((tmp_path / "jax" / "summary.json").read_text())
    for s in (summary, ref):
        for entry in s["inputs"]:
            entry.pop("elapsed_seconds")
    assert summary == ref
    assert "bp_accuracy" in summary["inputs"][0] and summary["mean"]
    assert _csvs(tout / "cova") == _csvs(jout / "cova")


def test_run_experiment_yaml(tmp_path, monkeypatch):
    cfg = {"output_root": "o", "inputs": ["a.mp4"], "cova": {"parallel": {"num_ranges": 2}}}
    (tmp_path / "e.json").write_text(json.dumps(cfg))
    (tmp_path / "e.yaml").write_text(
        "output_root: o\ninputs:\n  - a.mp4\ncova:\n  parallel: {num_ranges: 2}\n")
    assert texperiment.load_experiment(tmp_path / "e.json") == cfg
    assert texperiment.load_experiment(tmp_path / "e.yaml") == cfg
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(RuntimeError, match="write the config as JSON"):
        texperiment.load_experiment(tmp_path / "e.yaml")
    assert texperiment.load_experiment(tmp_path / "e.json") == cfg


def test_run_experiment_names_the_generator(tmp_path):
    cfg = {"output_root": str(tmp_path / "o"),
           "inputs": [{"path": str(tmp_path / "none.mp4"), "generate": "synth"}]}
    (tmp_path / "e.json").write_text(json.dumps(cfg))
    with pytest.raises(FileNotFoundError, match="make_synth.py"):
        texperiment.main([str(tmp_path / "e.json"), "--device", "cpu"])


def test_reproduce_accuracy_modes_exclude_each_other():
    with pytest.raises(SystemExit):
        treproduce.parser().parse_args(["--input", "x.mp4", "--tuned", "--holdout"])


@pytest.mark.parametrize("script,argv", [
    (treproduce, ["--holdout"]),
    (tsynth, []),
])
def test_pixel_routes_refuse_the_stub_decoder(script, argv, synth_video, tmp_path):
    """Without a pixel decoder (the port's own codec library) the routes
    that decode pixels refuse before any work; reproduce_synth names
    --replay."""
    with pytest.raises(RuntimeError, match="no pixel decoder") as info:
        script.main([str(tmp_path / "out"), "--input", synth_video, "--device", "cpu"]
                    + argv)
    if script is tsynth:
        assert "--replay" in str(info.value)
    assert not (tmp_path / "out" / "naive").exists()


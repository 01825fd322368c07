"""The committed 1080p render and the port's 1080p scripts
(`examples/reproduce_1080p.py`, `examples/fig8.py`) against the JAX
package's on the CPU.

* cova_tpu_torch/data/synth_1800_1080p.mp4 has the recipe's shape and
  sha256.
* On the heads of the render's first two GoPs (33 frames each), with the
  JAX package's libavcodec `PixelDecoder` handed to the port's modules
  that decode pixels (the port's codec has none): `reproduce_1080p`'s
  background, naive/dnn.csv, cova CSVs and report equal the JAX script's,
  whose report keys are read with ast; `fig8`'s row has the JAX row's
  keys and equal CSVs, detections and filter rates, and the artifact the
  JAX artifact's keys. Both run with chunks of 16 windows, and with
  trackers that retire tracks within the heads (below).
* Both scripts refuse to start with the port's own codec library.
* `-m slow`: the whole render at the scripts' own configuration.
"""

import ast
import functools
import hashlib
import importlib.util
import json
import pathlib
import sys

import jax
import numpy as np
import pytest
import torch

import cova_tpu.config as jcfg
import cova_tpu_torch.config as tcfg
from cova_tpu.codec import PixelDecoder as JaxPixelDecoder
from cova_tpu.models import blobnet as jbn
from cova_tpu_torch import codec as tcodec
from cova_tpu_torch.codec import Mp4Demuxer
from cova_tpu_torch.examples import fig8 as tfig8
from cova_tpu_torch.examples import reproduce_1080p as treproduce
from cova_tpu_torch.pipeline import cova as tcova
from cova_tpu_torch.pipeline import naive as tnaive
from cova_tpu_torch.utils import dataset as tdataset
from test_torch_bench import gop_heads

# The suite runs one test worker per core: keep torch to one thread each.
torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
RENDER = REPO / "cova_tpu_torch" / "data" / "synth_1800_1080p.mp4"
CSVS = ("track", "dnn", "assoc", "stationary")
# Windows a chunk in the cut runs (below).
F = 16
# Trackers that confirm and retire tracks within the heads' 30 windows a
# range (the defaults, 30 hits and 60 missed frames, retire none there).
MIN_HITS, MAX_AGE = 3, 10
# The row's keys that are not times.
ROW_VALUES = ("input", "path", "width", "height", "frames", "decode_filter_rate",
              "inference_filter_rate", "naive_detections", "weights", "cc_threshold")


def _jax_example(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _dict_keys(path, name):
    """The keys of the dict literal assigned to `name` in `path`."""
    tree = ast.parse(pathlib.Path(path).read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(getattr(t, "id", None) == name for t in node.targets)):
            return [k.value for k in node.value.keys]
    raise AssertionError(f"no dict {name} in {path}")


def _csvs(d):
    return {name: (pathlib.Path(d) / f"{name}.csv").read_bytes() for name in CSVS}


def test_render_matches_its_recipe():
    recipe = dict(line.split("=", 1) for line in
                  (RENDER.parent / (RENDER.name + ".recipe")).read_text().splitlines())
    assert hashlib.sha256(RENDER.read_bytes()).hexdigest() == recipe["sha256"]
    src = recipe["src"].split()
    assert src[0] == "synth_1800.mp4" and " ".join(src[1:]) == (
        RENDER.parent / "synth_1800.mp4.recipe").read_text()
    assert "scale=1920x1080" in recipe["build"] and "crf=23" in recipe["build"]
    d = Mp4Demuxer(str(RENDER))
    assert (d.width, d.height, d.num_samples) == (1920, 1080, 1800)
    assert (d.mb_width, d.mb_height) == (120, 68)
    assert [g.num_samples for g in d.gops()] == [250] * 7 + [50]


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """33 frames of each of the 1080p render's first two GoPs."""
    return gop_heads(RENDER, tmp_path_factory.mktemp("heads") / "heads1080.mp4", 33)


@pytest.fixture
def pixel_decoder(monkeypatch):
    for mod in (tcodec, tcova, tnaive, tdataset):
        monkeypatch.setattr(mod, "PixelDecoder", JaxPixelDecoder)


@pytest.fixture
def short_chunks(monkeypatch):
    """Both packages' CompressedStageConfig with chunks of F=16 windows
    (not 128) for the scripts: BlobNet then runs on the clip's 30 windows
    a range and little padding, not on 128 windows a range, on one CPU
    thread a test worker. A window's mask and what the trackers see do
    not depend on the chunking."""
    for mod in (jcfg, tcfg):
        monkeypatch.setattr(mod, "CompressedStageConfig",
                            functools.partial(mod.CompressedStageConfig, batch_frames=F))


@pytest.fixture
def short_tracks(monkeypatch):
    """Both packages' CovaConfig with the trackers above, for fig8 (it
    sets no tracker knobs)."""
    for mod in (jcfg, tcfg):
        monkeypatch.setattr(mod, "CovaConfig", functools.partial(
            mod.CovaConfig, sort=mod.SortConfig(min_hits=MIN_HITS, max_age=MAX_AGE)))


@pytest.fixture(autouse=True)
def shape_only_jax_init(monkeypatch):
    """The JAX scripts' load_artifact on a template built shape-only: an
    eager Flax init costs dozens of small compiles; the loaded weights
    are the same."""
    def create_blobnet(rng, config=jbn.BlobNetConfig(), dtype=jax.numpy.float32):
        model = jbn.BlobNet(config, dtype)
        dummy = jax.numpy.zeros((1, config.timestep, 45, 80, config.in_channels))
        return model, jax.eval_shape(lambda: model.init(rng, dummy, train=False))

    monkeypatch.setattr(jbn, "create_blobnet", create_blobnet)


def _jax_reproduce(video, out, monkeypatch, knobs):
    """The JAX script on `video` (its build_1080p() answers with it), its
    background built into out's parent rather than into artifacts/."""
    import examples.make_dataset2 as make_dataset2

    script = _jax_example("reproduce_1080p")
    monkeypatch.setattr(make_dataset2, "build_1080p", lambda: str(video))
    monkeypatch.setattr(script, "BG_PATH", pathlib.Path(out).parent / "jax_bg.npy")
    monkeypatch.delenv("COVA_1080_WEIGHTS", raising=False)
    monkeypatch.setattr(sys, "argv", ["reproduce_1080p.py", str(out)] + knobs)
    script.main()
    return json.loads((pathlib.Path(out) / "report.json").read_text())


def _check_reproduce(video, tmp_path, monkeypatch, knobs=()):
    knobs = list(knobs)
    report = treproduce.main([str(tmp_path / "torch"), "--input", str(video), "--device", "cpu"]
                             + knobs)
    ref = _jax_reproduce(video, tmp_path / "jax", monkeypatch, knobs)
    assert list(report) == list(ref) == _dict_keys(REPO / "examples" / "reproduce_1080p.py",
                                                   "report")
    assert report == ref
    assert json.loads((tmp_path / "torch" / "report.json").read_text()) == ref
    assert np.array_equal(np.load(tmp_path / "torch" / "background.npy"),
                          np.load(tmp_path / "jax_bg.npy"))
    assert (tmp_path / "torch" / "naive" / "dnn.csv").read_bytes() == (
        tmp_path / "jax" / "naive" / "dnn.csv").read_bytes()
    assert _csvs(tmp_path / "torch" / "cova") == _csvs(tmp_path / "jax" / "cova")
    assert report["resolution"] == "1920x1080 (120x68 MB grid)"
    assert report["weights"] == "blobnet_demo1080.npz"
    assert (report["cc_threshold"], report["mask_threshold"]) == (7, 0.6)
    return report


def test_reproduce_1080p_matches_jax(clip, pixel_decoder, short_chunks, tmp_path, monkeypatch):
    report = _check_reproduce(clip, tmp_path, monkeypatch,
                              ["--minhits", str(MIN_HITS), "--maxage", str(MAX_AGE)])
    assert report["frames"] == 66 and report["num_slots"] > 0
    assert (report["min_hits"], report["max_age"]) == (MIN_HITS, MAX_AGE)
    assert report["dead_tracks"] > 0 and report["inference_filter_rate"] < 1


def _check_fig8_row(video, tmp_path):
    row = tfig8.run_input("clip", video, tmp_path / "torch", "cpu")
    ref = _jax_example("fig8").run_input("clip", str(video), str(tmp_path / "jax"))
    assert list(row) == list(ref) == _dict_keys(REPO / "examples" / "fig8.py", "row")
    assert {k: row[k] for k in ROW_VALUES} == {k: ref[k] for k in ROW_VALUES}
    assert row["naive_s"] > 0 and row["cova_s"] > 0 and len(row["cpu_calib_mips"]) == 2
    for side in ("naive", "cova"):
        names = ("dnn",) if side == "naive" else CSVS
        for name in names:
            assert (tmp_path / "torch" / "clip" / side / f"{name}.csv").read_bytes() == (
                tmp_path / "jax" / "clip" / side / f"{name}.csv").read_bytes(), (side, name)
    return row


def test_fig8_row_matches_jax(clip, pixel_decoder, short_chunks, short_tracks, tmp_path):
    row = _check_fig8_row(clip, tmp_path)
    assert row["frames"] == 66 and row["naive_detections"] > 0
    assert row["inference_filter_rate"] < 1
    assert (row["weights"], row["cc_threshold"]) == ("blobnet_demo1080.npz", 7)


def test_fig8_artifact_has_the_jax_keys(pixel_decoder, monkeypatch, tmp_path):
    monkeypatch.setattr(tfig8, "run_input",
                        lambda label, video, work, device: {"input": label, "path": video})
    out = tmp_path / "fig8.json"
    art = tfig8.main(["--inputs", f"{RENDER},{RENDER}", "--out", str(out),
                      "--work", str(tmp_path / "w"), "--device", "cpu"])
    assert list(art) == _dict_keys(REPO / "examples" / "fig8.py", "artifact")
    assert json.loads(out.read_text()) == art
    assert [r["input"] for r in art["rows"]] == ["synth_1800_1080p"] * 2
    assert "the CPU" in art["description"] and "TPU" not in art["description"]


@pytest.mark.parametrize("script,argv", [
    (treproduce, ["OUT", "--input", str(RENDER)]),
    (tfig8, ["--inputs", str(RENDER), "--work", "OUT", "--out", "OUT/fig8.json"]),
], ids=("reproduce_1080p", "fig8"))
def test_scripts_refuse_the_stub_decoder(script, argv, tmp_path):
    argv = [a.replace("OUT", str(tmp_path / "out")) for a in argv]
    with pytest.raises(RuntimeError, match="no pixel decoder.*pixdec_stub"):
        script.main(argv + ["--device", "cpu"])
    assert not (tmp_path / "out").exists()


@pytest.mark.slow
def test_whole_render_matches_jax(pixel_decoder, tmp_path, monkeypatch):
    """The committed render at the scripts' own configuration (4 ranges,
    F=128): reproduce_1080p's report and CSVs, then fig8's row."""
    report = _check_reproduce(RENDER, tmp_path / "reproduce", monkeypatch)
    assert report["frames"] == 1800
    row = _check_fig8_row(RENDER, tmp_path / "fig8")
    assert (row["decode_filter_rate"], row["inference_filter_rate"]) == (
        report["decode_filter_rate"], report["inference_filter_rate"])

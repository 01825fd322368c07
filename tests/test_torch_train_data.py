"""BlobNet training sets in the PyTorch port, on the CPU, against the JAX
package.

The port's codec library carries no pixel decoder (it builds
csrc/pixdec_stub.cc, without libavcodec); as in
tests/test_torch_oracle_pipeline.py, these tests hand the port's dataset
module the JAX package's `PixelDecoder`, the same shared C++ built with
libavcodec. On a 120-frame render of the synth scene
(examples/make_synth.py):

* `build_training_set` gives windows and MOG2 labels byte-equal to the
  JAX package's (entropy decode, packing, the labels from the port's
  plain MOG2 on the CPU, the sliding);
* `augment_training_set` and `ArrayDataset` equal JAX's.

tests/test_torch_train_cli.py drives the training CLIs on the same
render.
"""

import importlib.util
import pathlib
import subprocess

import numpy as np
import pytest
import torch

from cova_tpu.codec import PixelDecoder as JaxPixelDecoder
from cova_tpu.utils import dataset as jdataset
from cova_tpu_torch.utils import dataset as tdataset

# The suite runs one test worker per core: keep torch to one thread each.
torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
FRAMES = 120


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
    """The JAX package's libavcodec PixelDecoder in the port's dataset
    module."""
    monkeypatch.setattr(tdataset, "PixelDecoder", JaxPixelDecoder)


def test_build_training_set_matches_jax(synth_video, pixel_decoder, tmp_path):
    quiet = dict(log=lambda *_: None, use_nnz=True, signed_mv=True)
    x, y = tdataset.build_training_set(synth_video, out_path=str(tmp_path / "t.npz"),
                                       device="cpu", **quiet)
    jx, jy = jdataset.build_training_set(synth_video, **quiet)
    assert x.dtype == jx.dtype == np.uint8 and y.dtype == jy.dtype == np.uint8
    assert x.shape == jx.shape == (FRAMES // 4, 4, 45, 80, 4)
    assert x.tobytes() == jx.tobytes()
    assert y.tobytes() == jy.tobytes()
    assert 0 < y.mean() < 0.5  # the scene's movers are labelled
    with np.load(tmp_path / "t.npz") as saved:
        assert saved["x"].tobytes() == x.tobytes() and saved["y"].tobytes() == y.tobytes()

    ax, ay = tdataset.augment_training_set(x, y, signed_mv=True)
    jax_, jay = jdataset.augment_training_set(x, y, signed_mv=True)
    assert ax.tobytes() == jax_.tobytes() and ay.tobytes() == jay.tobytes()
    got = list(tdataset.ArrayDataset(ax, ay, batch=4, seed=2))
    ref = list(jdataset.ArrayDataset(ax, ay, batch=4, seed=2))
    assert len(got) == len(ref) == len(ax) // 4
    for (bx, by), (rx, ry) in zip(got, ref):
        assert bx.dtype == np.float32 and np.array_equal(bx, rx) and np.array_equal(by, ry)

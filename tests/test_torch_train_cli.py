"""The PyTorch port's training CLIs, on the CPU.

The port's codec library carries no pixel decoder (it builds
csrc/pixdec_stub.cc, without libavcodec); as in
tests/test_torch_oracle_pipeline.py, these tests hand the port's dataset
module the JAX package's `PixelDecoder`, the same shared C++ built with
libavcodec. On a 120-frame render of the synth scene
(examples/make_synth.py):

* `python -m cova_tpu_torch.examples.train_blobnet --device cpu` builds,
  trains an epoch and writes weights the JAX package loads, and
  `finetune_augment --device cpu` fine-tunes them from the cached
  training set;
* `finetune_augment`'s `--extra` takes its value away from the
  positionals (the JAX example's argv scan did not).
"""

import importlib.util
import pathlib
import subprocess

import pytest
import torch

from cova_tpu.codec import PixelDecoder as JaxPixelDecoder
from cova_tpu.models import blobnet as jbn
from cova_tpu_torch.examples import finetune_augment, train_blobnet
from cova_tpu_torch.models import blobnet as tbn
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


def test_training_clis_run_on_the_cpu(synth_video, pixel_decoder, tmp_path, capsys):
    ckpt = tmp_path / "ckpt"
    train_blobnet.main([synth_video, str(ckpt), "1", "60", "--nnz", "--signed",
                        "--device", "cpu"])
    out = capsys.readouterr().out
    assert "best epoch: 0" in out and (ckpt / "dataset.npz").exists()
    state = torch.load(ckpt / "final" / "state.pt")["state_dict"]
    _, sd, meta = tbn.load_artifact(ckpt / "weights.npz", "cpu")
    assert meta == {"in_channels": 4, "signed_mv": True, "use_nnz_channel": True}
    for k, v in state.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(sd[k], v), k
    jbn.load_artifact(str(ckpt / "weights.npz"))  # the JAX package reads it

    tuned = tmp_path / "tuned.npz"
    finetune_augment.main([str(ckpt / "weights.npz"), str(tuned), "--dataset",
                           str(ckpt / "dataset.npz"), "--epochs", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "ft epoch 0:" in out and "augmented dataset x (60, 4, 45, 80, 4)" in out
    tuned_meta = tbn.load_meta_npz(tuned)
    assert tuned_meta["signed_mv"] and "fine-tune lr 1e-4" in tuned_meta["trained_on"]


@pytest.mark.parametrize(
    "argv,video,epochs,extra",
    [
        (["b.npz", "o.npz", "--extra", "x.mp4"], None, 6, ["x.mp4"]),
        (["b.npz", "o.npz", "v.mp4", "--extra", "x.mp4", "--epochs", "2"], "v.mp4", 2,
         ["x.mp4"]),
        (["b.npz", "o.npz", "--extra", "x.mp4", "v.mp4", "--extra", "y.mp4"], "v.mp4", 6,
         ["x.mp4", "y.mp4"]),
    ],
)
def test_finetune_extra_takes_its_value(argv, video, epochs, extra):
    args = finetune_augment.parser().parse_intermixed_args(argv)
    assert (args.base, args.out, args.video, args.epochs, args.extra) == (
        "b.npz", "o.npz", video, epochs, extra)


def test_finetune_needs_a_video_or_a_dataset():
    with pytest.raises(SystemExit):
        finetune_augment.main(["b.npz", "o.npz", "--device", "cpu"])
    with pytest.raises(SystemExit):
        finetune_augment.main(["b.npz", "o.npz", "v.mp4", "--dataset", "d.npz"])

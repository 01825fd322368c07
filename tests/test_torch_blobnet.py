"""Parity of the PyTorch BlobNet with the Flax one: every committed weight
artifact converted by `convert_flax_variables`, the same seeded input
through both, probabilities within 1e-5 (float32 sums in another order),
on the 720p, interlaced-720p and 1080p macroblock grids."""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cova_tpu.models import blobnet as jbn
from cova_tpu_torch.models import blobnet as tbn

# The suite runs one test worker per core: keep torch to one thread each.
torch.set_num_threads(1)

ARTIFACTS = pathlib.Path(__file__).resolve().parent.parent / "artifacts"
NAMES = ["blobnet_demo", "blobnet_demo1080", "blobnet_demo_holdout", "blobnet_synth"]
TOL = 1e-5


def _input(h, w, c, seed=0):
    rng = np.random.default_rng(seed)
    # Normalized metadata: mb_class in [0, 1], signed MVs in [-1, 1].
    return rng.uniform(-1.0, 1.0, size=(2, 4, h, w, c)).astype(np.float32)


def _both(name, h, w):
    path = ARTIFACTS / f"{name}.npz"
    jmodel, jvars, jmeta = jbn.load_artifact(str(path))
    tmodel, _, tmeta = tbn.load_artifact(path, "cpu")
    assert tmeta == jmeta
    x = _input(h, w, int(jmeta["in_channels"]))
    ref = np.asarray(jmodel.apply(jvars, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x)).numpy()
    return got, ref


@pytest.mark.parametrize("name", NAMES)
def test_artifact_conversion_matches_flax(name):
    got, ref = _both(name, 45, 80)
    assert got.shape == ref.shape == (2, 45, 80)
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)


@pytest.mark.parametrize("h,w", [(46, 80), (68, 120)])
def test_grids_match_flax(h, w):
    got, ref = _both("blobnet_demo", h, w)
    assert got.shape == (2, h, w)
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)


def test_conversion_fills_every_parameter_and_meta_sets_channels():
    with np.load(ARTIFACTS / "blobnet_demo.npz") as data:
        arrays = {k: data[k] for k in data.files}
    sd = tbn.convert_flax_variables(arrays)
    model = tbn.BlobNet(tbn.BlobNetConfig(in_channels=4))
    assert set(sd) == set(model.state_dict())
    # The ConvTranspose kernel is spatially flipped into (in, out, kh, kw).
    k = arrays["params/ConvTranspose_0/kernel"]
    np.testing.assert_array_equal(
        sd["dec_convt.0.weight"].numpy(), k[::-1, ::-1].transpose(2, 3, 0, 1)
    )
    _, _, meta = tbn.load_artifact(ARTIFACTS / "blobnet_demo.npz", "cpu")
    assert meta["in_channels"] == 4 and meta["signed_mv"] and meta["use_nnz_channel"]


def test_random_init_is_seeded():
    a, b = tbn.BlobNet(), tbn.BlobNet()
    a.reset_parameters(torch.Generator().manual_seed(0))
    b.reset_parameters(torch.Generator().manual_seed(0))
    for (n, pa), pb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(pa, pb), n
    x = torch.from_numpy(_input(45, 80, 3))
    with torch.no_grad():
        p = a(x)
    assert p.shape == (2, 45, 80) and bool(torch.isfinite(p).all())

"""Parity of the PyTorch port's metadata preprocessing with the JAX
package: the same seeded u8 metadata through both, outputs equal (the
normalization is the same float32 clip and divide in both)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cova_tpu.ops import preprocess as jpre
from cova_tpu_torch.ops import preprocess as tpre

# The suite runs one test worker per core: keep torch to one thread each.
torch.set_num_threads(1)

COMBOS = [(s, n) for s in (False, True) for n in (False, True)]


@pytest.mark.parametrize("signed_mv,use_nnz", COMBOS)
@pytest.mark.parametrize("gamma", [1, 2])
def test_wire16_metapreprocess_matches_jax(signed_mv, use_nnz, gamma):
    rng = np.random.default_rng(7)
    t = 4
    wire = rng.integers(0, 256, size=(2, 13, 5, 8, 2), dtype=np.uint8)

    def jax_ref(x):
        chans = jpre.unpack_wire16(x, use_nnz, signed_mv)
        return jax.vmap(lambda m: jpre.metapreprocess(m, t, gamma, signed_mv))(chans)

    ref = np.asarray(jax_ref(jnp.asarray(wire)))
    chans = tpre.unpack_wire16(torch.from_numpy(wire), use_nnz, signed_mv)
    np.testing.assert_array_equal(
        chans.numpy(), np.asarray(jpre.unpack_wire16(jnp.asarray(wire), use_nnz, signed_mv))
    )
    got = tpre.metapreprocess(chans, t, gamma, signed_mv).numpy()
    assert got.shape == ref.shape == (2, (13 - t) // gamma + 1, t, 5, 8, 4 if use_nnz else 3)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("signed_mv", [False, True])
def test_clip6_normalize_full_byte_range(signed_mv):
    x = np.arange(256, dtype=np.uint8).reshape(1, 64, 4)
    ref = np.asarray(jpre.clip6_normalize(jnp.asarray(x), signed_mv))
    got = tpre.clip6_normalize(torch.from_numpy(x), signed_mv).numpy()
    np.testing.assert_array_equal(got, ref)


def test_temporal_stack_newest_first():
    frames = np.arange(9, dtype=np.uint8).reshape(9, 1, 1, 1)
    got = tpre.temporal_stack(torch.from_numpy(frames), 4, 2).numpy()
    np.testing.assert_array_equal(got, np.asarray(jpre.temporal_stack(jnp.asarray(frames), 4, 2)))
    assert got[:, :, 0, 0, 0].tolist() == [[3, 2, 1, 0], [5, 4, 3, 2], [7, 6, 5, 4]]

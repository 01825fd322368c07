"""Class-aware NMS in the PyTorch port against the JAX package.

The plain `batched_nms` must give JAX's four outputs exactly (boxes,
scores, classes, valid flags, bit for bit) on seeded cases: 512
candidates over 80 classes, 512 over 2 classes crowded into one corner
(heavy overlap, few survivors), exact score ties, every score below the
threshold, and fewer candidates than output slots. On the CPU the batched
wrapper runs the plain version image by image. The CUDA kernel itself is
held against the plain version, bit for bit, by the tests marked `cuda`,
which skip without a card (run them there with
`python -m pytest tests/test_torch_nms.py -m cuda`)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cova_tpu.ops.nms import batched_nms as jax_batched_nms
from cova_tpu_torch.ops.cuda.nms_kernel import nms, nms_plain
from cova_tpu_torch.ops.nms import batched_nms

# The suite runs one test worker per core: keep torch to one thread each.
torch.set_num_threads(1)


def _case(seed, n, classes, spread=600.0, ties=False, top=1.0):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, spread, (n, 2))
    wh = rng.uniform(8, 120, (n, 2))
    ltwh = np.concatenate([xy, wh], 1).astype(np.float32)
    scores = rng.uniform(0, top, n).astype(np.float32)
    if ties:
        scores = (np.round(scores * 8) / 8).astype(np.float32)
    cls = rng.integers(0, classes, n).astype(np.int32)
    return ltwh, scores, cls


CASES = {
    "n512_c80": lambda: _case(0, 512, 80),
    "n512_c2_overlap": lambda: _case(1, 512, 2, spread=60.0),
    "n512_c80_ties": lambda: _case(2, 512, 80, ties=True),
    "n512_c2_ties_overlap": lambda: _case(3, 512, 2, spread=120.0, ties=True),
    "n512_all_below": lambda: _case(4, 512, 80, top=0.25),
    "n40_c3": lambda: _case(5, 40, 3),
}


@pytest.mark.parametrize("score_threshold", [0.25, 0.0])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_nms_matches_jax(case, score_threshold):
    ltwh, scores, cls = CASES[case]()
    ref = [np.asarray(a) for a in jax_batched_nms(
        jnp.asarray(ltwh), jnp.asarray(scores), jnp.asarray(cls), 0.2,
        score_threshold, 64)]
    got = [a.numpy() for a in batched_nms(
        torch.from_numpy(ltwh), torch.from_numpy(scores), torch.from_numpy(cls), 0.2,
        score_threshold, 64)]
    for g, r, name in zip(got, ref, ("ltwh", "scores", "classes", "valid")):
        assert g.dtype == r.dtype and g.shape == r.shape, name
        np.testing.assert_array_equal(g, r, err_msg=name)
    kept = int(ref[3].sum())
    if case == "n512_all_below" and score_threshold > 0:
        assert kept == 0
    else:
        assert kept > 0
    if case == "n512_c2_overlap":
        assert kept < 64  # suppression, not the slot count, bounds it


def test_wrapper_runs_plain_per_image_on_cpu():
    parts = [CASES[c]() for c in ("n512_c80", "n512_c2_overlap", "n512_c80_ties")]
    ltwh, scores, cls = (torch.from_numpy(np.stack(x)) for x in zip(*parts))
    before = nms.launches
    got = nms(ltwh, scores, cls, 0.2, 0.25, 64)
    assert nms.launches == before  # the CPU runs no kernel
    assert [tuple(a.shape) for a in got] == [(3, 64, 4), (3, 64), (3, 64), (3, 64)]
    for i in range(3):
        ref = batched_nms(ltwh[i], scores[i], cls[i], 0.2, 0.25, 64)
        for g, r in zip(got, ref):
            assert torch.equal(g[i], r)


def test_wrapper_rejects_bad_input():
    ltwh, scores, cls = (torch.from_numpy(a[None]) for a in CASES["n40_c3"]())
    with pytest.raises(ValueError):
        nms(ltwh[0], scores[0], cls[0])
    with pytest.raises(ValueError):
        nms(ltwh, scores[:, :10], cls)
    with pytest.raises(TypeError):
        nms(ltwh, scores, cls.long())
    with pytest.raises(TypeError):
        nms(ltwh.double(), scores, cls)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("score_threshold", [0.25, 0.0])
def test_cuda_kernel_matches_plain(cuda_device, score_threshold):
    parts = [CASES[c]() for c in sorted(CASES) if c != "n40_c3"]
    ltwh, scores, cls = (torch.from_numpy(np.stack(x)).to(cuda_device) for x in zip(*parts))
    before = nms.launches
    got = nms(ltwh, scores, cls, 0.2, score_threshold, 64)
    torch.cuda.synchronize()
    assert nms.launches == before + 1
    ref = nms_plain(ltwh, scores, cls, 0.2, score_threshold, 64)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and torch.equal(g, r)
    small = [torch.from_numpy(a[None]).to(cuda_device) for a in CASES["n40_c3"]()]
    for g, r in zip(nms(*small, 0.2, score_threshold, 64),
                    nms_plain(*small, 0.2, score_threshold, 64)):
        assert torch.equal(g, r)

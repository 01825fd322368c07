"""Class-aware NMS in the PyTorch port against the JAX package.

The plain `batched_nms` must give JAX's four outputs exactly (boxes,
scores, classes, valid flags, bit for bit) on seeded cases: 512
candidates over 80 classes, 512 over 2 classes crowded into one corner
(heavy overlap, few survivors), exact score ties, every score below the
threshold, and fewer candidates than output slots; and a smaller max_out
must keep a prefix of the outputs (the kernel's scan stops there). On the
CPU the batched wrapper runs the plain version image by image. The CUDA
kernel itself is held against the plain version, bit for bit and three
launches a case, by the tests marked `cuda`, which skip without a card
(run them there with `python -m pytest tests/test_torch_nms.py -m cuda`)."""

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


@pytest.mark.parametrize("max_out", [1, 8, 64])
@pytest.mark.parametrize("score_threshold", [0.25, 0.0])
@pytest.mark.parametrize("case", sorted(CASES))
def test_max_out_keeps_a_prefix(case, score_threshold, max_out):
    """The early exit the kernel relies on: the first max_out survivors in
    index order do not depend on max_out, so a scan may stop at the
    max_out-th kept box. At max_out=8 the outputs also equal JAX's."""
    ltwh, scores, cls = CASES[case]()
    args = (torch.from_numpy(ltwh), torch.from_numpy(scores), torch.from_numpy(cls), 0.2,
            score_threshold)
    full = batched_nms(*args, max(len(scores), max_out))
    got = batched_nms(*args, max_out)
    for g, f in zip(got, full):
        assert torch.equal(g, f[:max_out])
    if max_out == 8:
        ref = jax_batched_nms(jnp.asarray(ltwh), jnp.asarray(scores), jnp.asarray(cls), 0.2,
                              score_threshold, max_out)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))


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


def _check_cuda(args, score_threshold, max_out):
    """The kernel against the plain version, three times (a race would
    show as a difference between launches)."""
    ref = nms_plain(*args, 0.2, score_threshold, max_out)
    for _ in range(3):
        before = nms.launches
        got = nms(*args, 0.2, score_threshold, max_out)
        torch.cuda.synchronize()
        assert nms.launches == before + 1
        for g, r in zip(got, ref):
            assert g.dtype == r.dtype and torch.equal(g, r)


@pytest.mark.cuda
@pytest.mark.parametrize("max_out", [1, 8, 64, 512])
@pytest.mark.parametrize("score_threshold", [0.25, 0.0])
def test_cuda_kernel_matches_plain(cuda_device, score_threshold, max_out):
    """The five N=512 images as one batch (B=5), and N=40 alone."""
    parts = [CASES[c]() for c in sorted(CASES) if c != "n40_c3"]
    batch = [torch.from_numpy(np.stack(x)).to(cuda_device) for x in zip(*parts)]
    _check_cuda(batch, score_threshold, max_out)
    small = [torch.from_numpy(a[None]).to(cuda_device) for a in CASES["n40_c3"]()]
    _check_cuda(small, score_threshold, max_out)


@pytest.mark.cuda
@pytest.mark.parametrize("max_out", [1, 8, 64, 512])
@pytest.mark.parametrize("n", [1, 33, 40, 512, 1024])
def test_cuda_kernel_candidate_counts(cuda_device, n, max_out):
    """Candidate counts across the 32-bit words of the mask, unsorted and
    already sorted (the oracle's order, the kernel's fast path)."""
    ltwh, scores, cls = _case(30 + n, n, 3, spread=40.0 * np.sqrt(n))
    order = np.argsort(-scores, kind="stable")
    for arrays in ((ltwh, scores, cls), (ltwh[order], scores[order], cls[order])):
        args = [torch.from_numpy(a[None]).to(cuda_device) for a in arrays]
        for thr in (0.25, 0.0):
            _check_cuda(args, thr, max_out)


@pytest.mark.cuda
def test_cuda_kernel_dead_and_signed_zero_scores(cuda_device):
    """Every candidate dead, and scores of -0.0 and 0.0 (equal in torch's
    stable sort) mixed with ties."""
    ltwh, _, cls = _case(40, 512, 4, spread=120.0)
    zeros = np.zeros(512, np.float32)
    mixed = np.where(np.arange(512) % 3 == 0, np.float32(-0.0), np.float32(0.5))
    for scores in (zeros, mixed.astype(np.float32)):
        args = [torch.from_numpy(a[None]).to(cuda_device) for a in (ltwh, scores, cls)]
        for thr in (0.25, 0.0, -1.0):
            _check_cuda(args, thr, 64)

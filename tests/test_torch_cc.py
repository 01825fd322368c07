"""Connected components in the PyTorch port against the JAX package.

On the CPU the wrapper runs its plain version, which must give the TPU
kernel's labels exactly (the Pallas kernel runs in interpret mode here)
and scipy's 8-connected labels mapped to each component's minimum raster
index (the convention the CUDA union-find relies on); `mask_to_boxes`
must give the JAX op's boxes exactly. The CUDA kernel itself is held
against the plain version, three launches a case, by the tests marked
`cuda`, which skip without a card (run them there with
`python -m pytest tests/test_torch_cc.py -m cuda`)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage
import torch

from cova_tpu.ops.cc import connected_components as jax_connected_components
from cova_tpu.ops.cc import mask_to_boxes as jax_mask_to_boxes
from cova_tpu.ops.pallas.cc_kernel import connected_components_pallas
from cova_tpu_torch.ops.cc import mask_to_boxes
from cova_tpu_torch.ops.cuda.cc_kernel import (
    connected_components,
    connected_components_plain,
)

# The suite runs one test worker per core: keep torch to one thread each.
torch.set_num_threads(1)


def _spiral(h=45, w=80):
    mask = np.zeros((h, w), bool)
    mask[0, :] = True
    mask[:, w - 1] = True
    mask[h - 1, 2:] = True
    mask[4:h, 2] = True
    mask[4, 2 : w - 10] = True
    return mask


def _random(shape, p, seed):
    return np.random.default_rng(seed).uniform(size=shape) < p


def _checkerboard(h=45, w=80):
    """One component joined only through diagonals."""
    r, c = np.indices((h, w))
    return (r + c) % 2 == 0


def _comb(h=45, w=80):
    """Teeth on every other column joined only by the bottom row: the
    comb's label, pixel 0, reaches most teeth through the far end."""
    mask = np.zeros((h, w), bool)
    mask[:, ::2] = True
    mask[h - 1, :] = True
    return mask


def _serpentine(h=45, w=80):
    """Every even row set, the odd rows joined at alternating ends: one
    component that winds through the whole frame. Labelling it takes far
    more than 32 sweeps of neighbour minima (the fixed count of the JAX
    package's CPU path, which leaves it in pieces); the TPU kernel and
    the port sweep until nothing changes."""
    mask = np.zeros((h, w), bool)
    mask[::2, :] = True
    mask[1::4, w - 1] = True
    mask[3::4, 0] = True
    return mask


CASES = {
    "random_45x80_p0.05": lambda: _random((4, 45, 80), 0.05, 0),
    "random_45x80_p0.3": lambda: _random((4, 45, 80), 0.3, 1),
    "random_46x80_p0.6": lambda: _random((2, 46, 80), 0.6, 2),
    "random_68x120_p0.3": lambda: _random((2, 68, 120), 0.3, 3),
    "spiral": lambda: _spiral()[None],
    "serpentine": lambda: _serpentine()[None],
    "serpentine_68x120": lambda: _serpentine(68, 120)[None],
    "empty_and_full": lambda: np.stack([np.zeros((45, 80), bool), np.ones((45, 80), bool)]),
}


# The union-find kernel's own edge cases: chains only through diagonals,
# components rooted far from most of their pixels, single rows and columns.
EDGE_CASES = {
    **{f"random_{h}x{w}_p{p}": (lambda h=h, w=w, p=p, s=s: _random((2, h, w), p, s))
       for s, (h, w, p) in enumerate([(45, 80, 0.05), (45, 80, 0.3), (45, 80, 0.6),
                                      (68, 120, 0.05), (68, 120, 0.3), (68, 120, 0.6)])},
    "checkerboard": lambda: _checkerboard()[None],
    "comb": lambda: _comb()[None],
    "row_1x80": lambda: _random((4, 1, 80), 0.6, 21),
    "column_45x1": lambda: _random((4, 45, 1), 0.6, 22),
    "full_68x120": lambda: np.ones((1, 68, 120), bool),
}


def _min_root_labels(masks):
    """scipy's 8-connected labelling, each component relabelled with its
    minimum raster index; background H*W."""
    out = np.empty(masks.shape, np.int32)
    for b, m in enumerate(masks):
        lab, k = scipy.ndimage.label(m, structure=np.ones((3, 3)))
        flat = lab.reshape(-1)
        first = np.full(k + 1, m.size, np.int64)
        np.minimum.at(first, flat, np.arange(flat.size))
        first[0] = m.size
        out[b] = first[lab]
    return out


@pytest.mark.parametrize("case", sorted(EDGE_CASES))
def test_plain_labels_are_min_roots(case):
    """The convention the union-find kernel relies on: the label is the
    component's minimum raster index (scipy.ndimage.label, 8-connected)."""
    masks = EDGE_CASES[case]()
    got = connected_components(torch.from_numpy(masks)).numpy()
    np.testing.assert_array_equal(got, _min_root_labels(masks))


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_labels_match_pallas(case):
    masks = CASES[case]()
    ref = np.asarray(connected_components_pallas(jnp.asarray(masks), interpret=True))
    before = connected_components.launches
    got = connected_components(torch.from_numpy(masks))
    assert connected_components.launches == before  # the CPU runs no kernel
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("h,w", [(45, 80), (46, 80), (68, 120)])
def test_serpentine_is_one_component_where_32_sweeps_leave_pieces(h, w):
    """The port follows the TPU kernel (sweeps until nothing changes),
    not the JAX package's CPU path of 32 fixed sweeps: the two differ on
    this mask, so a JAX CPU run is an oracle for the port's labels only
    where its 32 sweeps have converged."""
    mask = _serpentine(h, w)
    lab = connected_components_plain(torch.from_numpy(mask[None]))[0].numpy()
    assert set(np.unique(lab[mask]).tolist()) == {0}
    assert (lab[~mask] == mask.size).all()
    fixed = np.asarray(jax_connected_components(jnp.asarray(mask), 32))
    assert len(np.unique(fixed[mask])) > 1


def test_spiral_is_one_component_rooted_at_raster_first_pixel():
    mask = _spiral()
    lab = connected_components_plain(torch.from_numpy(mask[None]))[0].numpy()
    assert set(np.unique(lab[mask]).tolist()) == {0}
    assert (lab[~mask] == mask.size).all()


@pytest.mark.parametrize("area_threshold", [1, 3])
@pytest.mark.parametrize("p", [0.05, 0.2])
def test_mask_to_boxes_matches_jax(area_threshold, p):
    masks = _random((2, 3, 45, 80), p, 11)
    ref = jax_mask_to_boxes(jnp.asarray(masks), area_threshold, backend="xla")
    got = mask_to_boxes(torch.from_numpy(masks), area_threshold)
    assert got.valid.shape == (2, 3, 32)
    for name in ("ltwh", "valid", "area", "class_id", "conf", "track_id"):
        np.testing.assert_array_equal(
            getattr(got, name).numpy(), np.asarray(getattr(ref, name)), err_msg=name
        )
    assert int(got.valid.sum()) > 0


def test_wrapper_rejects_bad_input():
    with pytest.raises(ValueError):
        connected_components(torch.zeros((45, 80), dtype=torch.bool))
    with pytest.raises(TypeError):
        connected_components(torch.zeros((1, 45, 80), dtype=torch.float32))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES) + sorted(EDGE_CASES))
def test_cuda_kernel_matches_plain(cuda_device, case):
    """Three launches, each equal to the plain labels: a race in the
    union-find's atomics would show as a difference between them."""
    masks = torch.from_numpy({**CASES, **EDGE_CASES}[case]()).to(cuda_device)
    ref = connected_components_plain(masks)
    for _ in range(3):
        before = connected_components.launches
        got = connected_components(masks)
        torch.cuda.synchronize()
        assert connected_components.launches == before + 1
        assert torch.equal(got, ref)


@pytest.mark.cuda
def test_cuda_kernel_at_chunk_size(cuda_device):
    """A whole device-tracking chunk (B = R*F = 1024 frames) at 68x120."""
    masks = torch.from_numpy(_random((1024, 68, 120), 0.3, 23)).to(cuda_device)
    ref = connected_components_plain(masks)
    for _ in range(3):
        assert torch.equal(connected_components(masks), ref)


@pytest.mark.cuda
def test_cuda_mask_to_boxes_matches_cpu(cuda_device):
    masks = torch.from_numpy(_random((8, 128, 45, 80), 0.05, 5))
    got = mask_to_boxes(masks.to(cuda_device))
    ref = mask_to_boxes(masks)
    for name in ("ltwh", "valid", "area"):
        assert torch.equal(getattr(got, name).cpu(), getattr(ref, name)), name


def test_jax_reference_converges_on_these_cases():
    # The JAX XLA labelling stops after 32 sweeps; these masks converge
    # well within that, so it is a valid exact reference above.
    masks = _random((2, 3, 45, 80), 0.2, 11).reshape(-1, 45, 80)
    from cova_tpu.ops.cc import connected_components as jax_cc

    ref = np.asarray(jax.vmap(lambda m: jax_cc(m, 32))(jnp.asarray(masks)))
    np.testing.assert_array_equal(
        connected_components_plain(torch.from_numpy(masks)).numpy(), ref
    )

"""SORT in the PyTorch port against the JAX package: IoU, the Kalman
filter, the batched overflow auction and a multi-frame `sort_step`
sequence, on the same seeded numpy inputs.

Tolerances: integer and boolean outputs equal; float32 results within
1e-5 relative to the array's magnitude (matrix products and the Kalman
update's 4x4 inverse sum in another order)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cova_tpu.config import SortConfig
from cova_tpu.ops.assignment import solve_assignment_overflow as jax_solve
from cova_tpu.ops.iou import iou_matrix as jax_iou
from cova_tpu.tracker import kalman as jk
from cova_tpu.tracker.sort import sort_init as jax_sort_init
from cova_tpu.tracker.sort import sort_step as jax_sort_step
from cova_tpu.types import Boxes as JaxBoxes
from cova_tpu_torch.ops.assignment import solve_assignment_overflow
from cova_tpu_torch.ops.iou import iou_matrix
from cova_tpu_torch.tracker import kalman as tk
from cova_tpu_torch.tracker.sort import sort_init, sort_step
from cova_tpu_torch.types import Boxes

# The suite runs one test worker per core: keep torch to one thread each.
torch.set_num_threads(1)

RTOL = 1e-5


def _close(got, ref, err_msg=""):
    ref = np.asarray(ref)
    got = np.asarray(got)
    if ref.dtype.kind in "biu":
        np.testing.assert_array_equal(got, ref, err_msg=err_msg)
        return
    scale = max(float(np.abs(ref).max(initial=0.0)), 1.0)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=RTOL * scale, err_msg=err_msg)


def _random_ltwh(rng, shape):
    lt = rng.uniform(0, 60, size=shape + (2,))
    wh = rng.uniform(0.5, 12, size=shape + (2,))
    return np.concatenate([lt, wh], -1).astype(np.float32)


def test_iou_matrix_matches_jax():
    rng = np.random.default_rng(0)
    a, b = _random_ltwh(rng, (12,)), _random_ltwh(rng, (9,))
    b[:3] = a[:3]  # identical boxes: IoU 1
    ref = np.asarray(jax_iou(jnp.asarray(a), jnp.asarray(b)))
    got = iou_matrix(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)
    assert (got > 0).any() and np.allclose(np.diag(got[:3, :3]), 1.0)


def test_kalman_matches_jax():
    """Random states through the box conversions and one predict; then
    tracks as SORT runs them: init from a measurement, then predict and
    update with noisy measurements, frame after frame."""
    rng = np.random.default_rng(1)
    mean = np.concatenate(
        [_random_ltwh(rng, (3, 5)), rng.normal(0, 1, size=(3, 5, 3))], -1
    ).astype(np.float32)
    mean[..., 6] = rng.normal(0, 50, size=(3, 5))  # some s + s' <= 0
    _close(tk.bbox_to_z(torch.from_numpy(mean[..., :4])).numpy(),
           jk.bbox_to_z(jnp.asarray(mean[..., :4])))
    for quirk in (True, False):
        _close(tk.x_to_bbox(torch.from_numpy(mean), quirk).numpy(),
               jk.x_to_bbox(jnp.asarray(mean), quirk))
    cov = np.broadcast_to(np.eye(7, dtype=np.float32) * 3, (3, 5, 7, 7)).copy()
    mp, cp = tk.kalman_predict(torch.from_numpy(mean), torch.from_numpy(cov))
    jmp, jcp = jk.kalman_predict(jnp.asarray(mean), jnp.asarray(cov))
    _close(mp.numpy(), jmp, "predict mean")
    _close(cp.numpy(), jcp, "predict cov")

    boxes = _random_ltwh(rng, (3, 5))
    z = tk.bbox_to_z(torch.from_numpy(boxes))
    m, c = tk.kalman_init(z)
    jm, jc = jk.kalman_init(jnp.asarray(z.numpy()))
    _close(m.numpy(), jm, "init mean")
    _close(c.numpy(), jc, "init cov")
    for step in range(6):
        m, c = tk.kalman_predict(m, c)
        jm, jc = jk.kalman_predict(jm, jc)
        boxes[..., :2] += rng.normal(0.5, 0.3, size=(3, 5, 2)).astype(np.float32)
        z = tk.bbox_to_z(torch.from_numpy(boxes))
        m, c = tk.kalman_update(m, c, z)
        jm, jc = jk.kalman_update(jm, jc, jnp.asarray(z.numpy()))
        _close(m.numpy(), jm, f"step {step} mean")
        _close(c.numpy(), jc, f"step {step} cov")


def _overflow_problem(seed, mt=24, md=8):
    # SORT-shaped costs (the JAX tests' generator): weight 1 or 2 minus
    # quantized IoU-like values, so there are many exact ties.
    rng = np.random.default_rng(seed)
    row_mask = rng.random(mt) < rng.uniform(0.2, 0.9)
    col_mask = rng.random(md) < rng.uniform(0.3, 1.0)
    weight = rng.choice([1.0, 2.0], mt)
    iou = np.round(rng.uniform(0, 1, (mt, md)) * 4) / 4
    return (weight[:, None] - iou).astype(np.float32), row_mask, col_mask


@pytest.mark.parametrize(
    "eps,max_iters,shape", [(1e-3, 8192, (24, 8)), (1e-2, 2048, (64, 32))]
)
def test_overflow_auction_lanes_match_solo_jax_runs(eps, max_iters, shape):
    """Lanes converge after different numbers of rounds; each lane of the
    batched port must equal its own solo JAX run."""
    probs = [_overflow_problem(seed, *shape) for seed in range(8)]
    probs.append((np.ones(shape, np.float32), np.ones(shape[0], bool), np.zeros(shape[1], bool)))
    cost, rows, cols = (np.stack(x) for x in zip(*probs))
    got = solve_assignment_overflow(
        torch.from_numpy(cost), torch.from_numpy(rows), torch.from_numpy(cols),
        3.0, eps=eps, max_iters=max_iters,
    ).numpy()
    for lane, (c, r, k) in enumerate(probs):
        ref = np.asarray(
            jax_solve(jnp.asarray(c), jnp.asarray(r), jnp.asarray(k), 3.0,
                      eps=eps, max_iters=max_iters)
        )
        np.testing.assert_array_equal(got[lane], ref, err_msg=f"lane {lane}")
    assert (got[-1] == -1).all()  # no columns: every row overflows
    assert (got[:-1] >= 0).any()


def _det_sequence(rng, lanes, frames, md):
    """Moving boxes with jitter, dropouts and clutter, per lane."""
    ltwh = np.zeros((frames, lanes, md, 4), np.float32)
    valid = np.zeros((frames, lanes, md), bool)
    for lane in range(lanes):
        n_obj = 2 + lane
        start = _random_ltwh(rng, (n_obj,))
        vel = rng.normal(0, 1.0, size=(n_obj, 2)).astype(np.float32)
        for f in range(frames):
            k = 0
            for o in range(n_obj):
                if rng.random() < 0.15:  # missed detection
                    continue
                box = start[o].copy()
                box[:2] += vel[o] * f + rng.normal(0, 0.3, 2)
                ltwh[f, lane, k] = box
                valid[f, lane, k] = True
                k += 1
            if rng.random() < 0.3:  # clutter
                ltwh[f, lane, k] = _random_ltwh(rng, ())
                valid[f, lane, k] = True
    return ltwh, valid


def test_sort_step_sequence_matches_jax():
    cfg = SortConfig(iou_threshold=0.1, max_age=3, min_hits=2, max_tracks=16)
    lanes, frames, md = 3, 24, 8
    ltwh, valid = _det_sequence(np.random.default_rng(4), lanes, frames, md)
    state = sort_init(cfg.max_tracks, lanes, "cpu")
    jstates = [jax_sort_init(cfg.max_tracks) for _ in range(lanes)]
    births = 0
    for f in range(frames):
        area = ltwh[f, ..., 2] * ltwh[f, ..., 3]
        dets = Boxes(
            ltwh=torch.from_numpy(ltwh[f]), valid=torch.from_numpy(valid[f]),
            area=torch.from_numpy(area), class_id=torch.full((lanes, md), -1, dtype=torch.int32),
            conf=torch.zeros((lanes, md)), track_id=torch.full((lanes, md), -1, dtype=torch.int32),
        )
        ts = torch.full((lanes,), 3 + 2 * f, dtype=torch.int32)
        state, out = sort_step(state, dets, ts, cfg)
        for lane in range(lanes):
            jd = JaxBoxes(
                ltwh=jnp.asarray(ltwh[f, lane]), valid=jnp.asarray(valid[f, lane]),
                area=jnp.asarray(area[lane]), class_id=jnp.full((md,), -1, jnp.int32),
                conf=jnp.zeros((md,)), track_id=jnp.full((md,), -1, jnp.int32),
            )
            jstates[lane], jout = jax_sort_step(jstates[lane], jd, jnp.int32(3 + 2 * f), cfg)
            for fld in dataclasses.fields(out):
                _close(getattr(out, fld.name)[lane].numpy(), getattr(jout, fld.name),
                       f"frame {f} lane {lane} out.{fld.name}")
            for fld in dataclasses.fields(state):
                _close(getattr(state, fld.name)[lane].numpy(), getattr(jstates[lane], fld.name),
                       f"frame {f} lane {lane} state.{fld.name}")
        births = int(state.id_counter.sum())
    assert births > lanes * 2  # tracks were born
    assert bool(state.active.any())  # and some were confirmed


def test_sort_init_shapes():
    st = sort_init(64, 8, "cpu")
    assert st.mean.shape == (8, 64, 7) and st.cov.shape == (8, 64, 7, 7)
    assert st.id_counter.shape == (8,) and st.track_id.dtype == torch.int32
    jst = jax.vmap(lambda _: jax_sort_init(64))(jnp.arange(8))
    for fld in dataclasses.fields(st):
        _close(getattr(st, fld.name).numpy(), getattr(jst, fld.name), fld.name)


def test_eps_ladder_divides_a_tensor_by_a_tensor(monkeypatch):
    """torch computes a Python scalar over a tensor as a reciprocal times
    the scalar, an ulp away from the division JAX does. The eps ladder of
    `solve_assignment` (4 * eps over the cost range) must divide a tensor
    by a tensor: the two forms differ on float32 inputs, and no scalar is
    divided by a tensor anywhere in the solver."""
    from cova_tpu_torch.ops.assignment import solve_assignment

    ranges = torch.from_numpy(np.random.default_rng(0).uniform(1, 50, 4096).astype(np.float32))
    tensor_form = torch.tensor(0.04, dtype=torch.float32) / ranges
    np.testing.assert_array_equal(tensor_form.numpy(), np.float32(0.04) / ranges.numpy())
    assert (0.04 / ranges != tensor_form).any()

    cost = torch.from_numpy(np.random.default_rng(1).uniform(0, 9, (6, 6)).astype(np.float32))
    want = solve_assignment(cost, phases=3)

    def refuse(self, other):
        raise AssertionError("a Python scalar divided by a tensor")

    monkeypatch.setattr(torch.Tensor, "__rtruediv__", refuse)
    with pytest.raises(AssertionError):
        1.0 / torch.ones(2)
    got = solve_assignment(cost, phases=3)
    assert torch.equal(got, want)
    assert sorted(got.tolist()) == list(range(6))

"""The SORT scan over a chunk (K7) in the PyTorch port.

`sort_scan_plain`, the plain version of the CUDA kernel, against JAX's scan
built as cova_tpu/pipeline/compressed.py builds it (jax.vmap over lanes of
lax.scan over `sort_step`, the state kept only below `nwin`), on the same
seeded inputs: several chunks with the state carried, nwin tails, gamma 2,
deaths and births reusing slots in one frame, all-empty frames, MT=64 with
MD=32 and a small MT/MD, and a contested frame whose auction runs to
max_iters. Integers equal, floats within RTOL 1e-5 (in fact equal: the
port's Kalman filter rounds as XLA's does on the CPU).

`_mirror_lane` is the kernel's control flow for one block (lane) in numpy
float32, one rounding an operation: rows bidding in parallel, each
searching its row in one running pass, each bid a 64-bit key
(bits(bid) << 32 | 0xFFFFFFFF - row) taken by its column's maximum in
one of two key arrays that alternate by round, "lost" before "won", the
block's stop condition, births by ranks (the free slot of rank k takes
the unmatched detection of rank k) and the commit under the nwin gate.
It is held equal to `sort_scan_plain` bit for bit, rounds included; the
search and the key are held to the plain version's argmax, masked max
and column argmax on ties.

The wrapper: a CPU tensor runs the plain version and launches nothing, a
shape over the kernel's limits raises, the ctypes argument block matches
the kernel's struct. The kernel against the plain version on the card is
marked `cuda` (`python -m pytest tests/test_torch_sort_scan.py -m cuda`)."""

import collections
import dataclasses
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cova_tpu.config import SortConfig as JaxSortConfig
from cova_tpu.tracker.sort import SortState as JaxSortState
from cova_tpu.tracker.sort import sort_init as jax_sort_init
from cova_tpu.tracker.sort import sort_step as jax_sort_step
from cova_tpu.types import Boxes as JaxBoxes
from cova_tpu_torch.config import SortConfig
from cova_tpu_torch.ops.assignment import solve_assignment_overflow
from cova_tpu_torch.ops.cuda import sort_kernel as sk
from cova_tpu_torch.pipeline.compressed import track_chunk
from cova_tpu_torch.tracker.sort import SortOutputs, SortState, sort_init
from cova_tpu_torch.types import Boxes

# The suite runs one test worker per core: keep torch to one thread each.
torch.set_num_threads(1)

RTOL = 1e-5
F32 = np.float32


# ---- inputs --------------------------------------------------------------


def _boxes(ltwh: np.ndarray, valid: np.ndarray) -> Boxes:
    """Port Boxes with leading dims (R, F) from ltwh (R, F, MD, 4)."""
    ltwh = np.where(valid[..., None], ltwh, 0).astype(np.float32)
    area = ltwh[..., 2] * ltwh[..., 3]
    ids = np.full(valid.shape, -1, np.int32)
    return Boxes(ltwh=torch.from_numpy(ltwh), valid=torch.from_numpy(valid.copy()),
                 area=torch.from_numpy(area), class_id=torch.from_numpy(ids),
                 conf=torch.zeros(valid.shape), track_id=torch.from_numpy(ids.copy()))


def _tracks(rng, r, f, md, n_obj, clutter, empty=0.0, whole=True):
    """Moving boxes with jitter, dropouts and clutter, lane by lane: ltwh
    (R, F, MD, 4), valid (R, F, MD); a share `empty` of frames has none.
    `whole`: in whole macroblock units, as the stage's boxes come from
    K1's stats (at least 1 wide and high)."""
    ltwh = np.zeros((r, f, md, 4), np.float32)
    valid = np.zeros((r, f, md), bool)
    for lane in range(r):
        n = n_obj[lane]
        start = np.concatenate([rng.uniform(0, 60, (n, 2)), rng.uniform(1, 12, (n, 2))], -1)
        vel = rng.normal(0, 1.0, (n, 2))
        for i in range(f):
            if rng.random() < empty:
                continue
            k = 0
            for o in range(n):
                if k == md or rng.random() < 0.15:
                    continue
                box = start[o].copy()
                box[:2] += vel[o] * i + rng.normal(0, 0.3, 2)
                ltwh[lane, i, k], valid[lane, i, k] = box, True
                k += 1
            while k < md and rng.random() < clutter:
                ltwh[lane, i, k] = np.concatenate([rng.uniform(0, 60, 2), rng.uniform(1, 12, 2)])
                valid[lane, i, k] = True
                k += 1
    if whole:
        ltwh = np.round(ltwh)
        ltwh[..., 2:] = np.maximum(ltwh[..., 2:], 1)
    return ltwh, valid


def _contested():
    """Lane 0: 32 equal boxes A, then 32 equal boxes B beside them (their
    IoU with A is 0: the auction assigns, the IoU test refuses, 32 more
    tracks are born), then 32 equal boxes C that overlap A and B alike
    (IoU 1/4 with both): 64 equal rows for 32 equal columns, whose prices
    climb one eps a round, one column at a time, so the auction stops at
    max_iters with 32 rows unassigned. Lane 1: ordinary tracks, so the
    lanes stop on their own rounds."""
    r, f, md = 2, 4, 32
    ltwh, valid = _tracks(np.random.default_rng(7), r, f, md, [0, 5], 0.3)
    for i, box in enumerate(((10, 10, 4, 4), (16, 10, 4, 4), (12, 10, 6, 4))):
        ltwh[0, i], valid[0, i] = box, True
    ltwh[0, 3], valid[0, 3] = 0, False
    return ltwh, valid


def _case(name):
    """(cfg, gamma, chunks): chunks is a list of (ltwh, valid, ts0, nwin)
    with the state carried from one to the next."""
    if name == "chunks MT=64 MD=32":
        # Three chunks; deaths (max_age 5) and a clutter of births fill the
        # 64 slots, so births also find no free slot; lane 1 ends early.
        cfg = SortConfig(min_hits=3, max_age=5)
        ltwh, valid = _tracks(np.random.default_rng(11), 3, 30, 32, [3, 20, 28], 0.9)
        chunks = []
        for c in range(3):
            nwin = [10, 10, 10] if c < 2 else [10, 4, 10]
            chunks.append((ltwh[:, 10 * c:10 * (c + 1)], valid[:, 10 * c:10 * (c + 1)],
                           [3 + 10 * c] * 3, nwin))
        return cfg, 1, chunks
    if name == "gamma 2, tails, MT=6 MD=4":
        # Few slots, deaths after 2 frames: a death and a birth share a
        # frame and a slot; all-empty frames; lane 2 runs no window.
        cfg = SortConfig(iou_threshold=0.2, min_hits=2, max_age=2, max_tracks=6)
        ltwh, valid = _tracks(np.random.default_rng(5), 4, 24, 4, [2, 3, 4, 1], 0.5, empty=0.2)
        return cfg, 2, [(ltwh[:, :12], valid[:, :12], [3, 3, 3, 101], [12, 7, 0, 12]),
                        (ltwh[:, 12:], valid[:, 12:], [27, 27, 27, 125], [12, 12, 5, 3])]
    if name == "contested MT=64 MD=32":
        ltwh, valid = _contested()
        return SortConfig(), 1, [(ltwh, valid, [3, 3], [4, 4])]
    if name == "fractional boxes MT=16 MD=8":
        # graft_entry's capacities, boxes off the macroblock grid.
        cfg = SortConfig(min_hits=2, max_age=3, max_tracks=16)
        ltwh, valid = _tracks(np.random.default_rng(3), 2, 20, 8, [4, 7], 0.5, whole=False)
        return cfg, 1, [(ltwh[:, :10], valid[:, :10], [3, 3], [10, 10]),
                        (ltwh[:, 10:], valid[:, 10:], [13, 13], [10, 6])]
    raise KeyError(name)


# The cases held to JAX's scan: boxes in whole macroblock units, the
# stage's own domain (see test_xla_contracts_a_fractional_area_into_an_fma
# for boxes off the grid). The mirror and the kernel take every case.
JAX_CASES = ("chunks MT=64 MD=32", "gamma 2, tails, MT=6 MD=4", "contested MT=64 MD=32")
CASES = JAX_CASES + ("fractional boxes MT=16 MD=8",)


@functools.cache
def _plain(name):
    """The plain scan over the case's chunks: (per-chunk (state, outputs),
    the overflow auction's (rounds, row searches))."""
    cfg, gamma, chunks = _case(name)
    state = sort_init(cfg.max_tracks, chunks[0][0].shape[0], "cpu")
    rounds0, rows0 = solve_assignment_overflow.rounds, solve_assignment_overflow.row_rounds
    res = []
    for ltwh, valid, ts0, nwin in chunks:
        state, out = sk.sort_scan_plain(state, _boxes(ltwh, valid),
                                        torch.tensor(ts0, dtype=torch.int32),
                                        torch.tensor(nwin, dtype=torch.int32), gamma, cfg)
        res.append((state, out))
    return res, (solve_assignment_overflow.rounds - rounds0,
                 solve_assignment_overflow.row_rounds - rows0)


def _close(got, ref, err_msg):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, err_msg
    if ref.dtype.kind in "biu":
        np.testing.assert_array_equal(got, ref, err_msg=err_msg)
        return
    scale = max(float(np.abs(ref).max(initial=0.0)), 1.0)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=RTOL * scale, err_msg=err_msg)


# ---- the plain version against JAX's scan ---------------------------------


def _jax_scan(cfg, gamma):
    """compressed_stage_step's tracker, cova_tpu/pipeline/compressed.py
    :96-110: vmap over ranges of lax.scan of sort_step, the state kept
    where i < nwin."""

    def per_range(state, range_boxes, start_ts, nw):
        f = range_boxes.valid.shape[0]

        def step(st, inp):
            frame_boxes, i = inp
            st2, out = jax_sort_step(st, frame_boxes, start_ts + i * gamma, cfg)
            live = i < nw
            st3 = jax.tree_util.tree_map(lambda a, b: jnp.where(live, a, b), st2, st)
            return st3, out

        return jax.lax.scan(step, state, (range_boxes, jnp.arange(f, dtype=jnp.int32)))

    return jax.jit(jax.vmap(per_range))


@pytest.mark.parametrize("name", JAX_CASES)
def test_sort_scan_plain_matches_jax_scan(name):
    cfg, gamma, chunks = _case(name)
    jcfg = JaxSortConfig(**dataclasses.asdict(cfg))
    scan = _jax_scan(jcfg, gamma)
    r = chunks[0][0].shape[0]
    jstate = jax.vmap(lambda _: jax_sort_init(cfg.max_tracks))(jnp.arange(r))
    for c, ((state, out), (ltwh, valid, ts0, nwin)) in enumerate(zip(_plain(name)[0], chunks)):
        b = _boxes(ltwh, valid)
        jb = JaxBoxes(**{f.name: jnp.asarray(getattr(b, f.name).numpy())
                         for f in dataclasses.fields(Boxes)})
        jstate, jout = scan(jstate, jb, jnp.asarray(ts0, jnp.int32), jnp.asarray(nwin, jnp.int32))
        for fld in dataclasses.fields(SortOutputs):
            _close(getattr(out, fld.name).numpy(), getattr(jout, fld.name),
                   f"chunk {c} out.{fld.name}")
        for fld in dataclasses.fields(SortState):
            _close(getattr(state, fld.name).numpy(), getattr(jstate, fld.name),
                   f"chunk {c} state.{fld.name}")


def test_xla_contracts_a_fractional_area_into_an_fma():
    """Why JAX_CASES keep to whole units. A track born on a box and
    matched to a box of the same fractional size has y[2] = z[2] - s = 0
    in IEEE arithmetic, so its scale velocity stays 0: so in the port,
    and in JAX's kalman functions run on their own. JAX's jitted
    sort_step fuses bbox_to_z's w * h into the innovation as a fused
    multiply-add, whose unrounded product leaves a velocity of the
    product's rounding error. Floats then part at that level, and in a
    near-tie of the auction an integer can follow. With whole units the
    product is exact and the two agree bit for bit."""
    cfg = SortConfig()
    jcfg = JaxSortConfig(**dataclasses.asdict(cfg))
    box = np.array([[10.3, 7.1, 4.7, 3.3]], np.float32)
    for frac, moved in ((True, box), (False, np.round(box))):
        dets = [moved, moved + np.array([0.5, 0.25, 0, 0], np.float32)]
        st, jst = sort_init(cfg.max_tracks, 1, "cpu"), jax_sort_init(cfg.max_tracks)
        for d in dets:
            b = _boxes(np.pad(d, ((0, 31), (0, 0)))[None, None], np.arange(32)[None, None] < 1)
            st, _ = sk.sort_scan_plain(st, b, torch.tensor([3], dtype=torch.int32),
                                       torch.tensor([1], dtype=torch.int32), 1, cfg)
            jb = JaxBoxes(**{f.name: jnp.asarray(getattr(b, f.name)[0, 0].numpy())
                             for f in dataclasses.fields(Boxes)})
            jst, _ = jax_sort_step(jst, jb, jnp.int32(3), jcfg)
        assert float(st.mean[0, 0, 6]) == 0.0
        assert (float(jst.mean[0, 6]) != 0.0) == frac


def test_x_to_bbox_takes_a_correctly_rounded_root():
    """The box width sqrt(s * r) is the correctly rounded float32 root, as
    XLA's and the kernel's __fsqrt_rn are; torch's vectorised CPU sqrt is
    not on every machine (an ulp off for some values on AVX-512)."""
    from cova_tpu_torch.tracker import kalman as tk

    rng = np.random.default_rng(9)
    x = np.zeros((100_000, 7), np.float32)
    x[:, 2] = rng.uniform(1, 500, 100_000)
    x[:, 3] = rng.uniform(0.1, 10, 100_000)
    w = tk.x_to_bbox(torch.from_numpy(x))[:, 2].numpy()
    exact = np.sqrt((x[:, 2] * x[:, 3]).astype(np.float64)).astype(np.float32)
    np.testing.assert_array_equal(w.view(np.int32), exact.view(np.int32))


def test_cases_reach_what_they_are_for():
    """Births, deaths, activations and full slot tables where the cases
    say so; the contested frame's auction at max_iters."""
    res, _ = _plain("chunks MT=64 MD=32")
    outs = [o for _, o in res]
    assert all(bool(o.death.any()) and bool(o.active.any()) for o in outs)
    assert any(bool(o.exists.all(dim=2).any()) for o in outs)  # 64 slots in use
    res, _ = _plain("gamma 2, tails, MT=6 MD=4")
    (s0, o0), _ = res
    assert int(s0.frame_count[2]) == 0 and int(s0.frame_count[1]) == 7
    reuse = o0.death & o0.exists & (o0.track_id_post != o0.death_id)
    assert bool(reuse.any())  # a slot died and was born again in one frame
    _, (rounds, _) = _plain("contested MT=64 MD=32")
    assert rounds >= sk.AUCTION_MAX_ITERS


# ---- a numpy mirror of the kernel's control flow ---------------------------

NEG = F32(-1e9)
Q = np.array([1, 1, 1, 1, 0.01, 0.01, 0.0001], F32)
R_DIAG = np.array([1, 1, 10, 10], F32)
P0 = np.array([10, 10, 10, 10, 1e4, 1e4, 1e4], F32)


def _iou(a, b):
    """csrc/sort_kernel.cu's iou of one box a (4,) with boxes b (N, 4)."""
    ax2, ay2 = a[0] + a[2], a[1] + a[3]
    bx2, by2 = b[:, 0] + b[:, 2], b[:, 1] + b[:, 3]
    ix = np.maximum(np.minimum(ax2, bx2) - np.maximum(a[0], b[:, 0]), F32(0))
    iy = np.maximum(np.minimum(ay2, by2) - np.maximum(a[1], b[:, 1]), F32(0))
    inter = ix * iy
    uni = (a[2] * a[3] + b[:, 2] * b[:, 3]) - inter
    with np.errstate(invalid="ignore", divide="ignore"):
        q = inter / np.maximum(uni, F32(1e-12))
    return np.where(uni > 0, q, F32(0)).astype(F32)


def _bbox_to_z(b):
    return np.stack([b[..., 0] + b[..., 2] * F32(0.5), b[..., 1] + b[..., 3] * F32(0.5),
                     b[..., 2] * b[..., 3], b[..., 2] / np.maximum(b[..., 3], F32(1e-12))], -1)


def _x_to_bbox(x, quirk):
    s, r = np.maximum(x[2], F32(1e-12)), np.maximum(x[3], F32(1e-12))
    w = np.sqrt(s * r)
    h = s / np.maximum(w, F32(1e-12))
    return np.array([x[0] - w * F32(0.5), x[1] - (w if quirk else h) * F32(0.5), w, h], F32)


def _predict(m, p):
    m6 = F32(0) if m[6] + m[2] <= 0 else m[6]
    mp = np.array([m[0] + m[4], m[1] + m[5], m[2] + m6, m[3], m[4], m[5], m6], F32)
    fp = p.copy()
    fp[:3] = p[:3] + p[4:]
    pp = fp.copy()
    pp[:, :3] = fp[:, :3] + fp[:, 4:]
    pp[np.arange(7), np.arange(7)] += Q
    return mp, pp


def _update(mp, p, z):
    """The kernel's kalman_update, loop for loop."""
    y = z - mp[:4]
    m = p[:4, :4].copy()
    m[np.arange(4), np.arange(4)] += R_DIAG
    rhs = np.eye(4, dtype=F32)
    for q in range(4):
        for r in range(q + 1, 4):
            f = m[r, q] / m[q, q]
            for c in range(q + 1, 4):
                m[r, c] = m[r, c] - f * m[q, c]
            rhs[r] = rhs[r] - f * rhs[q]
    x = np.zeros((4, 4), F32)
    for r in range(3, -1, -1):
        acc = rhs[r].copy()
        for c in range(r + 1, 4):
            acc = acc - m[r, c] * x[c]
        x[r] = acc / m[r, r]
    k = np.zeros((7, 4), F32)
    for i in range(7):
        for a in range(4):
            acc = p[i, 0] * x[0, a]
            for b in range(1, 4):
                acc = acc + p[i, b] * x[b, a]
            k[i, a] = acc
    mn = np.zeros(7, F32)
    for i in range(7):
        ky = k[i, 0] * y[0]
        for a in range(1, 4):
            ky = ky + k[i, a] * y[a]
        mn[i] = mp[i] + ky
    ikh = np.eye(7, dtype=F32)
    ikh[:, :4] = ikh[:, :4] - k
    t = ikh[:, :1] * p[:1, :]
    for q in range(1, 7):
        t = t + ikh[:, q:q + 1] * p[q:q + 1, :]
    v = t[:, :1] * ikh[:, 0][None, :]
    for q in range(1, 7):
        v = v + t[:, q:q + 1] * ikh[:, q][None, :]
    kr = k * R_DIAG[None, :]
    w = kr[:, :1] * k[:, 0][None, :]
    for a in range(1, 4):
        w = w + kr[:, a:a + 1] * k[:, a][None, :]
    return mn, v + w


NO_KEY = np.uint64(0)  # an untouched key: below every bid's
ROW_BITS = np.uint64(0xFFFFFFFF)


def _search_row(value, ovf):
    """csrc/sort_kernel.cu's `search_row` on each row of value (N, MD): one
    running pass; a value above the best moves the old best into `second`,
    any other value goes to max(second, v). Returns (best, column,
    second)."""
    best, col = value[:, 0].copy(), np.zeros(len(value), int)
    second = np.full(len(value), ovf, F32)
    for j in range(1, value.shape[1]):
        v = value[:, j]
        up = v > best
        second = np.where(up, np.maximum(second, best), np.maximum(second, v))
        col = np.where(up, j, col)
        best = np.where(up, v, best)
    return best, col, second


def _bid_keys(bid, rows):
    """The bids' 64-bit keys: a float32 bid's bits above, 0xFFFFFFFF - row
    below."""
    bits = np.asarray(bid, F32).view(np.uint32).astype(np.uint64)
    return (bits << np.uint64(32)) | (ROW_BITS - np.asarray(rows).astype(np.uint64))


def _mirror_lane(st, ltwh, valid, ts0, nwin, gamma, cfg, max_iters):
    """One block of the kernel: st is the lane's state (dict of numpy
    arrays, updated), ltwh (F, MD, 4), valid (F, MD). Returns (outputs
    dict of (F, ...) arrays, (rounds, searches) a window, event counts)."""
    f_n, md = valid.shape
    mt = st["mean"].shape[0]
    ovf_v = F32(-sk.OVERFLOW_COST)
    eps = F32(sk.AUCTION_EPS)
    ev = collections.Counter()
    o = collections.defaultdict(list)
    rounds = []
    for f in range(f_n):
        ts = ts0 + f * gamma
        commit = f < nwin
        box, val = ltwh[f].astype(F32), valid[f]
        zdet = _bbox_to_z(box)
        ex = st["exists"]
        mp = st["mean"].copy()
        work = st["cov"].copy()
        pred = np.zeros((mt, 4), F32)
        for i in range(mt):
            if ex[i]:
                mp[i], work[i] = _predict(st["mean"][i], st["cov"][i])
            pred[i] = _x_to_bbox(mp[i], cfg.reproduce_from_x_quirk)
        profit = np.full((mt, md), NEG, F32)
        for i in range(mt):
            weight = F32(1) if st["active"][i] else F32(2)
            cost = weight - _iou(pred[i], box)
            profit[i] = np.where(ex[i] & val, -cost, NEG)
        r2c = np.where(ex, -1, md)
        price = np.zeros(md, F32)
        keys = np.zeros((2, md), np.uint64)  # both cleared at the window's top
        it = searches = 0
        while it < max_iters and (r2c < 0).any():  # __syncthreads_count
            searches += int((r2c < 0).sum())
            key = keys[it % 2]
            keys[(it + 1) % 2] = NO_KEY  # read last in the round before
            # (1) every unassigned row, in parallel: its search, then an
            # atomicMax of its key at its column.
            rows = np.flatnonzero(r2c < 0)
            best, bj, second = _search_row(profit[rows] - price, ovf_v)
            out = best <= ovf_v
            r2c[rows[out]] = md
            ev["exit to overflow"] += int(out.sum())
            rows, bj, best, second = rows[~out], bj[~out], best[~out], second[~out]
            bidcol = np.full(mt, -1)
            bid = np.zeros(mt, F32)
            bidcol[rows] = bj
            bid[rows] = (price[bj] + (best - second)) + eps
            np.maximum.at(key, bj, _bid_keys(bid[rows], rows))
            # (2) after the barrier every row resolves itself: lost, then won.
            owns = (r2c >= 0) & (r2c < md)
            lost = owns & (key[np.where(owns, r2c, 0)] != NO_KEY)
            ev["lost"] += int(lost.sum())
            r2c[lost] = -1
            won = (bidcol >= 0) & ((key[np.maximum(bidcol, 0)] & ROW_BITS)
                                   == ROW_BITS - np.arange(mt).astype(np.uint64))
            ev["outbid or tied"] += int(((bidcol >= 0) & ~won).sum())
            r2c[won] = bidcol[won]
            price[bidcol[won]] = bid[won]
            it += 1
        rounds.append((it, searches))
        ev["max_iters"] += it == max_iters
        # Accept, update, lifecycle, deaths.
        matched_det = np.full(mt, -1, np.int64)
        det_matched = np.zeros(md, bool)
        det_tid = np.full(md, -1, np.int32)
        mn, new = mp.copy(), {}
        for i in range(mt):
            col = r2c[i] if 0 <= r2c[i] < md else -1
            if ex[i] and col >= 0 and val[col]:
                piou = _iou(pred[i], box[col:col + 1])[0]
                if piou >= F32(cfg.iou_threshold) and piou > 0:
                    matched_det[i] = col
                    det_matched[col], det_tid[col] = True, st["track_id"][i]
                    mn[i], work[i] = _update(mp[i], work[i], zdet[col])
        acc = matched_det >= 0
        new["hits"] = st["hits"] + acc
        new["hit_streak"] = np.where(acc, st["hit_streak"] + 1, 0)
        confirm = acc & (new["hit_streak"] >= 5)
        new["time_since_update"] = np.where(confirm, 0, st["time_since_update"] + ex)
        new["last_match"] = np.where(confirm, ts, st["last_match"])
        new["age"] = st["age"] + ex
        new["active"] = st["active"] | (ex & (new["hit_streak"] >= cfg.min_hits))
        death = ex & (new["time_since_update"] > cfg.max_age)
        new["exists"] = ex & ~death
        for k, v in (("death", death), ("death_id", st["track_id"]),
                     ("death_start", st["start_ts"]), ("death_last_match", new["last_match"]),
                     ("death_tsu", new["time_since_update"]), ("death_active", new["active"])):
            o[k].append(np.array(v))
        # Births by ranks (the warps' ballots, in thread order).
        unmatched = val & ~det_matched
        free = ~new["exists"]
        det_rank = np.cumsum(unmatched) - unmatched
        free_rank = np.cumsum(free) - free
        n_unm, n_free = int(unmatched.sum()), int(free.sum())
        rank2det = np.zeros(md, int)
        rank2det[det_rank[unmatched]] = np.flatnonzero(unmatched)
        new["track_id"], new["start_ts"] = st["track_id"].copy(), st["start_ts"].copy()
        for i in np.flatnonzero(free & (free_rank < n_unm)):
            d = rank2det[free_rank[i]]
            new["exists"][i], new["active"][i] = True, False
            mn[i] = np.concatenate([zdet[d], np.zeros(3, F32)])
            work[i] = np.diag(P0)
            new["track_id"][i], new["start_ts"][i], new["last_match"][i] = (
                st["id_counter"] + free_rank[i], ts, ts)
            for k in ("hits", "hit_streak", "time_since_update", "age"):
                new[k][i] = 0
            ev["birth into a slot freed this frame"] += bool(death[i])
        ev["births refused: no free slot"] += max(0, n_unm - n_free)
        for k, v in (("track_ltwh", pred), ("track_id", st["track_id"]),
                     ("track_id_post", new["track_id"]), ("exists", new["exists"]),
                     ("active", new["active"]), ("predicted", ex),
                     ("matched_det", matched_det), ("det_track_id", det_tid)):
            o[k].append(np.array(v))
        if commit:
            st.update(mean=mn, cov=work, **new)
            st["id_counter"] = st["id_counter"] + min(n_free, n_unm)
            st["frame_count"] = st["frame_count"] + 1
        else:
            ev["windows past nwin"] += 1
    return {k: np.stack(v) for k, v in o.items()}, rounds, ev


def _plain_row_step(value, ovf):
    """ops/assignment.py's row step on value (N, MD): the first column of
    the best value (argmax), and the maximum of the others, the best masked
    to _NEG, floored at the overflow value."""
    v = torch.from_numpy(value)
    best_j = v.argmax(dim=1)
    masked = v.clone()
    masked.scatter_(1, best_j[:, None], float(NEG))
    second = torch.clamp(masked.max(dim=1).values, min=float(ovf))
    return v.max(dim=1).values.numpy(), best_j.numpy(), second.numpy()


@pytest.mark.parametrize("md", [1, 2, 3, 8, 13, 32])
def test_one_pass_search_is_the_argmax_and_the_masked_max(md):
    """The kernel's one-pass search gives the plain version's best, first
    best column and floored second on rows full of ties: equal values at
    the first and last column, a whole row equal, values at the overflow
    value and at kNeg less a price."""
    ovf = F32(-sk.OVERFLOW_COST)
    levels = np.array([NEG - F32(0.5), NEG, -3.5, ovf, -1.25, -0.5, 0.0], F32)
    value = np.random.default_rng(md).choice(levels, size=(3000, md)).astype(F32)
    value[0] = F32(-0.5)
    value[1] = NEG
    value[2, [0, -1]] = F32(0.25)
    value[3, [0, -1]] = ovf
    want = _plain_row_step(value, ovf)
    for g, w, what in zip(_search_row(value, ovf), want, ("best", "column", "second")):
        np.testing.assert_array_equal(np.asarray(g).astype(w.dtype), w, err_msg=what)


def test_bid_key_picks_the_plain_column_winner():
    """A column's largest key over its bidders names ops/assignment.py's
    winner, `bid_matrix.argmax(dim=1)`: the highest bid, the lowest row on
    ties; its upper half is the winning bid. A column without a bid keeps
    NO_KEY, which is below every key (a bid is at least eps > 0)."""
    rng = np.random.default_rng(2)
    mt, md = 64, 32
    eps = F32(sk.AUCTION_EPS)
    levels = np.array([eps, 0.02, 0.5, 1.0, np.nextafter(F32(1), F32(2)), 3.5, 1e6], F32)
    for _ in range(300):
        bidcol = rng.integers(-1, md, mt)  # -1: the row does not bid
        bid = rng.choice(levels, mt).astype(F32)
        bidder = bidcol >= 0
        bid_matrix = torch.where(
            torch.from_numpy(bidder[:, None] & (np.arange(md)[None, :] == bidcol[:, None])),
            torch.from_numpy(bid)[:, None], torch.tensor(float(NEG)))
        col_best = bid_matrix.max(dim=0).values.numpy()
        winner = bid_matrix.argmax(dim=0).numpy()
        has_bid = col_best > NEG / 2
        key = np.zeros(md, np.uint64)
        rows = np.flatnonzero(bidder)
        np.maximum.at(key, bidcol[rows], _bid_keys(bid[rows], rows))
        np.testing.assert_array_equal(key != NO_KEY, has_bid)
        np.testing.assert_array_equal((ROW_BITS - (key & ROW_BITS))[has_bid], winner[has_bid])
        won_bid = (key >> np.uint64(32)).astype(np.uint32).view(F32)
        np.testing.assert_array_equal(won_bid[has_bid], col_best[has_bid])
    assert _bid_keys([eps], [mt - 1])[0] > NO_KEY


_DTYPES = {"exists": bool, "active": bool, "predicted": bool, "death": bool,
           "death_active": bool, "matched_det": np.int64, "track_ltwh": F32}


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == F32 else a


@pytest.mark.parametrize("name", CASES)
def test_kernel_control_flow_mirror_matches_plain(name):
    cfg, gamma, chunks = _case(name)
    r = chunks[0][0].shape[0]
    init = sort_init(cfg.max_tracks, r, "cpu")
    lanes = [{f.name: getattr(init, f.name)[lane].numpy().copy()
              for f in dataclasses.fields(SortState)} for lane in range(r)]
    plain, _ = _plain(name)
    events = collections.Counter()
    total = np.zeros(2, int)
    for c, ((state, out), (ltwh, valid, ts0, nwin)) in enumerate(zip(plain, chunks)):
        b = _boxes(ltwh, valid)
        for lane in range(r):
            got, rounds, ev = _mirror_lane(lanes[lane], b.ltwh[lane].numpy(),
                                           b.valid[lane].numpy(), ts0[lane], nwin[lane], gamma,
                                           cfg, sk.AUCTION_MAX_ITERS)
            events += ev
            total += np.sum(rounds, axis=0)
            for fld in dataclasses.fields(SortOutputs):
                want = getattr(out, fld.name)[lane].numpy()
                g = got[fld.name].astype(_DTYPES.get(fld.name, np.int32))
                np.testing.assert_array_equal(_bits(g), _bits(want),
                                              err_msg=f"chunk {c} lane {lane} {fld.name}")
            for fld in dataclasses.fields(SortState):
                want = getattr(state, fld.name)[lane].numpy()
                g = np.asarray(lanes[lane][fld.name]).astype(want.dtype)
                np.testing.assert_array_equal(_bits(g), _bits(want),
                                              err_msg=f"chunk {c} lane {lane} state.{fld.name}")
    assert tuple(total) == _plain(name)[1]  # the plain version's own counts
    assert events["lost"] > 0 and events["outbid or tied"] > 0
    want = {"chunks MT=64 MD=32": ("births refused: no free slot", "windows past nwin",
                                   "exit to overflow"),
            "gamma 2, tails, MT=6 MD=4": ("birth into a slot freed this frame",
                                          "windows past nwin", "births refused: no free slot"),
            "contested MT=64 MD=32": ("max_iters",),
            "fractional boxes MT=16 MD=8": ("windows past nwin",)}[name]
    assert all(events[k] > 0 for k in want), events


# ---- the wrapper -----------------------------------------------------------


def test_cpu_tensors_run_the_plain_version_and_launch_nothing():
    cfg, gamma, chunks = _case("gamma 2, tails, MT=6 MD=4")
    ltwh, valid, ts0, nwin = chunks[0]
    args = (_boxes(ltwh, valid), torch.tensor(ts0, dtype=torch.int32),
            torch.tensor(nwin, dtype=torch.int32), gamma, cfg)
    before = sk.sort_scan.launches
    state, out = sk.sort_scan(sort_init(cfg.max_tracks, 4, "cpu"), *args)
    via_stage = track_chunk(sort_init(cfg.max_tracks, 4, "cpu"), *args)
    assert sk.sort_scan.launches == before
    ref_state, ref_out = _plain("gamma 2, tails, MT=6 MD=4")[0][0]
    for got, ref in ((state, ref_state), (out, ref_out), (via_stage[0], ref_state),
                     (via_stage[1], ref_out)):
        for fld in dataclasses.fields(ref):
            assert torch.equal(getattr(got, fld.name), getattr(ref, fld.name)), fld.name


def test_kernel_buffers_have_the_plain_versions_shapes_and_types():
    ref_state, ref_out = _plain("gamma 2, tails, MT=6 MD=4")[0][0]
    got = sk.empty_outputs(4, 12, 6, 4, "cpu")
    for fld in dataclasses.fields(SortOutputs):
        g, w = getattr(got, fld.name), getattr(ref_out, fld.name)
        assert (g.shape, g.dtype) == (w.shape, w.dtype), fld.name


@pytest.mark.parametrize("mt,md", [(257, 8), (8, 257), (0, 8), (256, 256)])
def test_shapes_over_the_kernels_limits_raise(mt, md):
    with pytest.raises(ValueError):
        sk.check_kernel_shape(mt, md)
    state = sort_init(max(mt, 1), 1, "cpu")
    if mt == 0:
        state = dataclasses.replace(state, **{
            f.name: getattr(state, f.name)[:, :0] for f in dataclasses.fields(SortState)
            if f.name not in ("id_counter", "frame_count")})
    b = _boxes(np.zeros((1, 2, md, 4), np.float32), np.zeros((1, 2, md), bool))
    with pytest.raises(ValueError):
        sk.sort_scan(state, b, torch.zeros(1, dtype=torch.int32),
                     torch.ones(1, dtype=torch.int32), 1, SortConfig(max_tracks=max(mt, 1)))


def test_a_chunk_without_windows_raises():
    b = _boxes(np.zeros((1, 0, 4, 4), np.float32), np.zeros((1, 0, 4), bool))
    with pytest.raises(ValueError):
        sk.sort_scan(sort_init(4, 1, "cpu"), b, torch.zeros(1, dtype=torch.int32),
                     torch.zeros(1, dtype=torch.int32), 1, SortConfig(max_tracks=4))


def test_kernel_limits_cover_the_paths_shapes():
    """The device-tracking path (MT=64, MD=32) and graft_entry's (MT=16,
    MD=8) fit the kernel; the shared memory formula is the .cu's."""
    for mt, md in ((64, 32), (16, 8), (128, 64)):
        sk.check_kernel_shape(mt, md)
    src = (sk._build.CSRC / "sort_kernel.cu").read_text()
    body = re.search(r"shared_words\(int mt, int md\) \{\s*return ([^;]+);", src).group(1)
    py = " ".join(re.sub(r"(\d+)L\b", r"\1", body).replace("(long)", "").split())
    for mt, md in ((64, 32), (16, 8), (256, 32), (7, 3)):
        words = eval(py, {"mt": mt, "md": md, "kWarps": 8})  # noqa: S307 - the .cu's own text
        assert 4 * words == sk.shared_bytes(mt, md)


def test_argument_block_matches_the_kernels_struct():
    """_SortArgs lists the .cu's SortArgs fields in order, with their C
    types: pointers, then int32, then float."""
    src = (sk._build.CSRC / "sort_kernel.cu").read_text()
    struct = re.search(r"struct SortArgs \{(.*?)\n\};", src, re.S).group(1)
    c_fields = []
    for line in struct.splitlines():
        line = line.split("//")[0].strip()
        if not line:
            continue
        m = re.match(r"(const )?(\w+)(\*?) (.+);", line)
        kind = "ptr" if m.group(3) else m.group(2)
        c_fields += [(n.strip(), kind) for n in m.group(4).split(",")]
    kinds = {ctypes_t: k for ctypes_t, k in ((sk.ctypes.c_void_p, "ptr"),
                                            (sk.ctypes.c_int32, "int32_t"),
                                            (sk.ctypes.c_float, "float"))}
    py_fields = [(n, kinds[t]) for n, t in sk._SortArgs._fields_]
    assert py_fields == c_fields
    assert sk.ctypes.sizeof(sk._SortArgs) == 46 * 8 + 12 * 4


# ---- on the card -----------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


def _to(tree, dev):
    return type(tree)(**{f.name: getattr(tree, f.name).to(dev) for f in dataclasses.fields(tree)})


@pytest.mark.cuda
@pytest.mark.parametrize("name", CASES)
def test_cuda_kernel_matches_plain(cuda_device, name):
    """K7 against the plain version on the card, every output and state
    field bit for bit, its rounds and searches against the plain version's
    counts, three times each chunk from the same state."""
    cfg, gamma, chunks = _case(name)
    r = chunks[0][0].shape[0]
    state = sort_init(cfg.max_tracks, r, cuda_device)
    for ltwh, valid, ts0, nwin in chunks:
        args = (_boxes(ltwh, valid).map(lambda t: t.to(cuda_device)),
                torch.tensor(ts0, dtype=torch.int32, device=cuda_device),
                torch.tensor(nwin, dtype=torch.int32, device=cuda_device), gamma, cfg)
        counts0 = solve_assignment_overflow.rounds, solve_assignment_overflow.row_rounds
        ref_state, ref_out = sk.sort_scan_plain(state, *args)
        want = (solve_assignment_overflow.rounds - counts0[0],
                solve_assignment_overflow.row_rounds - counts0[1])
        for _ in range(3):
            rounds, searches = (torch.zeros(ltwh.shape[:2], dtype=torch.int32,
                                            device=cuda_device) for _ in range(2))
            launches = sk.sort_scan.launches
            got_state, got_out = sk.sort_scan(state, *args, rounds=rounds, searches=searches)
            torch.cuda.synchronize()
            assert sk.sort_scan.launches == launches + 1
            assert (int(rounds.sum()), int(searches.sum())) == want
            for got, ref in ((got_state, ref_state), (got_out, ref_out)):
                for fld in dataclasses.fields(ref):
                    g, w = getattr(got, fld.name), getattr(ref, fld.name)
                    assert g.dtype == w.dtype and g.shape == w.shape, fld.name
                    if g.dtype == torch.float32:
                        g, w = g.view(torch.int32), w.view(torch.int32)
                    assert torch.equal(g, w), fld.name
        state = ref_state

"""SORT multi-object tracking as a batched state machine (PyTorch port of
cova_tpu/tracker/sort.py).

Track slots are fixed-capacity tensors with a leading lane axis L (one
lane per independent GoP range), so one `sort_step` updates every lane
for one frame; the caller loops over frames.

Lifecycle (as in the JAX package, mirroring the reference SORT):
 * cost = weight - IoU with weight 1 for active, 2 for inactive tracks,
   solved as the rectangular live-rows x valid-columns problem with an
   unlimited overflow at cost 3.0;
 * accepted pairs need IoU >= iou_threshold and IoU > 0;
 * `time_since_update`/`last_match` only reset/advance once a track's
   hit streak reaches 5;
 * activation when hit_streak >= min_hits; death when
   time_since_update > max_age;
 * births claim slots freed by deaths in the same frame, in detection
   order.
"""

from __future__ import annotations

import dataclasses

import torch

from cova_tpu_torch.config import SortConfig
from cova_tpu_torch.ops.assignment import solve_assignment_overflow
from cova_tpu_torch.ops.iou import iou_matrix
from cova_tpu_torch.tracker import kalman
from cova_tpu_torch.types import Boxes

HIT_STREAK_CONFIRM = 5  # the reference's hard-coded streak gate


@dataclasses.dataclass
class SortState:
    mean: torch.Tensor  # (L, MT, 7) float32
    cov: torch.Tensor  # (L, MT, 7, 7) float32
    exists: torch.Tensor  # (L, MT) bool
    active: torch.Tensor  # (L, MT) bool
    track_id: torch.Tensor  # (L, MT) int32
    start_ts: torch.Tensor  # (L, MT) int32 frame index
    last_match: torch.Tensor  # (L, MT) int32
    hits: torch.Tensor  # (L, MT) int32
    hit_streak: torch.Tensor  # (L, MT) int32
    time_since_update: torch.Tensor  # (L, MT) int32
    age: torch.Tensor  # (L, MT) int32
    id_counter: torch.Tensor  # (L,) int32
    frame_count: torch.Tensor  # (L,) int32


@dataclasses.dataclass
class SortOutputs:
    """Per-frame emissions, all fixed-shape. The host rebuilds per-track
    histories and the aggregator payloads from these."""

    track_ltwh: torch.Tensor  # (L, MT, 4) predicted boxes this frame
    track_id: torch.Tensor  # (L, MT) int32, pre-birth ids
    track_id_post: torch.Tensor  # (L, MT) int32, post-birth ids
    exists: torch.Tensor  # (L, MT) bool, after births and deaths
    active: torch.Tensor  # (L, MT) bool
    predicted: torch.Tensor  # (L, MT) bool, slot predicted this frame
    matched_det: torch.Tensor  # (L, MT) int64 det index or -1
    det_track_id: torch.Tensor  # (L, MD) int32 track id per detection or -1
    death: torch.Tensor  # (L, MT) bool, slot died this frame
    death_id: torch.Tensor  # (L, MT) int32
    death_start: torch.Tensor  # (L, MT) int32
    death_last_match: torch.Tensor  # (L, MT) int32
    death_tsu: torch.Tensor  # (L, MT) int32 (history trim amount)
    death_active: torch.Tensor  # (L, MT) bool (only active deaths report)


def sort_init(max_tracks: int, lanes: int, device) -> SortState:
    """Empty tracker state for `lanes` independent lanes."""
    mt = max_tracks

    def i32(fill=0, shape=(lanes, mt)):
        return torch.full(shape, fill, dtype=torch.int32, device=device)

    return SortState(
        mean=torch.zeros((lanes, mt, 7), dtype=torch.float32, device=device),
        cov=torch.eye(7, dtype=torch.float32, device=device).expand(lanes, mt, 7, 7).clone(),
        exists=torch.zeros((lanes, mt), dtype=torch.bool, device=device),
        active=torch.zeros((lanes, mt), dtype=torch.bool, device=device),
        track_id=i32(-1),
        start_ts=i32(),
        last_match=i32(),
        hits=i32(),
        hit_streak=i32(),
        time_since_update=i32(),
        age=i32(),
        id_counter=i32(shape=(lanes,)),
        frame_count=i32(shape=(lanes,)),
    )


def _set_drop(dst: torch.Tensor, idx: torch.Tensor, src) -> torch.Tensor:
    """Per lane, dst[l, idx[l, k]] = src[l, k], dropping entries whose
    index is dst.shape[1] (the JAX `.at[idx].set(src, mode="drop")`).
    Kept indices are distinct; dropped ones all land in a spare slot."""
    nl, n = dst.shape[:2]
    ext = torch.cat([dst, dst[:, :1]], dim=1)
    lane = torch.arange(nl, device=dst.device)[:, None].expand_as(idx)
    src = torch.as_tensor(src, dtype=dst.dtype, device=dst.device)
    ext[lane, idx.long()] = src.expand(idx.shape + dst.shape[2:])
    return ext[:, :n]


def sort_step(
    state: SortState, dets: Boxes, ts: torch.Tensor, cfg: SortConfig
) -> tuple[SortState, SortOutputs]:
    """One SORT frame update for every lane.

    dets: Boxes with leading dim L (ltwh (L, MD, 4), valid (L, MD));
    ts: (L,) int32 frame index per lane."""
    mt = state.mean.shape[1]
    md = dets.valid.shape[1]
    ts = ts.to(torch.int32)[:, None]
    exists0 = state.exists

    frame_count = state.frame_count + 1

    # ---- predict all existing tracks -------------------------------------
    mean_p, cov_p = kalman.kalman_predict(state.mean, state.cov)
    mean_p = torch.where(exists0[..., None], mean_p, state.mean)
    cov_p = torch.where(exists0[..., None, None], cov_p, state.cov)
    pred_ltwh = kalman.x_to_bbox(mean_p, cfg.reproduce_from_x_quirk)
    predicted = exists0
    age = state.age + predicted.to(torch.int32)
    tsu = state.time_since_update + predicted.to(torch.int32)

    # ---- assignment -------------------------------------------------------
    iou = iou_matrix(pred_ltwh, dets.ltwh)  # (L, MT, MD)
    weight = torch.where(state.active, 1.0, 2.0)
    cost = weight[..., None] - iou
    assigned_col = solve_assignment_overflow(cost, exists0, dets.valid, 3.0)
    col = assigned_col.clamp(0, md - 1)
    pair_ok = (
        exists0
        & (assigned_col >= 0)
        & (assigned_col < md)
        & torch.gather(dets.valid, 1, col)
    )
    pair_iou = torch.gather(iou, 2, col[..., None])[..., 0]
    accept = pair_ok & (pair_iou >= cfg.iou_threshold) & (pair_iou > 0.0)
    matched_det = torch.where(accept, assigned_col, -1)  # (L, MT)

    to_det = torch.where(accept, assigned_col, md)
    det_matched = _set_drop(
        torch.zeros_like(dets.valid), to_det, True
    )
    det_track_id = _set_drop(
        torch.full_like(dets.valid, -1, dtype=torch.int32), to_det, state.track_id
    )

    # ---- measurement update ----------------------------------------------
    z_det = kalman.bbox_to_z(dets.ltwh)  # (L, MD, 4)
    z = torch.gather(
        z_det, 1, matched_det.clamp(min=0)[..., None].expand(-1, -1, 4)
    )  # (L, MT, 4)
    mean_u, cov_u = kalman.kalman_update(mean_p, cov_p, z)
    matched = matched_det >= 0
    mean_n = torch.where(matched[..., None], mean_u, mean_p)
    cov_n = torch.where(matched[..., None, None], cov_u, cov_p)

    hits = state.hits + matched.to(torch.int32)
    hit_streak = torch.where(matched, state.hit_streak + 1, 0).to(torch.int32)
    confirm = matched & (hit_streak >= HIT_STREAK_CONFIRM)
    tsu = torch.where(confirm, 0, tsu).to(torch.int32)
    last_match = torch.where(confirm, ts, state.last_match)

    # ---- activation -------------------------------------------------------
    active = state.active | (exists0 & (hit_streak >= cfg.min_hits))

    # ---- deaths -----------------------------------------------------------
    death = exists0 & (tsu > cfg.max_age)
    exists = exists0 & ~death
    # Snapshot death info before births can reuse the freed slots.
    death_last_match = last_match
    death_tsu = tsu
    death_active = active

    # ---- births -----------------------------------------------------------
    det_unmatched = dets.valid & ~det_matched
    det_rank = torch.cumsum(det_unmatched.to(torch.int64), dim=1) - 1  # (L, MD)
    # Free slots in ascending index order (first n_free entries).
    slot_of_rank = torch.argsort(exists.to(torch.int8), dim=1, stable=True)
    birth_slot = torch.gather(slot_of_rank, 1, det_rank.clamp(0, mt - 1))
    n_free = (~exists).sum(dim=1, keepdim=True)
    birth_ok = det_unmatched & (det_rank < n_free)

    # New track ids follow detection order.
    new_id = state.id_counter[:, None] + torch.where(birth_ok, det_rank, 0)
    id_counter = (state.id_counter + birth_ok.sum(dim=1)).to(torch.int32)

    b_mean, b_cov = kalman.kalman_init(z_det)

    idx = torch.where(birth_ok, birth_slot, mt)
    exists = _set_drop(exists, idx, True)
    active2 = _set_drop(active, idx, False)
    mean_n = _set_drop(mean_n, idx, b_mean)
    cov_n = _set_drop(cov_n, idx, b_cov)
    track_id = _set_drop(state.track_id, idx, new_id)
    start_ts = _set_drop(state.start_ts, idx, ts)
    last_match = _set_drop(last_match, idx, ts)
    hits = _set_drop(hits, idx, 0)
    hit_streak = _set_drop(hit_streak, idx, 0)
    tsu2 = _set_drop(tsu, idx, 0)
    age2 = _set_drop(age, idx, 0)

    new_state = SortState(
        mean=mean_n,
        cov=cov_n,
        exists=exists,
        active=active2,
        track_id=track_id,
        start_ts=start_ts,
        last_match=last_match,
        hits=hits,
        hit_streak=hit_streak,
        time_since_update=tsu2,
        age=age2,
        id_counter=id_counter,
        frame_count=frame_count,
    )
    outputs = SortOutputs(
        track_ltwh=pred_ltwh,
        track_id=state.track_id,
        track_id_post=track_id,
        exists=exists,
        active=active2,
        predicted=predicted,
        matched_det=matched_det,
        det_track_id=det_track_id,
        death=death,
        death_id=state.track_id,
        death_start=state.start_ts,
        death_last_match=death_last_match,
        death_tsu=death_tsu,
        death_active=death_active,
    )
    return new_state, outputs

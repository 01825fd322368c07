"""Linear assignment by the auction algorithm (PyTorch port of
cova_tpu/ops/assignment.py).

The auction algorithm (Bertsekas): every unassigned row bids for its best
column in parallel each round; each column goes to its highest bidder
(first index on ties, as jnp.argmax and torch.argmax both resolve them).

* `solve_assignment`: one square (S, S) problem, optionally with an eps
  ladder, completed to a full permutation.
* `solve_assignment_overflow`: the rectangular problem with an overflow
  option that the device SORT solves, batched over a leading lane axis.
  JAX runs it as a vmapped while_loop, in which each lane stops on its
  own condition; here the lanes share one Python loop and a lane is
  frozen once its own condition is false, so every lane's result equals
  a solo run. It counts the rounds it runs (an instrument; nothing reads
  the counts to decide anything).
"""

from __future__ import annotations

import torch

_NEG = -1e9
# Lanes' stopping conditions are pulled to the host once every this many
# rounds; frozen lanes do not change, so the result does not depend on it.
_CHECK_EVERY = 8


def _scatter_drop(dst: torch.Tensor, idx: torch.Tensor, src) -> torch.Tensor:
    """dst.at[lane, idx].set(src, mode="drop") along dim 1: entries whose
    index is out of range (== dst.shape[1]) are dropped."""
    n = dst.shape[1]
    ext = torch.cat([dst, dst[:, :1]], dim=1)
    src = torch.as_tensor(src, dtype=dst.dtype, device=dst.device).expand(idx.shape)
    ext.scatter_(1, idx.long(), src)
    return ext[:, :n]


def _auction_phase(profit, prices, eps, max_iters):
    """Auction rounds from an empty assignment until every row holds a
    column or `max_iters` rounds ran. Returns (row_to_col, prices);
    row_to_col is -1 for rows left unassigned."""
    s = profit.shape[0]
    dev = profit.device
    rows = torch.arange(s, device=dev)
    row_to_col = torch.full((1, s), -1, dtype=torch.long, device=dev)
    col_to_row = torch.full((s,), -1, dtype=torch.long, device=dev)
    neg = torch.tensor(_NEG, dtype=torch.float32, device=dev)
    it = 0
    while it < max_iters and bool((row_to_col < 0).any()):
        unassigned = row_to_col[0] < 0

        # Every unassigned row bids for its best column.
        value = profit - prices[None, :]
        best_j = value.argmax(dim=1)  # first index on ties
        best_v = value.max(dim=1).values
        masked = value.clone()
        masked[rows, best_j] = _NEG
        second_v = masked.max(dim=1).values
        bid = prices[best_j] + (best_v - second_v) + eps

        # Each column goes to its highest bidder.
        bid_matrix = torch.where(
            unassigned[:, None] & (rows[None, :] == best_j[:, None]),
            bid[:, None],
            neg,
        )
        col_best_bid = bid_matrix.max(dim=0).values
        col_winner = bid_matrix.argmax(dim=0)
        has_bid = col_best_bid > _NEG / 2

        # Previous owners of re-bid columns lose them (bidders are all
        # unassigned, so winners and owners are disjoint).
        lost = _scatter_drop(
            torch.zeros((1, s), dtype=torch.bool, device=dev),
            torch.where(has_bid & (col_to_row >= 0), col_to_row, s)[None],
            True,
        )
        row_to_col = torch.where(lost, -1, row_to_col)
        row_to_col = _scatter_drop(
            row_to_col, torch.where(has_bid, col_winner, s)[None], rows[None]
        )
        col_to_row = torch.where(has_bid, col_winner, col_to_row)
        prices = torch.where(has_bid, col_best_bid, prices)
        it += 1
    return row_to_col[0], prices


def solve_assignment(
    cost: torch.Tensor,
    eps: float = 1e-2,
    max_iters: int = 512,
    phases: int = 1,
) -> torch.Tensor:
    """Solve the square min-cost assignment problem.

    One auction phase at `eps` by default; with phases > 1 an eps ladder
    from (cost range)/4 down to eps, the prices carried from phase to
    phase. The last phase may run 2 * max_iters rounds. The result is
    optimal whenever cost gaps exceed S*eps. Rows still unassigned at the
    bound are completed by rank onto the free columns in ascending
    order, so the result is always a permutation.

    Returns row_to_col: (S,) int32."""
    s = cost.shape[0]
    if tuple(cost.shape) != (s, s):
        raise ValueError(f"expected a square cost matrix, got {tuple(cost.shape)}")
    profit = -cost.to(torch.float32)
    dev = profit.device

    cost_range = torch.clamp(profit.max() - profit.min(), min=1.0)
    prices = torch.zeros((s,), dtype=torch.float32, device=dev)
    # 4*eps as a float32 tensor: a Python scalar over a tensor would be
    # computed as a reciprocal times the scalar, not as a division.
    four_eps = torch.tensor(4.0 * eps, dtype=torch.float32, device=dev)
    for p in range(phases - 1):
        # eps ladder: range/4 -> ... -> eps
        frac = (p + 1) / phases
        cur_eps = cost_range / 4.0 * (four_eps / cost_range) ** frac
        _, prices = _auction_phase(profit, prices, cur_eps, max_iters)
    row_to_col, _ = _auction_phase(profit, prices, eps, max_iters * 2)

    # Greedy completion: rank-match any still-unassigned rows to the
    # free columns (ascending index), so the result is a permutation.
    unassigned = row_to_col < 0
    cols = torch.arange(s, device=dev)
    owned = _scatter_drop(
        torch.zeros((1, s), dtype=torch.bool, device=dev),
        torch.where(unassigned, s, row_to_col)[None],
        True,
    )[0]
    row_rank = torch.cumsum(unassigned.long(), dim=0) - 1
    free_cols = torch.sort(torch.where(owned, s, cols), stable=True).indices
    fill = free_cols[row_rank.clamp(0, s - 1)]
    return torch.where(unassigned, fill, row_to_col).to(torch.int32)


def solve_assignment_overflow(
    cost: torch.Tensor,  # (L, MT, MD) real-pair costs
    row_mask: torch.Tensor,  # (L, MT) bool — rows that must be assigned
    col_mask: torch.Tensor,  # (L, MD) bool — columns that exist
    overflow_cost: float,
    eps: float = 1e-2,
    max_iters: int = 2048,
) -> torch.Tensor:
    """Match each masked row to a distinct masked column (paying
    cost[l, i, j]) or to overflow (paying `overflow_cost`, unlimited
    capacity), minimizing the total per lane. Exact whenever distinct
    total-cost gaps exceed (assigned rows) * eps. Rows still unassigned at
    `max_iters` fall to overflow.

    Returns (L, MT) int64: the matched column, or -1 for overflow and
    masked-out rows.

    Adds the rounds each lane ran to `solve_assignment_overflow.rounds`,
    and the rows that searched for a column in them (the unassigned
    rows of each round) to `solve_assignment_overflow.row_rounds`."""
    nl, mt, md = cost.shape
    dev = cost.device
    profit = torch.where(
        row_mask[:, :, None] & col_mask[:, None, :],
        -cost.to(torch.float32),
        torch.tensor(_NEG, dtype=torch.float32, device=dev),
    )
    ovf_v = -float(overflow_cost)
    ovf_col = md  # sentinel: parked on overflow
    r2c = torch.where(
        row_mask, torch.tensor(-1, device=dev), torch.tensor(ovf_col, device=dev)
    ).long()
    c2r = torch.full((nl, md), -1, dtype=torch.long, device=dev)
    prices = torch.zeros((nl, md), dtype=torch.float32, device=dev)
    cols = torch.arange(md, device=dev)
    rounds = torch.zeros((2,), dtype=torch.int64, device=dev)

    # Round k runs for the lanes still live; none runs more than
    # max_iters rounds, as in JAX's per-lane while_loop bound.
    for k in range(max_iters):
        live = (r2c < 0).any(dim=1)  # (L,)
        if k % _CHECK_EVERY == 0 and not bool(live.any()):
            break
        unassigned = r2c < 0
        rounds += torch.stack([live.sum(), unassigned.sum()])
        value = profit - prices[:, None, :]  # (L, MT, MD)
        best_v = value.max(dim=2).values
        best_j = value.argmax(dim=2)  # first index on ties
        masked = value.clone()
        masked.scatter_(2, best_j[..., None], _NEG)
        # Overflow is always available, so it caps the second-best.
        second_v = torch.clamp(masked.max(dim=2).values, min=ovf_v)

        # Rows for which overflow beats every remaining real column exit
        # permanently (prices only rise).
        exit_ovf = unassigned & (best_v <= ovf_v)
        n_r2c = torch.where(exit_ovf, ovf_col, r2c)
        bidder = unassigned & ~exit_ovf

        bid = torch.gather(prices, 1, best_j) + (best_v - second_v) + eps
        bid_matrix = torch.where(
            bidder[:, :, None] & (cols[None, None, :] == best_j[:, :, None]),
            bid[:, :, None],
            torch.tensor(_NEG, dtype=torch.float32, device=dev),
        )
        col_best = bid_matrix.max(dim=1).values  # (L, MD)
        col_winner = bid_matrix.argmax(dim=1)
        has_bid = col_best > _NEG / 2

        lost = _scatter_drop(
            torch.zeros((nl, mt), dtype=torch.bool, device=dev),
            torch.where(has_bid & (c2r >= 0), c2r, mt),
            True,
        )
        n_r2c = torch.where(lost, -1, n_r2c)
        n_r2c = _scatter_drop(
            n_r2c, torch.where(has_bid, col_winner, mt), cols.expand(nl, md)
        )
        n_c2r = torch.where(has_bid, col_winner, c2r)
        n_prices = torch.where(has_bid, col_best, prices)

        r2c = torch.where(live[:, None], n_r2c, r2c)
        c2r = torch.where(live[:, None], n_c2r, c2r)
        prices = torch.where(live[:, None], n_prices, prices)
    lane_rounds, row_rounds = rounds.tolist()
    solve_assignment_overflow.rounds += lane_rounds
    solve_assignment_overflow.row_rounds += row_rounds
    return torch.where((r2c >= 0) & (r2c < md), r2c, -1)


solve_assignment_overflow.rounds = 0
solve_assignment_overflow.row_rounds = 0

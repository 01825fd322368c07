"""Query-accuracy metrics (numpy port of cova_tpu/query/metrics.py).

Binary-predicate (BP) and count (GC) queries over the aggregator CSVs vs
a full-decode ground truth, globally and on a quadrant region, with
per-dataset exclusion regions. Names and signatures follow the JAX
package's module; a table is a `Frame` (numpy columns indexed by
timestamp) where that module uses a `pd.DataFrame`, and nothing here
imports pandas.

Timestamps are float seconds; the evaluation grid keeps the reference's
structure of 3 slots per 100 ms (common/time.py:11-21). A detection
counts in a slot only when its timestamp EQUALS the slot's value, as
`pd.DataFrame.update` aligns them, so the CSV reader must produce the
very doubles pandas does: `pandas_float` reproduces pandas' default
float converter, which is not correctly rounded (it reads about one
timestamp in eight an ulp off), and `float` is the round-trip parse.
"""

from __future__ import annotations

import csv
import dataclasses
import pathlib
from typing import Callable, Iterable, Sequence

import numpy as np

SLOT = 1.0 / 30.0
STEP3 = 0.1

# 10**k as the C literal 1eK, correctly rounded, for k in 0..308.
_POW10 = tuple(float(f"1e{k}") for k in range(309))
_MAX_DIGITS = 17


def pandas_float(text: str) -> float:
    """One decimal string as pandas' default CSV float converter reads it
    (`precise_xstrtod` of pandas' C tokenizer, `float_precision=None`):

    * the sign is kept;
    * up to 17 digits accumulate into a double as n = n * 10.0 + d (a
      leading zero counts as a digit); integer digits past the 17th add
      1 to the exponent, fraction digits past it are dropped, and each
      kept fraction digit subtracts 1;
    * an `e`/`E` exponent is added;
    * then one operation scales n: n *= 10.0**k for k > 0, n /= 10.0**-k
      for k < 0, the power from a table of the literals 1e0..1e308, with
      no correction step. Below 1e-308 it divides twice, by 1e(-308-k)
      and then by 1e308.

    So the result can be an ulp away from the correctly rounded `float`.
    Raises ValueError where pandas would not read a float: no digits,
    other characters after the number, or a result beyond the double
    range."""
    s = text.strip()
    i, n = 0, len(s)
    negative = False
    if i < n and s[i] in "+-":
        negative = s[i] == "-"
        i += 1
    number = 0.0
    exponent = 0
    digits = 0
    while i < n and "0" <= s[i] <= "9":
        if digits < _MAX_DIGITS:
            number = number * 10.0 + (ord(s[i]) - 48)
            digits += 1
        else:
            exponent += 1
        i += 1
    if i < n and s[i] == ".":
        i += 1
        decimals = 0
        while i < n and digits < _MAX_DIGITS and "0" <= s[i] <= "9":
            number = number * 10.0 + (ord(s[i]) - 48)
            digits += 1
            decimals += 1
            i += 1
        while i < n and "0" <= s[i] <= "9":
            i += 1
        exponent -= decimals
    if digits == 0:
        raise ValueError(f"not a number: {text!r}")
    if negative:
        number = -number
    if i < n and s[i] in "eE":
        j = i + 1
        neg_e = False
        if j < n and s[j] in "+-":
            neg_e = s[j] == "-"
            j += 1
        k = j
        while k < n and "0" <= s[k] <= "9":
            k += 1
        if k > j:
            e = int(s[j:k])
            exponent += -e if neg_e else e
            i = k
    if i != n:
        raise ValueError(f"not a number: {text!r}")
    if exponent > 308:
        raise ValueError(f"out of range: {text!r}")
    if exponent > 0:
        number *= _POW10[exponent]
    elif exponent < -616:
        number = 0.0
    elif exponent < -308:
        number = number / _POW10[-308 - exponent] / _POW10[308]
    else:
        number /= _POW10[-exponent]
    if number in (np.inf, -np.inf):
        raise ValueError(f"out of range: {text!r}")
    return number


class Frame:
    """A small columnar table: float64 numpy columns of one length, indexed
    by `index` (the timestamps), in the role the JAX package gives a
    timestamp-indexed `pd.DataFrame`."""

    def __init__(self, columns: dict, index: np.ndarray):
        self.columns = {k: np.asarray(v, np.float64) for k, v in columns.items()}
        self.index = np.asarray(index, np.float64)
        for k, v in self.columns.items():
            if v.shape != self.index.shape:
                raise ValueError(f"column {k!r} has {v.shape}, index {self.index.shape}")

    def __len__(self) -> int:
        return len(self.index)

    def __getitem__(self, name: str) -> np.ndarray:
        return self.columns[name]

    def with_column(self, name: str, values) -> "Frame":
        return Frame({**self.columns, name: values}, self.index)

    def take(self, rows) -> "Frame":
        """The rows selected by a boolean mask or an index array."""
        return Frame({k: v[rows] for k, v in self.columns.items()}, self.index[rows])

    def sort_index(self) -> "Frame":
        """Rows in timestamp order, rows of one timestamp kept in file order
        (pandas' `sort_index` leaves an ordered index as it is)."""
        return self.take(np.argsort(self.index, kind="stable"))


def read_csv(path, parse: Callable[[str], float] = pandas_float) -> dict:
    """A CSV of numbers as {column: float64 array}, each non-empty cell read
    by `parse` (pandas' default converter unless told otherwise; `float`
    is the round-trip parse), each empty cell NaN."""
    with open(path, newline="") as f:
        rows = csv.reader(f)
        header = next(rows, [])
        cache = {"": np.nan}
        cols = [[] for _ in header]
        for row in rows:
            if not row:
                continue
            for col, cell in zip(cols, row):
                v = cache.get(cell)
                if v is None:
                    v = cache[cell] = parse(cell)
                col.append(v)
    return {name: np.array(col, np.float64) for name, col in zip(header, cols)}


def _frame(columns: dict) -> Frame:
    """{column: array} with a timestamp column -> Frame indexed by it."""
    index = columns["timestamp"]
    return Frame({k: v for k, v in columns.items() if k != "timestamp"}, index)


def arange_ts(start: float, end: float) -> np.ndarray:
    """3 evaluation slots per 100 ms (reference: common/time.py arange_ts)."""
    base = np.arange(start, end, STEP3)
    out = np.empty(base.size * 3)
    out[0::3] = base
    out[1::3] = base + SLOT
    out[2::3] = base + 2 * SLOT
    return out


def load_boxes_csv(path, parse: Callable[[str], float] = pandas_float) -> Frame:
    return _frame(read_csv(path, parse)).sort_index()


def load_cova(output_dir) -> Frame:
    root = pathlib.Path(output_dir)
    parts = [read_csv(root / "assoc.csv")]
    st = root / "stationary.csv"
    if st.exists():
        parts.append(read_csv(st))
    # pd.concat: the union of the columns, NaN where a file lacks one.
    names = list(dict.fromkeys(k for p in parts for k in p))
    if "timestamp" not in names:
        names = ["left", "top", "width", "height", "timestamp", "class_id"]
    rows = [len(next(iter(p.values()))) if p else 0 for p in parts]
    cols = {
        k: np.concatenate([p.get(k, np.full(n, np.nan)) for p, n in zip(parts, rows)])
        for k in names
    }
    return _frame(cols).sort_index()


def exclude_regions(df: Frame, regions: Iterable) -> Frame:
    """Drop detections fully inside any exclusion rectangle
    (reference: parse.py get_exclude_df — noise suppression for small
    unstable YOLO detections)."""
    df = df.with_column("right", df["left"] + df["width"])
    df = df.with_column("bottom", df["top"] + df["height"])
    for (left, top), (right, bottom) in regions:
        idx = (
            (df["left"] >= left)
            & (df["top"] >= top)
            & (df["right"] <= right)
            & (df["bottom"] <= bottom)
        )
        df = df.take(~idx)
    return df


def local_region(
    df: Frame, region: str, width: int = 1280, height: int = 640
) -> Frame:
    """Quadrant filter (reference: parse.py get_local_df — note the
    reference's 'lower right' uses left <= w/2, preserved)."""
    right = df["left"] + df["width"]
    bottom = df["top"] + df["height"]
    if region == "upper left":
        idx = (right <= width / 2) & (bottom <= height / 2)
    elif region == "upper right":
        idx = (df["left"] >= width / 2) & (bottom <= height / 2)
    elif region == "lower left":
        idx = (right <= width / 2) & (df["top"] >= height / 2)
    elif region == "lower right":
        idx = (df["left"] <= width / 2) & (df["top"] >= height / 2)
    else:
        raise ValueError(f"unknown region {region!r}")
    return df.with_column("right", right).with_column("bottom", bottom).take(idx)


def calculate_query(df: Frame, ts_range: np.ndarray, targets: Sequence[int]):
    """BP per slot (bool array over ts_range) + GC scalar (reference:
    parse.py calculate_query).

    A slot takes the detections whose timestamp equals its value exactly
    (pd.DataFrame.update's index alignment); every other slot stays
    False / 0. The JAX package's `ffill().bfill()` after the update never
    finds a missing value (the slots start at False, and update writes
    no NaN), so it has no counterpart here."""
    bp = np.zeros(len(ts_range), bool)
    if len(df) == 0:
        return bp, 0.0
    hit = np.isin(df["class_id"], targets)
    stamps, inv = np.unique(df.index, return_inverse=True)
    any_hit = np.zeros(len(stamps), bool)
    np.logical_or.at(any_hit, inv, hit)
    counts = np.zeros(len(stamps), np.int64)
    np.add.at(counts, inv, hit.astype(np.int64))

    pos = np.searchsorted(stamps, ts_range)
    pos_c = np.minimum(pos, len(stamps) - 1)
    on = (pos < len(stamps)) & (stamps[pos_c] == ts_range)
    bp[on] = any_hit[pos_c[on]]
    gc = np.zeros(len(ts_range), np.int64)
    gc[on] = counts[pos_c[on]]
    return bp, float(gc.mean())


@dataclasses.dataclass
class QueryResult:
    bp_accuracy: float
    gc_error: float
    bp_accuracy_local: float
    gc_error_local: float
    num_slots: int


def parse_query(
    gt_df: Frame,
    cova_df: Frame,
    duration_seconds: float,
    targets: Sequence[int],
    exclude: Iterable = (),
    region: str = "upper left",
    frame_size=(1280, 640),
    ts_start: float = 0.0,
    ts_end: float | None = None,
) -> QueryResult:
    """Full BP/GC/BPL/GCL evaluation (reference: parse.py parse_query).

    ts_start/ts_end restrict the evaluation grid to slots in
    [ts_start, ts_end) — used for held-out evaluation (train/tune on a
    clip prefix, score the unseen suffix; the offline analog of the
    reference's train-one-day/eval-other-days methodology,
    parse/accuracy.py:27-92). The grid is still generated from 0 and
    then filtered, so slot values stay float-identical to the full-clip
    evaluation (detection timestamps must match grid values exactly to
    register)."""
    ts_max = max(
        duration_seconds,
        float(gt_df.index.max()) if len(gt_df) else 0.0,
    )
    ts_range = arange_ts(0.0, ts_max)
    if ts_start > 0.0:
        ts_range = ts_range[ts_range >= ts_start - 1e-9]
    if ts_end is not None:
        ts_range = ts_range[ts_range < ts_end - 1e-9]

    gt = exclude_regions(gt_df, exclude)
    cova = exclude_regions(cova_df, exclude)

    gt_bp, gt_gc = calculate_query(gt, ts_range, targets)
    cv_bp, cv_gc = calculate_query(cova, ts_range, targets)
    bp_acc = float((gt_bp == cv_bp).sum() / len(gt_bp))
    gc_err = abs(gt_gc - cv_gc)

    gt_l = local_region(gt, region, *frame_size)
    cv_l = local_region(cova, region, *frame_size)
    gt_bp_l, gt_gc_l = calculate_query(gt_l, ts_range, targets)
    cv_bp_l, cv_gc_l = calculate_query(cv_l, ts_range, targets)
    bp_acc_l = float((gt_bp_l == cv_bp_l).sum() / len(gt_bp_l))
    gc_err_l = abs(gt_gc_l - cv_gc_l)

    return QueryResult(bp_acc, gc_err, bp_acc_l, gc_err_l, len(ts_range))

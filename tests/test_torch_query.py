"""The PyTorch port's query layer (cova_tpu_torch/query/) against the JAX
package's (pandas) on the CPU.

* `parse_query` equals JAX's bit for bit (four floats and num_slots) on
  the committed CSVs of every golden, and reproduces each report.json to
  4 decimals as tests/test_accuracy_golden.py does for JAX;
* the CSV reader's `pandas_float` gives pandas' default converter's
  double on every float cell of every golden CSV (439,778 cells) and on
  drawn decimal strings (more than 17 digits, leading zeros, exponents,
  signs); the round-trip reader is `float`;
* `exclude_regions`, `local_region` and `calculate_query` equal JAX's on
  seeded tables;
* the query modules import without pandas.
"""

import dataclasses
import json
import pathlib
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from cova_tpu.query import metrics as jm
from cova_tpu.query.datasets import DATASETS
from cova_tpu_torch.query import metrics as tm

REPO = pathlib.Path(__file__).resolve().parent.parent
GOLDEN = REPO / "golden"
CSVS = sorted(GOLDEN.glob("*/*.csv"))

# (golden directory, ground-truth directory, dataset, window): demo_tuned
# and demo_holdout share demo's ground truth (test_accuracy_golden.py).
CASES = [
    ("demo", "demo", "demo", {}),
    ("demo2", "demo2", "demo2", {}),
    ("demo1080", "demo1080", "demo1080", {}),
    ("synth", "synth", "synth", {}),
    ("demo_tuned", "demo", "demo", {}),
    ("demo_holdout", "demo", "demo", {}),
    ("demo_holdout", "demo", "demo", {"ts_start": 40.0}),
    ("demo_holdout", "demo", "demo", {"ts_end": 40.0}),
]


def _duration(report):
    # The demo clips' grid is 1802 frames (test_accuracy_golden.py); the
    # re-encoded streams record theirs.
    return report.get("duration_seconds", 1802 / 30.0)


def _query(mod, golden, gt_dir, dataset, window):
    report = json.loads((GOLDEN / golden / "report.json").read_text())
    ds = DATASETS[dataset]
    res = mod.parse_query(
        mod.load_boxes_csv(GOLDEN / gt_dir / "dnn_gt.csv"),
        mod.load_cova(GOLDEN / golden),
        _duration(report), list(ds.targets),
        exclude=ds.exclude, region=ds.region, frame_size=ds.frame_size, **window,
    )
    return res, report


@pytest.mark.parametrize("golden,gt_dir,dataset,window", CASES)
def test_parse_query_matches_jax(golden, gt_dir, dataset, window):
    got, _ = _query(tm, golden, gt_dir, dataset, window)
    ref, _ = _query(jm, golden, gt_dir, dataset, window)
    assert dataclasses.astuple(got) == dataclasses.astuple(ref)
    assert all(type(a) is type(b)
               for a, b in zip(dataclasses.astuple(got), dataclasses.astuple(ref)))


@pytest.mark.parametrize("golden,gt_dir,dataset,window", CASES)
def test_report_reproduced_from_csvs(golden, gt_dir, dataset, window):
    res, report = _query(tm, golden, gt_dir, dataset, window)
    sfx = ("_holdout" if "ts_start" in window else "_prefix" if "ts_end" in window else "")
    for key in ("bp_accuracy", "gc_error", "bp_accuracy_local", "gc_error_local",
                "num_slots"):
        if f"{key}{sfx}" in report:
            got = getattr(res, key)
            assert (round(got, 4) if key != "num_slots" else got) == report[f"{key}{sfx}"], key


def test_round_trip_parse_would_miss_the_goldens():
    """The trap the reader exists for: read exactly (`float`), the demo
    GT lands on the grid more often and BP/GC move."""
    ds = DATASETS["demo"]
    kw = dict(exclude=ds.exclude, region=ds.region, frame_size=ds.frame_size)
    args = (1802 / 30.0, list(ds.targets))
    cova = tm.load_cova(GOLDEN / "demo")
    pandas_parse = tm.parse_query(tm.load_boxes_csv(GOLDEN / "demo" / "dnn_gt.csv"),
                                  cova, *args, **kw)
    exact = tm.parse_query(tm.load_boxes_csv(GOLDEN / "demo" / "dnn_gt.csv", parse=float),
                           cova, *args, **kw)
    assert dataclasses.astuple(pandas_parse) != dataclasses.astuple(exact)
    gt = tm.read_csv(GOLDEN / "demo" / "dnn_gt.csv")["timestamp"]
    gt_exact = tm.read_csv(GOLDEN / "demo" / "dnn_gt.csv", parse=float)["timestamp"]
    grid = tm.arange_ts(0.0, 1802 / 30.0)
    assert 1000 < int((gt != gt_exact).sum()) < 1200  # 1,103 of 8,249 rows
    assert np.isin(gt, grid).mean() < np.isin(gt_exact, grid).mean()


def _same(a, b):
    """Bit-equal float64 arrays, NaN equal to NaN."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return a.shape == b.shape and bool(
        ((a.view(np.int64) == b.view(np.int64)) | (np.isnan(a) & np.isnan(b))).all())


@pytest.mark.parametrize("path", CSVS, ids=lambda p: f"{p.parent.name}/{p.name}")
def test_reader_matches_pandas_default(path):
    ref = pd.read_csv(path)
    got = tm.read_csv(path)
    assert list(got) == list(ref.columns)
    for col in ref.columns:
        assert _same(got[col], ref[col].to_numpy(np.float64)), col


@pytest.mark.parametrize("path", CSVS, ids=lambda p: f"{p.parent.name}/{p.name}")
def test_round_trip_reader_matches_pandas_round_trip(path):
    ref = pd.read_csv(path, float_precision="round_trip")
    got = tm.read_csv(path, parse=float)
    for col in ref.columns:
        assert _same(got[col], ref[col].to_numpy(np.float64)), col


def test_every_golden_float_cell_counted():
    """The float cells of the goldens the reader is held on: 439,778, of
    which pandas reads about one timestamp in eight an ulp off."""
    cells = off = 0
    for path in CSVS:
        ref = pd.read_csv(path)
        exact = tm.read_csv(path, parse=float)
        for col in ref.columns:
            if ref[col].dtype == np.float64:
                v = ref[col].to_numpy()
                cells += int((~np.isnan(v)).sum())
                off += int((v != exact[col])[~np.isnan(v)].sum())
    assert cells == 439_778
    assert off > 10_000


_digits = st.text("0123456789", min_size=0, max_size=26)


@st.composite
def decimal_strings(draw):
    sign = draw(st.sampled_from(["", "+", "-"]))
    zeros = "0" * draw(st.integers(0, 20))
    whole = zeros + draw(_digits)
    frac = draw(st.one_of(st.none(), _digits))
    if not (whole or frac):
        whole = "0"
    text = sign + whole + ("" if frac is None else "." + frac)
    if draw(st.booleans()):
        exp = draw(st.integers(-250, 250))
        esign = "+" if exp >= 0 and draw(st.booleans()) else ""
        text += draw(st.sampled_from("eE")) + esign + str(exp)
    return text


@settings(max_examples=60, deadline=None)
@given(texts=st.lists(decimal_strings(), min_size=1, max_size=40))
def test_pandas_float_on_drawn_strings(texts, tmp_path_factory):
    path = tmp_path_factory.mktemp("drawn") / "x.csv"
    # A fraction in the column makes pandas read every cell as a float.
    path.write_text("x\n0.5\n" + "\n".join(texts) + "\n")
    ref = pd.read_csv(path)["x"]
    assert ref.dtype == np.float64
    got = np.array([tm.pandas_float(t) for t in texts])
    assert _same(got, ref.to_numpy()[1:]), list(zip(texts, got, ref.to_numpy()[1:]))


@settings(max_examples=40, deadline=None)
@given(values=st.lists(st.floats(allow_nan=False, allow_infinity=False, width=64), min_size=1,
                max_size=40))
def test_round_trip_reader_is_float(values, tmp_path_factory):
    """The round-trip reader gives back every double the aggregator
    wrote (repr), as float() and pandas' round_trip converter do."""
    path = tmp_path_factory.mktemp("floats") / "x.csv"
    path.write_text("x\n0.5\n" + "\n".join(repr(v) for v in values) + "\n")
    got = tm.read_csv(path, parse=float)["x"][1:]
    assert _same(got, values)
    ref = pd.read_csv(path, float_precision="round_trip")["x"].to_numpy()[1:]
    assert _same(got, ref)


def test_pandas_float_rejects_what_pandas_does():
    for bad in ("", ".", "-", "1e", "1.2.3", "abc", "1e400", "1x"):
        with pytest.raises(ValueError):
            tm.pandas_float(bad)
    # Digits past the 17th: integer ones scale, fraction ones drop.
    assert tm.pandas_float("123456789012345678901") == pd.read_csv(
        __import__("io").StringIO("x\n0.5\n123456789012345678901\n"))["x"][1]


def _seeded(seed, n=400):
    rng = np.random.default_rng(seed)
    grid = jm.arange_ts(0.0, 10.0)
    ts = rng.choice(grid, n)
    off = rng.random(n) < 0.2
    ts[off] = ts[off] + rng.choice([1e-12, -1e-9, 0.01], off.sum())  # off the grid
    cols = {
        "left": rng.integers(-30, 1300, n).astype(float),
        "top": rng.integers(-30, 740, n).astype(float),
        "width": rng.integers(1, 400, n).astype(float),
        "height": rng.integers(1, 300, n).astype(float),
        "class_id": rng.choice([0, 2, 5], n).astype(float),
    }
    jdf = pd.DataFrame({**cols, "timestamp": ts}).set_index("timestamp").sort_index(
        kind="stable")
    tdf = tm.Frame(cols, ts).sort_index()
    return jdf, tdf


def _frames_equal(jdf, tdf):
    assert _same(jdf.index.to_numpy(), tdf.index)
    for col in jdf.columns:
        assert _same(jdf[col].to_numpy(), tdf[col]), col


@pytest.mark.parametrize("seed", [0, 1])
def test_exclude_regions_matches_jax(seed):
    jdf, tdf = _seeded(seed)
    for regions in ((), DATASETS["demo"].exclude, DATASETS["demo1080"].exclude,
                    (((0, 0), (1280, 720)),)):
        _frames_equal(jm.exclude_regions(jdf, regions), tm.exclude_regions(tdf, regions))


@pytest.mark.parametrize("region", ["upper left", "upper right", "lower left",
                                    "lower right"])
def test_local_region_matches_jax(region):
    jdf, tdf = _seeded(2)
    for size in ((1280, 640), (1280, 720), (1920, 960)):
        _frames_equal(jm.local_region(jdf, region, *size), tm.local_region(tdf, region, *size))
    with pytest.raises(ValueError):
        tm.local_region(tdf, "middle")


def test_lower_right_keeps_the_reference_quirk():
    """'lower right' tests left <= w/2 (the reference's code), so a box
    wholly in the lower LEFT quadrant counts there too."""
    tdf = tm.Frame({"left": [10.0], "top": [500.0], "width": [20.0], "height": [20.0],
                    "class_id": [2.0]}, [0.0])
    assert len(tm.local_region(tdf, "lower right", 1280, 640)) == 1
    assert len(tm.local_region(tdf, "lower left", 1280, 640)) == 1


@pytest.mark.parametrize("seed", [3, 4])
@pytest.mark.parametrize("window", [(0.0, None), (2.0, None), (0.0, 7.0), (3.1, 3.2)])
def test_calculate_query_matches_jax(seed, window):
    jdf, tdf = _seeded(seed)
    grid = jm.arange_ts(0.0, 10.0)
    lo, hi = window
    grid = grid[grid >= lo - 1e-9] if lo > 0 else grid
    grid = grid[grid < hi - 1e-9] if hi is not None else grid
    for targets in ([2], [5], [2, 5], [7]):
        jbp, jgc = jm.calculate_query(jdf, grid, targets)
        tbp, tgc = tm.calculate_query(tdf, grid, targets)
        assert np.array_equal(tbp, jbp.values[:, 0].astype(bool))
        assert tgc == jgc and type(tgc) is type(jgc)


def test_calculate_query_empty_and_off_grid():
    grid = jm.arange_ts(0.0, 2.0)
    empty_j = jm.exclude_regions(_seeded(5)[0], (((-100, -100), (5000, 5000)),))
    empty_t = tm.exclude_regions(_seeded(5)[1], (((-100, -100), (5000, 5000)),))
    assert len(empty_t) == 0 == len(empty_j)
    jbp, jgc = jm.calculate_query(empty_j, grid, [2])
    tbp, tgc = tm.calculate_query(empty_t, grid, [2])
    assert (tbp == jbp.values[:, 0]).all() and not tbp.any() and tgc == jgc == 0.0
    # A detection an ulp off a slot registers nowhere.
    ts = np.nextafter(grid[4], 1.0)
    tdf = tm.Frame({"class_id": [2.0]}, [ts])
    jdf = pd.DataFrame({"class_id": [2.0]}, index=[ts])
    tbp, tgc = tm.calculate_query(tdf, grid, [2])
    jbp, jgc = jm.calculate_query(jdf, grid, [2])
    assert not tbp.any() and tgc == jgc == 0.0 and not jbp.values.any()


def test_load_cova_matches_jax(tmp_path):
    """assoc.csv alone, assoc + stationary, and an empty run."""
    for sub, files in (("both", ("assoc.csv", "stationary.csv")), ("assoc", ("assoc.csv",))):
        d = tmp_path / sub
        d.mkdir()
        for f in files:
            (d / f).write_bytes((GOLDEN / "synth" / f).read_bytes())
        j, t = jm.load_cova(d), tm.load_cova(d)
        assert len(j) == len(t)
        assert _same(np.sort(j.index.to_numpy()), np.sort(t.index))
        for col in ("left", "top", "width", "height", "class_id"):
            assert _same(np.sort(j[col].to_numpy()), np.sort(t[col])), col
    d = tmp_path / "empty"
    d.mkdir()
    (d / "assoc.csv").write_text(
        "left,top,width,height,area,track_id,timestamp,class_id,confidence\n")
    assert len(tm.load_cova(d)) == 0 == len(jm.load_cova(d))
    grid = tm.arange_ts(0.0, 1.0)
    assert tm.calculate_query(tm.load_cova(d), grid, [2])[1] == 0.0


def test_query_modules_import_without_pandas():
    code = (
        "import sys\n"
        "sys.modules['pandas'] = None\n"
        "import cova_tpu_torch.query, cova_tpu_torch.query.metrics\n"
        "import cova_tpu_torch.query.datasets\n"
        "import cova_tpu_torch.examples.accuracy, cova_tpu_torch.examples.sweep_accuracy\n"
        "import cova_tpu_torch.examples.reproduce_synth, cova_tpu_torch.examples.run_experiment\n"
        "import cova_tpu_torch.examples.reproduce_accuracy\n"
        "from cova_tpu_torch.query.metrics import load_boxes_csv, load_cova, parse_query\n"
        "gt = load_boxes_csv('golden/synth/dnn_gt.csv')\n"
        "res = parse_query(gt, load_cova('golden/synth'), 60.06666666666666, [2],\n"
        "                  region='lower right', frame_size=(1280, 720))\n"
        "print(round(res.bp_accuracy, 4))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "0.9878"

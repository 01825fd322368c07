"""The PyTorch port's standalone tracking pipeline and square auction
against the JAX package, on the CPU.

* `SortPipeline` on a generated PAFF clip, with JAX's
  `create_blobnet(PRNGKey(0))` weights carried across: the track CSV
  byte-identical to JAX's.
* `solve_assignment`: the same permutation as JAX's on the reference's
  four Hungarian cases (zero-padded to square) and on seeded random
  square costs, with and without the eps ladder.
"""

import dataclasses
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cova_tpu.config as jcfg
import cova_tpu_torch.config as tcfg
from cova_tpu.models import blobnet as jbn
from cova_tpu.ops.assignment import solve_assignment as jax_solve_assignment
from cova_tpu.pipeline.sort_pipeline import SortPipeline as JaxSortPipeline
from cova_tpu_torch.models import blobnet as tbn
from cova_tpu_torch.ops.assignment import solve_assignment
from cova_tpu_torch.pipeline.sort_pipeline import SortPipeline

# The suite runs one test worker per core: keep torch to one thread each.
torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent


def _sort_cfg(mod):
    c = mod.CovaConfig()
    return dataclasses.replace(
        c,
        sort=mod.SortConfig(min_hits=3, max_age=10),
        compressed=dataclasses.replace(c.compressed, batch_frames=64),
    )


def test_sort_pipeline_csv_matches_jax(tmp_path):
    from cova_tpu_torch.utils.mp4loop import mux_rec_to_mp4

    spec = importlib.util.spec_from_file_location(
        "paff_gen", REPO / "cova_tpu" / "csrc" / "tools" / "paff_gen.py"
    )
    pg = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(pg)
    rec, mp4 = tmp_path / "paff.rec", str(tmp_path / "paff.mp4")
    pg.scenario_pipeline(16, 8, 160, 16).write_rec(str(rec))
    mux_rec_to_mp4(str(rec), mp4)

    _, jvars = jbn.create_blobnet(jax.random.PRNGKey(0))
    npz = tmp_path / "init.npz"
    jbn.save_params_npz(str(npz), jvars)
    _, sd, _ = tbn.load_artifact(npz, "cpu")

    quiet = dict(log=lambda *_: None)
    res = SortPipeline(mp4, str(tmp_path / "torch.csv"), _sort_cfg(tcfg), sd,
                       device="cpu", **quiet).run()
    jres = JaxSortPipeline(
        mp4, str(tmp_path / "jax.csv"), _sort_cfg(jcfg), jvars, **quiet
    ).run()
    assert res.num_frames == jres.num_frames == 320 - 3  # one window per field
    assert res.dead_tracks == jres.dead_tracks > 0
    got = (tmp_path / "torch.csv").read_bytes()
    assert got == (tmp_path / "jax.csv").read_bytes()
    assert len(got.splitlines()) > 1


def _hungarian_cases():
    """The reference's four Hungarian cases, zero-padded to square."""
    cases = {}
    c = np.full((5, 5), 2.0, np.float32)
    for i, j in [(0, 0), (1, 1), (2, 3)]:
        c[i, j] = 1.0
    cases["5x5"] = c
    for name, (n_rows, n_cols), hits in [
        ("2x3", (2, 3), [(0, 0), (1, 2)]),
        ("3x2", (3, 2), [(0, 0), (2, 1)]),
        ("9x8", (9, 8), [(0, 0), (1, 1), (2, 2), (4, 3), (5, 4), (6, 5), (7, 6), (8, 7)]),
    ]:
        base = np.full((n_rows, n_cols), 1.0, np.float32)
        for i, j in hits:
            base[i, j] = 0.0
        n = max(n_rows, n_cols)
        sq = np.zeros((n, n), np.float32)
        sq[:n_rows, :n_cols] = base
        cases[name] = sq
    return cases


@pytest.mark.parametrize("case", ["5x5", "2x3", "3x2", "9x8"])
def test_solve_assignment_hungarian_cases_match_jax(case):
    cost = _hungarian_cases()[case]
    got = solve_assignment(torch.from_numpy(cost))
    ref = np.asarray(jax_solve_assignment(jnp.asarray(cost)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    assert sorted(got.tolist()) == list(range(len(cost)))


@pytest.mark.parametrize("phases", [1, 3])
@pytest.mark.parametrize("eps", [1e-2, 1e-5])
@pytest.mark.parametrize("s", [16, 64])
def test_solve_assignment_random_matches_jax(s, eps, phases):
    rng = np.random.default_rng(s * 10 + phases)
    cost = rng.uniform(0, 2, (s, s)).astype(np.float32)
    got = solve_assignment(torch.from_numpy(cost), eps=eps, phases=phases)
    ref = np.asarray(jax_solve_assignment(jnp.asarray(cost), eps=eps, phases=phases))
    np.testing.assert_array_equal(got.numpy(), ref)
    assert sorted(got.tolist()) == list(range(s))


def test_solve_assignment_completes_at_the_bound():
    """A bound too small to finish: unassigned rows are rank-matched to
    the free columns, as in JAX."""
    rng = np.random.default_rng(5)
    cost = rng.uniform(0, 2, (32, 32)).astype(np.float32)
    got = solve_assignment(torch.from_numpy(cost), eps=1e-5, max_iters=2)
    ref = np.asarray(jax_solve_assignment(jnp.asarray(cost), eps=1e-5, max_iters=2))
    np.testing.assert_array_equal(got.numpy(), ref)
    assert sorted(got.tolist()) == list(range(32))
    with pytest.raises(ValueError, match="square"):
        solve_assignment(torch.zeros((3, 4)))

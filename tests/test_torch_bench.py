"""The port's headline bench (`cova_tpu_torch/bench.py`) against the JAX
package's bench.py on the CPU.

* The range plan's ranges (pipeline/ranges.py) and every wire16 chunk
  the port's `fill_chunk` writes into its reused buffers equal chunks
  decoded by the JAX package's `Mp4Demuxer` into fresh ones, on both
  committed renders at the production R=8, F=128.
* At a cut configuration (R=2, F=16) on the heads of the 720p render's
  first two GoPs: the packed masks of every chunk equal the JAX
  `CompressedStage.run_chunk_masks` bytes, and a `one_pass` retires the
  same host-SORT tracks as bench.py's loop run on the JAX stage's masks.
* The CLI with --device cpu prints one JSON line whose keys are those of
  bench.py's `json.dumps` dict (read with ast), less the two calibration
  keys, and `cpu_probe` is bench.py's probe.
"""

import ast
import dataclasses
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cova_tpu.config as jcfg
from cova_tpu.codec import Mp4Demuxer as JaxMp4Demuxer
from cova_tpu.models import blobnet as jbn
from cova_tpu.pipeline.compressed import CompressedStage as JaxCompressedStage
from cova_tpu.pipeline.compressed import unpack_masks as jax_unpack_masks
from cova_tpu.tracker.host import HostSort as JaxHostSort
from cova_tpu.tracker.host import cc_boxes as jax_cc_boxes
from cova_tpu.utils.mp4loop import write_mp4
from cova_tpu_torch import bench
from cova_tpu_torch.config import ParallelConfig
from cova_tpu_torch.models.blobnet import load_meta_npz
from cova_tpu_torch.pipeline.ranges import RangePlan

# The suite runs one test worker per core: keep torch to one thread each.
torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
DATA = REPO / "cova_tpu_torch" / "data"
RENDERS = (DATA / "synth_1800.mp4", DATA / "synth_1800_1080p.mp4")
CALIBRATION_KEYS = {"value_calib_normalized", "calib_ref_mips"}
R, F = 2, 16


def gop_heads(src, dst, k, gops=2):
    """An mp4 of the first `k` decode-order samples of each of `src`'s
    first `gops` GoPs, timestamps shifted so each head follows the last.
    `k` must end a head where its display order is whole (frames 0..k-1
    of the GoP)."""
    d = JaxMp4Demuxer(str(src))
    delta = d.sample(1).dts - d.sample(0).dts
    samples, shift = [], 0
    for g in d.gops()[:gops]:
        s0 = g.first_sample
        base = d.sample(s0).pts
        pts = [d.sample(s0 + i).pts for i in range(k)]
        assert sorted((p - base) // delta for p in pts) == list(range(k))
        for i in range(k):
            s = d.sample(s0 + i)
            samples.append((d.read_sample(s0 + i), s.pts - shift, s.dts - shift, s.keyframe))
        shift += (g.num_samples - k) * delta
    write_mp4(str(dst), samples, d.timescale, d.width, d.height, d.extradata())
    d.close()
    return dst


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """65 frames of each of the 720p render's first two GoPs."""
    return gop_heads(RENDERS[0], tmp_path_factory.mktemp("heads") / "heads.mp4", 65)


@pytest.fixture
def small(monkeypatch):
    """The bench's configuration cut for the CPU: R=2 ranges, chunks of
    F=16 windows."""
    full = bench.bench_cfg

    def cut(meta):
        cfg = full(meta)
        return dataclasses.replace(
            cfg, parallel=ParallelConfig(num_ranges=R),
            compressed=dataclasses.replace(cfg.compressed, batch_frames=F))

    monkeypatch.setattr(bench, "bench_cfg", cut)


def _jax_ranges(demux, nr, t):
    """bench.py's make_ranges, outside its closure."""
    gops = demux.gops()
    per_gop = max(1, -(-len(gops) // nr))
    b = [(gops[i].first_sample, sum(g.num_samples for g in gops[i : i + per_gop]))
         for i in range(0, len(gops), per_gop)]
    b = (b + [(demux.num_samples, 0)] * nr)[:nr]
    return b, [max(0, c - t + 1) for _, c in b]


def _jax_chunk(demux, bounds, wmax, off, cfg, nr):
    """One chunk as bench.py decodes it, into a fresh buffer."""
    f, t = cfg.compressed.batch_frames, cfg.video.timestep
    c = np.zeros((nr, f + t - 1, demux.mb_height, demux.mb_width, 2), np.uint8)
    if cfg.compressed.signed_mv:
        c[..., 1] = 0x88
    for ri, (s0, cnt) in enumerate(bounds):
        count = min(f + t - 1, cnt - off)
        if count > 0 and off < wmax[ri]:
            demux.entropy_decode_packed16(
                demux.display_order(s0, cnt)[off : off + count],
                with_nnz=cfg.compressed.use_nnz_channel, signed_mv=cfg.compressed.signed_mv,
                threads=4, out=c[ri, :count])
    return c


def _jax_cfg(cfg):
    """The JAX package's CovaConfig with the port config's values."""
    return jcfg.CovaConfig.from_dict(
        {k: v for k, v in dataclasses.asdict(cfg).items() if k != "last"})


@pytest.mark.parametrize("video", RENDERS, ids=("720p", "1080p"))
def test_ranges_and_chunks_equal_the_jax_demuxers(video):
    from cova_tpu_torch.codec import Mp4Demuxer

    meta = {"use_nnz_channel": True, "signed_mv": True}
    cfg = bench.bench_cfg(meta)
    demux = Mp4Demuxer(str(video))
    b = bench.Bench(str(video), demux, cfg, None, torch.device("cpu"), 4,
                    RangePlan.build([demux], cfg), None)
    jd = JaxMp4Demuxer(str(video))
    bounds, wmax = _jax_ranges(jd, 8, 4)
    assert [(s, c) for _, s, c in b.plan.bounds] == bounds and b.plan.windows == wmax
    assert sum(sum(b.plan.chunk_windows(ci)) for ci in range(b.plan.n_chunks)) == sum(wmax)
    assert sum(wmax) == sum(max(0, c - 3) for _, c in bounds) == 7 * 247 + 47
    bufs = [bench.fresh_chunk(b, 8) for _ in (0, 1)]
    prev_n = [[0] * 8, [0] * 8]
    n = 0
    for ci, off in enumerate(range(0, max(wmax), 128)):
        got = bufs[ci & 1].numpy()
        bench.fill_chunk(b, got, prev_n[ci & 1], ci, b.plan)
        assert np.array_equal(got, _jax_chunk(jd, bounds, wmax, off, _jax_cfg(cfg), 8)), ci
        n += 1
    assert n == 2


@pytest.fixture(scope="module")
def jax_run(clip):
    """bench.py's pass on the JAX package's stage at the cut
    configuration: every chunk's packed masks, and the host SORT's
    retired tracks by range."""
    meta = load_meta_npz(bench.WEIGHTS)
    model = jbn.BlobNet(jbn.BlobNetConfig(in_channels=int(meta["in_channels"])))
    # A shape-only template: an eager Flax init costs dozens of compiles.
    template = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4, 45, 80, 4)), train=False))
    variables = jbn.load_params_npz(str(bench.WEIGHTS), template)
    cfg = jcfg.CovaConfig(
        parallel=jcfg.ParallelConfig(num_ranges=R),
        compressed=jcfg.CompressedStageConfig(
            cc_threshold=bench.CC_THRESHOLD, batch_frames=F,
            use_nnz_channel=bool(meta["use_nnz_channel"]), signed_mv=bool(meta["signed_mv"])))
    stage = JaxCompressedStage(model, variables, cfg, R)
    demux = JaxMp4Demuxer(str(clip))
    bounds, wmax = _jax_ranges(demux, R, 4)
    dead = []
    trackers = [JaxHostSort(cfg.sort, on_dead=lambda rec, ri=ri: dead.append((ri, rec)))
                for ri in range(R)]
    packed = []
    for off in range(0, max(wmax), F):
        packed.append(np.asarray(stage.run_chunk_masks(
            _jax_chunk(demux, bounds, wmax, off, cfg, R))))
        masks = jax_unpack_masks(packed[-1], stage.masks_shape)
        ltwh, _, valid = jax_cc_boxes(masks.reshape(R * F, *masks.shape[2:]), 3, 16)
        for ri in range(R):
            nf = min(F, wmax[ri] - off)
            if nf > 0:
                trackers[ri].update_batch(ltwh.reshape(R, F, 16, 4)[ri, :nf],
                                          valid.reshape(R, F, 16)[ri, :nf], float(off))
    for tr in trackers:
        tr.finalize()
    return cfg, packed, dead, sum(wmax)


def test_every_chunks_masks_and_the_dead_tracks_equal_jax(clip, small, jax_run):
    jax_cfg, ref_packed, ref_dead, windows = jax_run
    b = bench.setup(clip, "cpu")
    assert _jax_cfg(b.cfg) == jax_cfg
    assert b.plan.bounds == [(0, 0, 65), (0, 65, 65)]
    prev_n = [0] * R
    chunk = bench.fresh_chunk(b, R)
    offs = list(range(0, max(b.plan.windows), F))
    assert len(offs) == len(ref_packed) == b.plan.n_chunks == 4
    for ci, ref in enumerate(ref_packed):
        bench.fill_chunk(b, chunk.numpy(), prev_n, ci, b.plan)
        got = b.stage.run_chunk_masks(bench.upload(b, chunk)).numpy()
        assert np.array_equal(got, ref), offs[ci]

    dead = []
    processed, elapsed, stages = bench.one_pass(b, on_dead=lambda ri, rec: dead.append((ri, rec)))
    assert processed == windows == 2 * 62
    assert elapsed > 0 and set(stages) == set(bench.STAGES)
    assert len(ref_dead) > 0
    assert [(ri, dataclasses.astuple(rec)) for ri, rec in dead] == [
        (ri, dataclasses.astuple(rec)) for ri, rec in ref_dead]


def _bench_py_keys():
    """bench.py's json.dumps dict: its literal keys, and the keys of the
    dict it splats in when a sweep ran."""
    tree = ast.parse((REPO / "bench.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "dumps"
                and node.args and isinstance(node.args[0], ast.Dict)):
            d = node.args[0]
            keys = [k.value for k in d.keys if k is not None]
            splat = [k.value for v, k0 in zip(d.values, d.keys) if k0 is None
                     for k in v.body.keys]
            return keys, splat
    raise AssertionError("no json.dumps dict in bench.py")


@pytest.mark.parametrize("sweep", [[], ["--sweep", "1"]], ids=("plain", "sweep"))
def test_cli_prints_bench_pys_keys(clip, small, capsys, sweep):
    out = bench.main(["--input", str(clip), "--device", "cpu", "--passes", "1",
                      "--device-reps", "1"] + sweep)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == out
    keys, splat = _bench_py_keys()
    want = [k for k in keys if k not in CALIBRATION_KEYS]
    assert len(keys) - len(want) == 2 and splat == ["device_fps_sweep_by_R"]
    assert set(out) == set(want) | (set(splat) if sweep else set())
    assert out["platform"] == "cpu" and out["input"]["device"] == "cpu"
    assert out["frames_per_pass"] == 2 * 62
    assert len(out["passes_fps"]) == 1 and len(out["device_fps_passes"]) == 3
    assert set(out["stage_seconds"]) == set(bench.STAGES)
    if sweep:
        assert list(out["device_fps_sweep_by_R"]) == ["1"]


def test_cpu_probe_is_bench_pys():
    """The port's cpu_probe runs bench.py's closure's statements."""
    def body(fn):
        stmts = fn.body[1:] if isinstance(fn.body[0].value, ast.Constant) else fn.body
        return [ast.dump(s) for s in stmts]

    tree = ast.parse((REPO / "bench.py").read_text())
    jax_fn = next(n for n in ast.walk(tree)
                  if isinstance(n, ast.FunctionDef) and n.name == "cpu_probe")
    port = ast.parse(pathlib.Path(bench.__file__).read_text())
    port_fn = next(n for n in port.body
                   if isinstance(n, ast.FunctionDef) and n.name == "cpu_probe")
    assert body(port_fn) == body(jax_fn)
    assert bench.cpu_probe() > 0

"""The port's instruments on the CPU: `examples/profile_device.py` and
`examples/soak.py`.

* Each profile probe's scalar equals the JAX expression it mirrors
  (examples/profile_device.py's p_masks, p_labels, p_stats, p_sort and
  the full run's packed sum) on the same chunk of the committed synth
  render. JAX labels CC with a fixed 32 sweeps on the CPU, the port until
  nothing changes: the test first shows that 32 sweeps have converged on
  these masks.
* The profile CLI with --device cpu prints the JAX script's probe lines
  and deltas keys.
* `write_looped_mp4` on the synth render (the soak's input on the card)
  keeps its avcC, GoP table, bytes and clock.
* `soak` on a PAFF clip looped twice: the JAX script's report keys,
  twice the clip's frames, the four CSVs of CovaPipeline on the same
  looped file, and exit 1 over an RSS budget of -1 MB.
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
from cova_tpu.models import blobnet as jbn
from cova_tpu.ops.cc import connected_components as jax_connected_components
from cova_tpu.ops.cc import mask_to_boxes as jax_mask_to_boxes
from cova_tpu.ops.preprocess import metapreprocess, unpack_wire16
from cova_tpu.pipeline.compressed import CompressedStage as JaxCompressedStage
from cova_tpu.pipeline.compressed import compressed_stage_step as jax_stage_step
from cova_tpu_torch.codec import Mp4Demuxer
from cova_tpu_torch.examples import profile_device, soak
from cova_tpu_torch.models.blobnet import load_artifact

# The suite runs one test worker per core: keep torch to one thread each.
torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
CSVS = ("track", "dnn", "assoc", "stationary")
F = 6


def _jax_blobnet(meta):
    """The demo artifact through JAX's own loader, on a template built
    shape-only (an eager Flax init costs dozens of small compiles)."""
    model = jbn.BlobNet(jbn.BlobNetConfig(in_channels=int(meta["in_channels"])))
    template = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4, 45, 80, model.config.in_channels)), train=False))
    return model, jbn.load_params_npz(str(profile_device.DEMO_WEIGHTS), template)


def test_profile_probes_equal_the_jax_expressions():
    lines = []
    res = profile_device.profile(device="cpu", reps=1, batch_frames=F, pipelined_chunks=1,
                                 pipelined_runs=1, log=lines.append)
    assert [json.loads(ln).get("probe") for ln in lines] == [
        "masks", "+labels", "+stats", "+sort", "full+pull", "pipelined", None]

    _, _, meta = load_artifact(profile_device.DEMO_WEIGHTS, "cpu")
    tcfg = profile_device.profile_cfg(meta, F)
    c = jcfg.CovaConfig()
    cfg = dataclasses.replace(c, compressed=dataclasses.replace(
        c.compressed, **{k: getattr(tcfg.compressed, k) for k in (
            "cc_threshold", "host_tracking", "use_nnz_channel", "signed_mv", "batch_frames")}))
    chunk = profile_device.load_chunk(profile_device.SYNTH_RENDER, tcfg)
    model, variables = _jax_blobnet(meta)
    r, t = chunk.shape[0], cfg.video.timestep
    signed, nnz = cfg.compressed.signed_mv, cfg.compressed.use_nnz_channel

    # examples/profile_device.py's front(), p_masks, p_labels, p_stats, p_sort.
    @jax.jit
    def front(metadata):
        m = unpack_wire16(metadata, nnz, signed)
        x = jax.vmap(lambda a: metapreprocess(a, t, 1, signed))(m)
        x = x.reshape((r * F,) + x.shape[2:])
        return model.apply(variables, x, train=False) > cfg.compressed.mask_threshold

    @jax.jit
    def labels(masks):
        return (jax.vmap(lambda q: jax_connected_components(q, 32))(masks),
                jax.vmap(lambda q: jax_connected_components(q, 256))(masks))

    @jax.jit
    def p_stats(masks):
        boxes = jax_mask_to_boxes(masks, cfg.compressed.cc_threshold, backend="xla")
        return jnp.sum(boxes.area) + jnp.sum(boxes.valid)

    masks = front(jnp.asarray(chunk))
    fixed, settled = labels(masks)
    np.testing.assert_array_equal(np.asarray(fixed), np.asarray(settled))
    stage = JaxCompressedStage(model, variables, cfg, r)
    out = jax_stage_step(model, variables, cfg, jnp.asarray(chunk), stage.sort_state,
                         jnp.zeros((r,), jnp.int32))
    # The profile's full run: a warm-up and --reps runs on one stage, the
    # SORT state carried; the value is the last run's.
    for _ in range(2):
        full, _, _ = stage.run_chunk(chunk, np.zeros(r, np.int32))
    want = {
        "masks": int(jnp.sum(masks.astype(jnp.int32))),
        "+labels": int(np.asarray(fixed).astype(np.int64).sum()),
        "+stats": float(p_stats(masks)),
        "+sort": int(jnp.sum(out[1].astype(jnp.int32))),
        "full+pull": int(np.asarray(full).sum()),
    }
    assert res["values"] == want
    assert want["masks"] > 0 and want["+stats"] > 0
    assert res["report"]["chunk"] == [8, F, 45, 80] and res["report"]["device"] == "cpu"


def test_profile_plain_labelling_gives_the_same_values_and_cuda_needs_the_card():
    values = {}
    for backend in ("plain", "auto"):
        values[backend] = profile_device.profile(
            device="cpu", reps=1, cc_backend=backend, batch_frames=2, sort=False,
            log=lambda *_: None)["values"]
    assert values["plain"] == values["auto"] and set(values["auto"]) == {
        "masks", "+labels", "+stats"}
    with pytest.raises(ValueError, match="card"):
        profile_device.profile(device="cpu", reps=1, cc_backend="cuda", batch_frames=2,
                               log=lambda *_: None)


@pytest.fixture(scope="module")
def paff_clip(tmp_path_factory):
    """A 128-field PAFF clip in 8 GoPs of 8 frames."""
    from cova_tpu_torch.tools import paff_gen
    from cova_tpu_torch.utils.mp4loop import mux_rec_to_mp4

    tmp = tmp_path_factory.mktemp("paff")
    rec, mp4 = tmp / "paff.rec", tmp / "paff.mp4"
    paff_gen.scenario_pipeline(80, 46, 64, 8).write_rec(str(rec))
    mux_rec_to_mp4(str(rec), str(mp4))
    return mp4


def test_profile_cli_prints_the_probe_lines_and_deltas(paff_clip, capsys):
    profile_device.main(["--device", "cpu", "--reps", "1", "--input", str(paff_clip),
                         "--batch-frames", "2", "--pipelined-chunks", "1"])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [ln.get("probe") for ln in lines[:-1]] == [
        "masks", "+labels", "+stats", "+sort", "full+pull", "pipelined"]
    assert all(set(ln) == {"probe", "seconds", "all"} for ln in lines[:5])
    assert set(lines[5]) == {"probe", "fps", "all"} and len(lines[5]["all"]) == 3
    last = lines[-1]
    assert set(last) == {"device", "chunk", "cc_backend", "deltas", "pipelined_fps"}
    assert last["device"] == "cpu" and last["chunk"] == [8, 2, 46, 80]
    assert list(last["deltas"]) == ["blobnet_masks", "cc_labeling", "cc_stats", "sort_scan",
                                    "packed_transfer+rebuild"]


def test_looped_synth_render_keeps_its_tables(tmp_path):
    from cova_tpu_torch.utils.mp4loop import write_looped_mp4

    src = str(profile_device.SYNTH_RENDER)
    looped = str(tmp_path / "loop2.mp4")
    n = write_looped_mp4(src, looped, 2)
    a, b = Mp4Demuxer(src), Mp4Demuxer(looped)
    try:
        assert b.num_samples == 2 * a.num_samples == n == 3600
        assert b.extradata() == a.extradata()  # the avcC, verbatim
        ga, gb = a.gops(), b.gops()
        assert len(gb) == 2 * len(ga)
        assert [(g.first_sample - n // 2, g.num_samples) for g in gb[len(ga):]] == [
            (g.first_sample, g.num_samples) for g in ga]
        assert (a.width, a.height, a.timescale, a.mb_width, a.mb_height) == (
            b.width, b.height, b.timescale, b.mb_width, b.mb_height)
        for i in (0, 7, 1799):
            assert b.read_sample(n // 2 + i) == a.read_sample(i)
            sa, sb = a.sample(i), b.sample(n // 2 + i)
            assert sb.keyframe == sa.keyframe and sb.dts > sa.dts
            assert sb.pts - sb.dts == sa.pts - sa.dts
        order = b.display_order(0, n)
        pts = np.array([b.sample(int(i)).pts for i in order])
        assert (np.diff(pts) > 0).all()
        # The second repetition decodes to the first's metadata.
        idx = a.display_order(ga[1].first_sample, 20)
        np.testing.assert_array_equal(
            b.entropy_decode_packed16(np.asarray(idx) + n // 2, threads=4),
            a.entropy_decode_packed16(idx, threads=4))
    finally:
        a.close()
        b.close()


def _jax_report_keys():
    """The keys of the report dict in examples/soak.py."""
    tree = ast.parse((REPO / "examples" / "soak.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and getattr(node.targets[0], "id", "") == "report"):
            return [k.value for k in node.value.keys]
    raise AssertionError("no report dict in examples/soak.py")


@pytest.fixture
def small_soak(monkeypatch):
    """The soak's configuration cut for the CPU: chunks of 16 windows (not
    128, so BlobNet runs on the windows the clip has rather than on
    zero padding), and tracks confirmed after 3 hits that die after 10
    missed fields, so that tracks die on a clip this short."""
    from cova_tpu_torch.config import SortConfig

    full_cfg = soak.soak_cfg

    def soak_cfg(meta, last):
        cfg = full_cfg(meta, last)
        return dataclasses.replace(
            cfg, sort=SortConfig(min_hits=3, max_age=10),
            compressed=dataclasses.replace(cfg.compressed, batch_frames=16))

    monkeypatch.setattr(soak, "soak_cfg", soak_cfg)


def test_soak_report_csvs_and_budget(paff_clip, tmp_path, capsys, monkeypatch, small_soak):
    from cova_tpu_torch.pipeline.cova import CovaPipeline

    monkeypatch.setenv("SOAK_RSS_BUDGET_MB", "-1")
    out = tmp_path / "soak"
    rc = soak.main(["2", str(out), "--input", str(paff_clip), "--device", "cpu"])
    captured = capsys.readouterr()
    report = json.loads(captured.out.strip().splitlines()[-1])
    assert rc == 1 and "FAIL: steady-state RSS grew" in captured.err
    assert "last='select'" in captured.err
    assert list(report) == _jax_report_keys()
    assert report["frames"] == 2 * Mp4Demuxer(str(paff_clip)).num_samples == 256
    assert report["dead_tracks"] > 0

    _, sd, meta = load_artifact(soak.DEMO_WEIGHTS, "cpu")
    res = CovaPipeline(str(out / "loop2.mp4"), str(tmp_path / "ref"), soak.soak_cfg(meta, "select"),
                       sd, log=lambda *_: None, device="cpu").run()
    assert res.num_frames == report["frames"] and res.dead_tracks == report["dead_tracks"]
    for name in CSVS:
        assert (out / "csv" / f"{name}.csv").read_bytes() == (
            tmp_path / "ref" / f"{name}.csv").read_bytes(), name


def test_soak_passes_within_the_budget(paff_clip, tmp_path, capsys, monkeypatch, small_soak):
    monkeypatch.setenv("SOAK_RSS_BUDGET_MB", "100000")
    assert soak.main(["1", str(tmp_path), "--input", str(paff_clip), "--device", "cpu"]) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["frames"] == 128

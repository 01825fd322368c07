"""The PyTorch port's compressed stage and end-to-end pipeline against the
JAX package, on the CPU.

* One chunk through `compressed_stage_step`: the packed per-slot bytes,
  masks and boxes equal to JAX's, with a short range gated by nwin.
* `CovaPipeline` (host_tracking=False) on generated PAFF clips: the four
  aggregator CSVs equal to the JAX pipeline's. They are byte-identical
  today; the comparison allows, per float column, one float16 ulp of the
  device's macroblock-unit boxes (x16 in pixels, propagated into area),
  and holds the row count, track ids and timestamps exactly.
"""

import csv
import dataclasses
import importlib.util
import math
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cova_tpu.config as jcfg
import cova_tpu_torch.config as tcfg
from cova_tpu.models.blobnet import load_artifact as jax_load_artifact
from cova_tpu.ops.cc import connected_components as jax_connected_components
from cova_tpu.pipeline.compressed import compressed_stage_step as jax_stage_step
from cova_tpu.pipeline.cova import CovaPipeline as JaxCovaPipeline
from cova_tpu.tracker.sort import sort_init as jax_sort_init
from cova_tpu_torch.models.blobnet import load_artifact
from cova_tpu_torch.ops.cc import mask_to_boxes as torch_mask_to_boxes
from cova_tpu_torch.pipeline import compressed as torch_compressed
from cova_tpu_torch.pipeline.compressed import compressed_stage_step
from cova_tpu_torch.pipeline.cova import CovaPipeline
from cova_tpu_torch.tracker.sort import sort_init

# The suite runs one test worker per core: keep torch to one thread each.
torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
SYNTH = REPO / "artifacts" / "blobnet_synth.npz"
CSVS = ("track", "dnn", "assoc", "stationary")


def _cfg(mod, num_ranges, batch_frames, last="select"):
    c = mod.CovaConfig()
    return dataclasses.replace(
        c,
        sort=mod.SortConfig(min_hits=3, max_age=10),
        parallel=mod.ParallelConfig(num_ranges=num_ranges),
        last=last,
        compressed=dataclasses.replace(
            c.compressed, batch_frames=batch_frames, use_nnz_channel=True,
            signed_mv=True, host_tracking=False,
        ),
    )


def _wire_chunk(rng, r, nf, h, w):
    """Seeded wire16 metadata: zero-motion background with a few
    high-motion rectangles per frame (signed-MV layout)."""
    x = np.zeros((r, nf, h, w, 2), np.uint8)
    x[..., 0] = rng.integers(0, 2, size=(r, nf, h, w))
    x[..., 1] = 0x88
    for ri in range(r):
        for fi in range(nf):
            for _ in range(3):
                t, l = rng.integers(0, h - 4), rng.integers(0, w - 5)
                x[ri, fi, t : t + 3, l : l + 4, 0] = rng.integers(1, 8) | (rng.integers(0, 8) << 3)
                x[ri, fi, t : t + 3, l : l + 4, 1] = rng.integers(0, 256)
    return x


def test_compressed_stage_step_packed_bytes_match_jax():
    cfg_t, cfg_j = _cfg(tcfg, 2, 12), _cfg(jcfg, 2, 12)
    r, f, t = 2, 12, cfg_t.video.timestep
    chunk = _wire_chunk(np.random.default_rng(3), r, f + t - 1, 16, 24)
    ts0 = np.array([3, 10], np.int32)
    nwin = np.array([f, 7], np.int32)  # range 1 is short: its tail must not touch SORT

    model, _, _ = load_artifact(SYNTH, "cpu")
    st, packed, masks, boxes = compressed_stage_step(
        model, cfg_t, torch.from_numpy(chunk), sort_init(64, r, "cpu"),
        torch.from_numpy(ts0), nwin=torch.from_numpy(nwin),
    )
    jmodel, jvars, _ = jax_load_artifact(str(SYNTH))
    jst0 = jax.vmap(lambda _: jax_sort_init(64))(jnp.arange(r))
    jst, jpacked, jmasks, jboxes = jax_stage_step(
        jmodel, jvars, cfg_j, jnp.asarray(chunk), jst0, jnp.asarray(ts0),
        nwin=jnp.asarray(nwin),
    )
    assert packed.shape == (r, f, 64, 30) and packed.dtype == torch.uint8
    np.testing.assert_array_equal(packed.numpy().reshape(-1), np.asarray(jpacked))
    np.testing.assert_array_equal(masks.numpy(), np.asarray(jmasks))
    for name in ("ltwh", "valid", "area"):
        np.testing.assert_array_equal(
            getattr(boxes, name).numpy(), np.asarray(getattr(jboxes, name)), err_msg=name
        )
    for fld in dataclasses.fields(st):
        a, b = getattr(st, fld.name).numpy(), np.asarray(getattr(jst, fld.name))
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-3, err_msg=fld.name)
    assert int(boxes.valid.sum()) > 0 and bool(st.exists.any())
    # The gated range's state froze at its 7th window.
    assert int(st.frame_count[0]) == f and int(st.frame_count[1]) == 7


@pytest.fixture(scope="module")
def paff_clips(tmp_path_factory):
    from cova_tpu_torch.utils.mp4loop import mux_rec_to_mp4

    spec = importlib.util.spec_from_file_location(
        "paff_gen", REPO / "cova_tpu" / "csrc" / "tools" / "paff_gen.py"
    )
    pg = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(pg)
    tmp = tmp_path_factory.mktemp("paff")
    clips = {}
    for key in [(16, 8, 160, 16), (80, 46, 300, 30)]:
        rec, mp4 = tmp / f"{key}.rec", tmp / f"{key}.mp4"
        pg.scenario_pipeline(*key).write_rec(str(rec))
        mux_rec_to_mp4(str(rec), str(mp4))
        clips[key] = mp4
    return clips


def _f16_ulp(v: float) -> float:
    v = abs(v)
    if v < 2.0**-14:
        return 2.0**-24
    return 2.0 ** (math.floor(math.log2(v)) - 10)


def _assert_csvs_match(got_dir, ref_dir):
    for name in CSVS:
        with open(got_dir / f"{name}.csv") as a, open(ref_dir / f"{name}.csv") as b:
            got, ref = list(csv.DictReader(a)), list(csv.DictReader(b))
        assert len(got) == len(ref), name
        for i, (g, r) in enumerate(zip(got, ref)):
            where = f"{name}.csv row {i}"
            assert g.keys() == r.keys(), where
            for key in ("track_id", "timestamp", "class_id", "confidence"):
                assert g[key] == r[key], f"{where} {key}"
            tol = {}
            for key in ("left", "top", "width", "height"):
                tol[key] = 16 * _f16_ulp(float(r[key]) / 16)
                assert abs(float(g[key]) - float(r[key])) <= tol[key], f"{where} {key}"
            w, h = float(r["width"]), float(r["height"])
            area_tol = w * tol["height"] + h * tol["width"] + tol["width"] * tol["height"]
            assert abs(float(g["area"]) - float(r["area"])) <= area_tol, f"{where} area"


@pytest.mark.parametrize(
    "clip,num_ranges,batch_frames",
    [((16, 8, 160, 16), 2, 16), ((80, 46, 300, 30), 2, 64)],
)
def test_pipeline_csvs_match_jax(paff_clips, tmp_path, monkeypatch, clip, num_ranges,
                                 batch_frames):
    mp4 = str(paff_clips[clip])
    _, sd, _ = load_artifact(SYNTH, "cpu")
    chunk_masks = []

    def recording_mask_to_boxes(masks, *args, **kwargs):
        chunk_masks.append(masks.numpy().copy())
        return torch_mask_to_boxes(masks, *args, **kwargs)

    monkeypatch.setattr(torch_compressed, "mask_to_boxes", recording_mask_to_boxes)
    res = CovaPipeline(
        mp4, str(tmp_path / "torch"), _cfg(tcfg, num_ranges, batch_frames), sd,
        log=lambda *_: None, device="cpu",
    ).run()
    _, jvars, _ = jax_load_artifact(str(SYNTH))
    jres = JaxCovaPipeline(
        mp4, str(tmp_path / "jax"), _cfg(jcfg, num_ranges, batch_frames), jvars,
        log=lambda *_: None,
    ).run()
    assert res.num_frames == jres.num_frames == 2 * clip[2]  # one sample per field
    assert res.dead_tracks == jres.dead_tracks > 0
    for key in ("dropped", "decoded_dependency", "decoded_inference"):
        assert getattr(res, key) == getattr(jres, key), key
    _assert_csvs_match(tmp_path / "torch", tmp_path / "jax")
    rows = (tmp_path / "torch" / "track.csv").read_text().splitlines()
    assert len(rows) > 1
    # The JAX run above labels components with a fixed 32 sweeps on the
    # CPU, the port (like the TPU kernel) until nothing changes: the JAX
    # run is an oracle for the port only where 32 sweeps have converged.
    # On every chunk's masks they have: 256 sweeps give the same labels.
    assert chunk_masks and any(m.any() for m in chunk_masks)
    for masks in chunk_masks:
        masks = masks.reshape((-1,) + masks.shape[-2:])
        masks = jnp.asarray(masks[masks.any(axis=(1, 2))])
        if len(masks):
            fixed = jax.vmap(lambda m: jax_connected_components(m, 32))(masks)
            settled = jax.vmap(lambda m: jax_connected_components(m, 256))(masks)
            np.testing.assert_array_equal(np.asarray(fixed), np.asarray(settled))


@pytest.mark.parametrize("flags", [[], ["--device-tracking"]])
def test_run_cova_cli_writes_csvs(paff_clips, tmp_path, capsys, flags):
    from cova_tpu_torch import run_cova

    out = tmp_path / "out"
    run_cova.main([str(paff_clips[(16, 8, 160, 16)]), str(out), "--device", "cpu", *flags])
    assert "Frames: 320" in capsys.readouterr().out
    for name in CSVS:
        assert (out / f"{name}.csv").exists()


def test_unported_modes_raise(paff_clips, tmp_path):
    """What the port refuses: a multi-device config on more cards than
    are visible, for a single stream and for multi-stream ingest alike
    (nothing falls back to the CPU), and ranges that do not divide over
    the devices. The host-tracking default and a mesh of virtual CPU
    devices construct."""
    mp4 = str(paff_clips[(16, 8, 160, 16)])
    cfg = _cfg(tcfg, 2, 16)
    host = dataclasses.replace(
        cfg, compressed=dataclasses.replace(cfg.compressed, host_tracking=True)
    )
    assert CovaPipeline(mp4, str(tmp_path / "a"), host, device="cpu").cfg.compressed.host_tracking
    two = dataclasses.replace(cfg, parallel=tcfg.ParallelConfig(num_ranges=2, num_devices=2))
    assert CovaPipeline(mp4, str(tmp_path / "a2"), two, device="cpu").stage.mesh.size == 2
    more = dataclasses.replace(cfg, parallel=tcfg.ParallelConfig(
        num_ranges=2, num_devices=max(2, torch.cuda.device_count() + 1)))
    with pytest.raises(ValueError, match="visible"):
        CovaPipeline(mp4, str(tmp_path / "b"), more, device="cuda")
    with pytest.raises(ValueError, match="visible"):
        CovaPipeline.multi([(mp4, str(tmp_path / "c"), None)], more, device="cuda")
    odd = dataclasses.replace(cfg, parallel=tcfg.ParallelConfig(num_ranges=3, num_devices=2))
    with pytest.raises(ValueError, match="not divisible"):
        CovaPipeline(mp4, str(tmp_path / "d"), odd, device="cpu")

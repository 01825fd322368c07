"""The PyTorch port's default host-tracking path against the JAX package,
on the CPU.

* `compressed_masks_step`: the bit-packed mask bytes equal JAX's for
  every committed weight artifact at its grid, except at a pixel whose
  JAX probability lies within 1e-5 of the threshold (float32 sums in
  another order); `compressed_probs_step` within 1e-5 of JAX's;
  `unpack_masks` inverts the pack.
* `CovaPipeline` with host_tracking=True (the CovaConfig default) on
  generated PAFF clips and on a short B-frame CABAC render of the synth
  scene: the four aggregator CSVs byte-identical to the JAX pipeline's,
  and the selector's counts equal.
* `CovaPipeline.multi`: per-stream CSVs byte-identical to solo runs and
  to JAX's multi; streams on different grids are refused.
"""

import dataclasses
import functools
import importlib.util
import pathlib
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cova_tpu.config as jcfg
import cova_tpu_torch.config as tcfg
from cova_tpu.models.blobnet import load_artifact as jax_load_artifact
from cova_tpu.pipeline import compressed as jcomp
from cova_tpu.pipeline.cova import CovaPipeline as JaxCovaPipeline
from cova_tpu_torch.models.blobnet import load_artifact
from cova_tpu_torch.pipeline import compressed as tcomp
from cova_tpu_torch.pipeline.cova import CovaPipeline

# The suite runs one test worker per core: keep torch to one thread each.
torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
ARTIFACTS = REPO / "artifacts"
SYNTH = ARTIFACTS / "blobnet_synth.npz"
CSVS = ("track", "dnn", "assoc", "stationary")
TOL = 1e-5
# (artifact, mask grid H x W)
GRIDS = [
    ("blobnet_demo", 45, 80),
    ("blobnet_demo_holdout", 45, 80),
    ("blobnet_synth", 45, 80),
    ("blobnet_demo1080", 68, 120),
]


def _cfg(mod, meta, num_ranges=2, batch_frames=8, last="select"):
    c = mod.CovaConfig()
    return dataclasses.replace(
        c,
        sort=mod.SortConfig(min_hits=3, max_age=10),
        parallel=mod.ParallelConfig(num_ranges=num_ranges),
        last=last,
        compressed=dataclasses.replace(
            c.compressed,
            batch_frames=batch_frames,
            use_nnz_channel=bool(meta["use_nnz_channel"]),
            signed_mv=bool(meta["signed_mv"]),
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
            for _ in range(6):
                t, l = rng.integers(0, h - 6), rng.integers(0, w - 8)
                x[ri, fi, t : t + 5, l : l + 7, 0] = rng.integers(1, 8) | (rng.integers(0, 8) << 3)
                x[ri, fi, t : t + 5, l : l + 7, 1] = rng.integers(0, 256)
    return x


@functools.lru_cache(maxsize=None)
def _steps(name, h, w):
    """(chunk, cfg, torch masks, torch probs, JAX masks, JAX probs) for
    one artifact on a seeded R=2, F=8 chunk."""
    path = ARTIFACTS / f"{name}.npz"
    model, _, meta = load_artifact(path, "cpu")
    jmodel, jvars, _ = jax_load_artifact(str(path))
    cfg_t, cfg_j = _cfg(tcfg, meta), _cfg(jcfg, meta)
    r, f, t = 2, 8, cfg_t.video.timestep
    chunk = _wire_chunk(np.random.default_rng(7), r, f + t - 1, h, w)
    x = torch.from_numpy(chunk)
    got_m = tcomp.compressed_masks_step(model, cfg_t, x).numpy()
    got_p = tcomp.compressed_probs_step(model, cfg_t, x).numpy()
    xj = jnp.asarray(chunk)
    ref_m = np.asarray(jcomp.compressed_masks_step(jmodel, jvars, cfg_j, xj))
    ref_p = np.asarray(jcomp.compressed_probs_step(jmodel, jvars, cfg_j, xj))
    return chunk, cfg_t, got_m, got_p, ref_m, ref_p


@pytest.mark.parametrize("name,h,w", GRIDS)
def test_masks_step_bytes_match_jax(name, h, w):
    _, cfg, got, _, ref, ref_p = _steps(name, h, w)
    r, f = 2, 8
    assert got.dtype == np.uint8 and got.shape == ref.shape == (r * f * h * w // 8,)
    shape = (r, f, h, w)
    diff = tcomp.unpack_masks(got, shape) != jcomp.unpack_masks(ref, shape)
    near = np.abs(ref_p.reshape(shape) - cfg.compressed.mask_threshold) <= TOL
    assert not (diff & ~near).any(), f"{int((diff & ~near).sum())} pixels flipped"
    # The masks are neither empty nor full, so the threshold is exercised.
    on = jcomp.unpack_masks(ref, shape).mean()
    assert 0.0 < on < 1.0


@pytest.mark.parametrize("name,h,w", GRIDS)
def test_probs_step_matches_jax(name, h, w):
    _, _, _, got, _, ref = _steps(name, h, w)
    assert got.dtype == np.float32 and got.shape == ref.shape == (2 * 8 * h * w,)
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)


def test_unpack_masks_inverts_pack():
    rng = np.random.default_rng(0)
    masks = rng.uniform(size=(3, 5, 7, 24)) < 0.4
    packed = tcomp.pack_masks(torch.from_numpy(masks))
    assert packed.dtype == torch.uint8 and packed.shape == (3 * 5 * 7 * 3,)
    np.testing.assert_array_equal(packed.numpy(), np.packbits(masks, axis=-1).reshape(-1))
    np.testing.assert_array_equal(tcomp.unpack_masks(packed.numpy(), masks.shape), masks)
    with pytest.raises(ValueError, match="multiple of 8"):
        tcomp.pack_masks(torch.zeros((2, 12), dtype=torch.bool))


def test_run_chunk_masks_shape():
    model, _, meta = load_artifact(SYNTH, "cpu")
    cfg = _cfg(tcfg, meta)
    stage = tcomp.CompressedStage(model, cfg, 2, "cpu")
    chunk = _wire_chunk(np.random.default_rng(1), 2, 8 + 3, 45, 80)
    out = stage.run_chunk_masks(chunk)
    assert stage.masks_shape == (2, 8, 45, 80)
    assert out.device.type == "cpu" and out.shape == (2 * 8 * 45 * 10,)


def _paff(tmp, key):
    from cova_tpu_torch.utils.mp4loop import mux_rec_to_mp4

    spec = importlib.util.spec_from_file_location(
        "paff_gen", REPO / "cova_tpu" / "csrc" / "tools" / "paff_gen.py"
    )
    pg = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(pg)
    rec, mp4 = tmp / f"{key}.rec", tmp / f"{key}.mp4"
    pg.scenario_pipeline(*key).write_rec(str(rec))
    mux_rec_to_mp4(str(rec), str(mp4))
    return str(mp4)


@pytest.fixture(scope="module")
def paff_clips(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("paff")
    keys = [(16, 8, 160, 16), (80, 46, 300, 30), (80, 46, 240, 16)]
    return {key: _paff(tmp, key) for key in keys}


def _csvs(out_dir):
    return {name: (out_dir / f"{name}.csv").read_bytes() for name in CSVS}


def _run_both(mp4, tmp_path, num_ranges, batch_frames):
    """The port's and JAX's CovaPipeline with the synth weights on one
    input; returns (torch result, JAX result), CSVs under tmp_path."""
    _, sd, meta = load_artifact(SYNTH, "cpu")
    _, jvars, _ = jax_load_artifact(str(SYNTH))
    cfg_t = _cfg(tcfg, meta, num_ranges, batch_frames)
    assert cfg_t.compressed.host_tracking  # the default path
    res = CovaPipeline(mp4, str(tmp_path / "torch"), cfg_t, sd, log=lambda *_: None,
                       device="cpu").run()
    jres = JaxCovaPipeline(
        mp4, str(tmp_path / "jax"), _cfg(jcfg, meta, num_ranges, batch_frames), jvars,
        log=lambda *_: None,
    ).run()
    assert _csvs(tmp_path / "torch") == _csvs(tmp_path / "jax")
    for key in ("num_frames", "dropped", "decoded_dependency", "decoded_inference",
                "dead_tracks"):
        assert getattr(res, key) == getattr(jres, key), key
    return res, jres


@pytest.mark.parametrize(
    "clip,num_ranges,batch_frames",
    [((16, 8, 160, 16), 2, 16), ((80, 46, 300, 30), 2, 64)],
)
def test_host_tracking_pipeline_csvs_match_jax(
    paff_clips, tmp_path, clip, num_ranges, batch_frames
):
    res, _ = _run_both(paff_clips[clip], tmp_path, num_ranges, batch_frames)
    assert res.num_frames == 2 * clip[2]  # one sample per field
    assert res.dead_tracks > 0
    assert len((tmp_path / "torch" / "track.csv").read_text().splitlines()) > 1


def test_host_tracking_synth_bframes_match_jax(tmp_path):
    """A short render of the synth scene (libx264, B-frames, CABAC,
    1280x720): the only input that sends B-frame display reordering
    through the port."""
    csrc = REPO / "cova_tpu" / "csrc"
    try:
        subprocess.run(["make", "-s", "-C", str(csrc), "tools/encode_yuv"],
                       check=True, capture_output=True)
    except (OSError, subprocess.CalledProcessError) as e:
        pytest.skip(f"encode_yuv cannot be built here: {e}")
    spec = importlib.util.spec_from_file_location(
        "make_synth", REPO / "examples" / "make_synth.py"
    )
    ms = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ms)
    mp4 = ms.render(str(tmp_path / "synth.mp4"), frames=90)

    from cova_tpu_torch.codec import Mp4Demuxer

    d = Mp4Demuxer(mp4)
    assert (d.mb_width, d.mb_height) == (80, 45)
    assert any(d.display_order(0, d.num_samples) != np.arange(d.num_samples))
    res, _ = _run_both(mp4, tmp_path, 2, 32)
    assert res.num_frames == 90 and res.dead_tracks > 0


def test_multi_stream_matches_solo_and_jax(paff_clips, tmp_path):
    a, b = paff_clips[(80, 46, 300, 30)], paff_clips[(80, 46, 240, 16)]
    _, sd, meta = load_artifact(SYNTH, "cpu")
    _, jvars, _ = jax_load_artifact(str(SYNTH))
    cfg_t, cfg_j = _cfg(tcfg, meta, 2, 64), _cfg(jcfg, meta, 2, 64)
    quiet = dict(log=lambda *_: None)

    solo = {}
    for name, path in (("a", a), ("b", b)):
        out = tmp_path / f"solo_{name}"
        res = CovaPipeline(path, str(out), cfg_t, sd, device="cpu", **quiet).run()
        assert res.dead_tracks > 0
        solo[name] = _csvs(out)

    streams = [(a, str(tmp_path / "multi_a"), None), (b, str(tmp_path / "multi_b"), None)]
    multi = CovaPipeline.multi(streams, cfg_t, sd, device="cpu", **quiet)
    assert multi.num_ranges == 4  # one device batch across the streams
    res = multi.run()
    jstreams = [(a, str(tmp_path / "jax_a"), None), (b, str(tmp_path / "jax_b"), None)]
    jres = JaxCovaPipeline.multi(jstreams, cfg_j, jvars, **quiet).run()
    assert res.num_frames == jres.num_frames == 600 + 480
    assert res.dead_tracks == jres.dead_tracks
    for name in ("a", "b"):
        assert _csvs(tmp_path / f"multi_{name}") == solo[name], name
        assert _csvs(tmp_path / f"jax_{name}") == solo[name], name


def test_multi_stream_mixed_grids_rejected(paff_clips, tmp_path):
    streams = [
        (paff_clips[(16, 8, 160, 16)], str(tmp_path / "a"), None),
        (paff_clips[(80, 46, 300, 30)], str(tmp_path / "b"), None),
    ]
    with pytest.raises(ValueError, match="one MB grid"):
        CovaPipeline.multi(streams, tcfg.CovaConfig(), device="cpu")

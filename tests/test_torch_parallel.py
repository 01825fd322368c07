"""The port's mesh and the sharded compressed stage, on the CPU.

* `make_mesh`, `shard_batch`, `replicate` (parallel/mesh.py): a mesh of
  virtual CPU devices; a CUDA mesh larger than the visible cards raises.
* `CompressedStage` with the range axis split over 2, 4 and 8 virtual
  CPU devices equals the one-device stage bit for bit over two chunks
  (packed outputs, masks, boxes; the masks step's bytes), and equals the
  JAX package's stage sharded over its 8 virtual devices on the same
  chunk of the committed synth render (blobnet_demo weights). JAX labels
  CC with a fixed 32 sweeps on the CPU, the port until nothing changes:
  the test first shows that 32 sweeps have converged on these masks.
* `CovaPipeline` with num_devices 8 writes the same four CSVs as with 1,
  in both tracking modes, on a 128-field PAFF clip of 8 GoPs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cova_tpu.config as jcfg
import cova_tpu_torch.config as tcfg
from cova_tpu.models import blobnet as jbn
from cova_tpu.ops.cc import connected_components as jax_connected_components
from cova_tpu.parallel.mesh import make_mesh as jax_make_mesh
from cova_tpu.pipeline.compressed import CompressedStage as JaxCompressedStage
from cova_tpu_torch.examples.profile_device import DEMO_WEIGHTS, SYNTH_RENDER, load_chunk
from cova_tpu_torch.models.blobnet import load_artifact
from cova_tpu_torch.parallel.mesh import Mesh, make_mesh, replicate, shard_batch
from cova_tpu_torch.pipeline.compressed import CompressedStage
from cova_tpu_torch.pipeline.cova import CovaPipeline
from cova_tpu_torch.tracker.sort import sort_init

# The suite runs one test worker per core: keep torch to one thread each.
torch.set_num_threads(1)

CSVS = ("track", "dnn", "assoc", "stationary")
R, F = 8, 4


def _stage_cfg(mod, meta, host_tracking=False, num_ranges=R, num_devices=1):
    c = mod.CovaConfig()
    return dataclasses.replace(
        c,
        sort=mod.SortConfig(min_hits=3, max_age=10),
        parallel=mod.ParallelConfig(num_ranges=num_ranges, num_devices=num_devices),
        compressed=dataclasses.replace(
            c.compressed, batch_frames=F, use_nnz_channel=bool(meta["use_nnz_channel"]),
            signed_mv=bool(meta["signed_mv"]), host_tracking=host_tracking,
        ),
    )


def test_make_mesh_on_the_cpu():
    mesh = make_mesh(4, device_type="cpu")
    assert mesh.size == 4 and mesh.axis == "stream"
    assert mesh.devices == (torch.device("cpu"),) * 4
    assert make_mesh(device_type="cpu").size == 8  # as the JAX tests' 8 virtual devices
    assert make_mesh(devices=["cpu", "cpu"], axis="x") == Mesh((torch.device("cpu"),) * 2, "x")


@pytest.mark.parametrize("kwargs", [
    dict(n_devices=None),
    dict(n_devices=2),
    dict(devices=["cuda:0", "cuda:0"]),
])
def test_cuda_mesh_beyond_the_visible_cards_raises(kwargs):
    n = torch.cuda.device_count()
    if kwargs.get("n_devices"):
        kwargs["n_devices"] = n + kwargs["n_devices"]
    if "devices" in kwargs:
        kwargs["devices"] = [f"cuda:{n}"] * 2
    with pytest.raises(ValueError, match="visible"):
        make_mesh(**kwargs)


def test_shard_batch_splits_leading_axes_into_contiguous_blocks():
    mesh = make_mesh(4, device_type="cpu")
    x = np.arange(8 * 3).reshape(8, 3)
    state = sort_init(16, 8, "cpu")
    state.frame_count += torch.arange(8, dtype=torch.int32)
    blocks = shard_batch(mesh, {"x": x, "state": state})
    assert len(blocks) == 4
    for i, b in enumerate(blocks):
        assert torch.equal(b["x"], torch.from_numpy(x[2 * i : 2 * i + 2]))
        assert b["state"].frame_count.tolist() == [2 * i, 2 * i + 1]
        assert b["state"].mean.shape == (2, 16, 7)
    with pytest.raises(ValueError, match="not divisible"):
        shard_batch(mesh, np.zeros((6, 2)))
    with pytest.raises(ValueError, match="scalar"):
        shard_batch(mesh, torch.tensor(1.0))


def test_replicate_gives_independent_copies():
    mesh = make_mesh(2, device_type="cpu")
    lin = torch.nn.Linear(3, 2)
    a, b = replicate(mesh, lin)
    assert a is not lin and torch.equal(a.weight, lin.weight)
    with torch.no_grad():
        a.weight.add_(1.0)
    assert torch.equal(b.weight, lin.weight)
    t = torch.arange(4.0)
    c, d = replicate(mesh, t)
    c.add_(1.0)
    assert torch.equal(d, t) and torch.equal(t, torch.arange(4.0))


@pytest.fixture(scope="module")
def synth():
    """The demo weights, their config and two chunks of the committed
    synth render: the first F+T-1 frames of each of its 8 GoP ranges, and
    the same with every range's frames reversed (a second chunk that
    moves the SORT state on)."""
    _, sd, meta = load_artifact(DEMO_WEIGHTS, "cpu")
    cfg = _stage_cfg(tcfg, meta)
    chunk = load_chunk(SYNTH_RENDER, cfg)
    return sd, meta, cfg, [chunk, np.ascontiguousarray(chunk[:, ::-1])]


def _run(stage, chunks):
    """Packed outputs, masks, boxes and the masks step's bytes of each
    chunk, in turn, as numpy."""
    out = []
    for i, chunk in enumerate(chunks):
        ts0 = np.full(R, 3 + i * F, np.int32)
        packed, masks, boxes = stage.run_chunk(chunk, ts0)
        out.append({"packed": packed.numpy(), "masks": masks.numpy(),
                    "ltwh": boxes.ltwh.numpy(), "valid": boxes.valid.numpy(),
                    "masks_step": stage.run_chunk_masks(chunk).numpy()})
    return out


def _model(sd, meta):
    from cova_tpu_torch.models.blobnet import BlobNet, BlobNetConfig

    model = BlobNet(BlobNetConfig(in_channels=int(meta["in_channels"])))
    model.load_state_dict(sd)
    return model


@pytest.fixture(scope="module")
def one_device(synth):
    sd, meta, cfg, chunks = synth
    return _run(CompressedStage(_model(sd, meta), cfg, R, "cpu"), chunks)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_sharded_stage_matches_one_device(synth, one_device, n):
    sd, meta, cfg, chunks = synth
    stage = CompressedStage(_model(sd, meta), cfg, R, "cpu", mesh=make_mesh(n, device_type="cpu"))
    assert len(stage.models) == n and len(stage.sort_states) == n
    got = _run(stage, chunks)
    for i, (g, ref) in enumerate(zip(got, one_device)):
        for key, value in ref.items():
            np.testing.assert_array_equal(g[key], value, err_msg=f"chunk {i} {key}")
    assert one_device[0]["valid"].any() and one_device[1]["packed"].any()


def test_sharded_stage_matches_jax_on_8_devices(synth, one_device):
    sd, meta, cfg, chunks = synth
    # The artifact through JAX's own loader, on a template built shape-only
    # (an eager Flax init costs dozens of small compiles).
    jmodel = jbn.BlobNet(jbn.BlobNetConfig(in_channels=int(meta["in_channels"])))
    template = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4, 45, 80, jmodel.config.in_channels)), train=False))
    jvars = jbn.load_params_npz(str(DEMO_WEIGHTS), template)
    jstage = JaxCompressedStage(jmodel, jvars, _stage_cfg(jcfg, meta), R, mesh=jax_make_mesh(8))
    for i, (chunk, ref) in enumerate(zip(chunks, one_device)):
        jpacked, jmasks, _ = jstage.run_chunk(chunk, np.full(R, 3 + i * F, np.int32))
        assert len(jpacked.sharding.device_set) == 8
        masks = np.asarray(jmasks)
        np.testing.assert_array_equal(ref["masks"], masks, err_msg=f"chunk {i}")
        # JAX's 32 fixed CC sweeps have converged on these masks, so its
        # labels are the port's.
        flat = jnp.asarray(masks.reshape((-1,) + masks.shape[-2:]))
        np.testing.assert_array_equal(
            np.asarray(jax.vmap(lambda m: jax_connected_components(m, 32))(flat)),
            np.asarray(jax.vmap(lambda m: jax_connected_components(m, 256))(flat)))
        np.testing.assert_array_equal(ref["packed"].reshape(-1), np.asarray(jpacked),
                                      err_msg=f"chunk {i}")
        jbytes = np.asarray(jstage.run_chunk_masks(chunk))
        np.testing.assert_array_equal(ref["masks_step"], jbytes, err_msg=f"chunk {i}")


def test_num_ranges_must_divide(synth):
    sd, meta, cfg, _ = synth
    with pytest.raises(ValueError, match="not divisible"):
        CompressedStage(_model(sd, meta), cfg, 6, "cpu", mesh=make_mesh(4, device_type="cpu"))


@pytest.fixture(scope="module")
def paff_128(tmp_path_factory):
    """A PAFF clip of 64 frames (128 field samples) in 8 GoPs of 8
    frames: every one of 8 ranges holds one GoP."""
    from cova_tpu_torch.tools import paff_gen
    from cova_tpu_torch.utils.mp4loop import mux_rec_to_mp4

    tmp = tmp_path_factory.mktemp("paff")
    rec, mp4 = tmp / "paff.rec", tmp / "paff.mp4"
    paff_gen.scenario_pipeline(80, 46, 64, 8).write_rec(str(rec))
    mux_rec_to_mp4(str(rec), str(mp4))
    return str(mp4)


@pytest.mark.parametrize("host_tracking", [False, True])
def test_pipeline_on_8_devices_writes_the_csvs_of_one(paff_128, tmp_path, host_tracking):
    """JAX's test_end_to_end_pipeline_sharded_matches_single on an input
    that exists here."""
    _, sd, meta = load_artifact(DEMO_WEIGHTS, "cpu")
    outputs, results = {}, {}
    for ndev in (1, 8):
        cfg = dataclasses.replace(_stage_cfg(tcfg, meta, host_tracking, 8, ndev), last="select")
        out = tmp_path / f"dev{ndev}"
        pipe = CovaPipeline(paff_128, str(out), cfg, sd, log=lambda *_: None, device="cpu")
        assert pipe.stage.mesh.size == ndev
        results[ndev] = pipe.run()
        outputs[ndev] = {name: (out / f"{name}.csv").read_bytes() for name in CSVS}
    assert results[1].num_frames == results[8].num_frames == 128
    assert results[1].dead_tracks == results[8].dead_tracks > 0
    for key in ("dropped", "decoded_dependency", "decoded_inference"):
        assert getattr(results[1], key) == getattr(results[8], key), key
    assert outputs[1] == outputs[8]
    assert outputs[1]["track"].count(b"\n") > 1

"""Data-parallel BlobNet training in the PyTorch port, on the CPU: two
gloo ranks (`parallel.mesh.run_ranks`) against the one-device step on
the global batch, and against the JAX step jitted over a 2-device mesh.

A small BlobNet (encoder (8, 16), decoder (8, 8), C=4, signed MVs,
dropout 0) starts from the Flax init; three global batches of 4 windows,
2 a rank. Tolerances are those of tests/test_torch_train.py (float32 sums
in another order): train-mode probabilities within 1e-5, the loss within
1e-4, running statistics within 1e-6 after one step, gradients within
2e-6; after the three Adam steps, parameters within 1e-5, except the
biases of the ConvTransposes that feed a BatchNorm (their true gradient
is zero, so Adam turns rounding noise into steps of up to lr) within
2 x steps x lr, and the running mean of that BatchNorm within 0.01 of
that a step. Precision and recall are ratios of integer counts: within
1e-6, and not the mean of the ranks' own ratios.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cova_tpu.models import blobnet as jbn
from cova_tpu.models import train_blobnet as jtrain
from cova_tpu.parallel.mesh import make_mesh as jax_make_mesh
from cova_tpu.parallel.mesh import replicate as jax_replicate
from cova_tpu.parallel.mesh import shard_batch as jax_shard_batch
from cova_tpu_torch.graft_entry import data_parallel_steps, dryrun_multichip
from cova_tpu_torch.models import blobnet as tbn
from cova_tpu_torch.models import losses as tlosses
from cova_tpu_torch.models import train_blobnet as ttrain
from cova_tpu_torch.parallel.mesh import run_ranks

# The suite runs one test worker per core: keep torch to one thread each.
torch.set_num_threads(1)

SMALL = dict(encoder_channels=(8, 16), decoder_channels=(8, 8), in_channels=4, dropout=0.0)
LR = 1e-3
STEPS = 3
WORLD = 2


def _flat(tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(p.key for p in path): np.asarray(leaf) for path, leaf in flat}


def _windows(n, seed, h=23, w=40):
    """n raw metadata windows (T=4, C=4, signed MVs offset 128) and labels
    that follow the newest frame's mb_class (tests/test_torch_train.py)."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 7, size=(n, 4, h, w, 4)).astype(np.float32)
    x[..., 1:3] = rng.integers(121, 136, size=(n, 4, h, w, 2))
    y = (x[:, 0, :, :, 0] >= 4).astype(np.float32)
    return x, y


def _bias_noise_tolerances(model, steps):
    """The ConvTranspose biases that feed a BatchNorm, and that
    BatchNorm's running mean (tests/test_torch_train.py)."""
    bias = 2 * steps * LR * 1.01
    tols = {}
    for i in range(len(model.dec_bn)):
        tols[f"dec_convt.{i}.bias"] = bias
        tols[f"dec_bn.{i}.running_mean"] = 1e-5 + (1 - tbn.BN_MOMENTUM) * steps * bias
    return tols


@pytest.fixture(scope="module")
def setup():
    """The Flax init (model, variables), its state_dict for the port, and
    the global batches."""
    jmodel, jvars = jbn.create_blobnet(jax.random.PRNGKey(0), jbn.BlobNetConfig(**SMALL))
    sd = tbn.convert_flax_variables(_flat(jvars))
    batches = [_windows(2 * WORLD, seed=10 + i) for i in range(STEPS)]
    return jmodel, jvars, sd, batches


@pytest.fixture(scope="module")
def two_ranks(setup):
    """Both ranks' results of the data-parallel steps over gloo."""
    _, _, sd, batches = setup
    state = {k: v.numpy() for k, v in sd.items()}
    return run_ranks(data_parallel_steps, WORLD, "gloo",
                     args=("cpu", tbn.BlobNetConfig(**SMALL), state, batches, LR, True))


@pytest.fixture(scope="module")
def one_device(setup):
    """The one-device port step on each global batch: metrics, the first
    step's outputs, gradients and state, the final state, and each rank
    block's precision and recall on its own."""
    _, _, sd, batches = setup
    model = tbn.BlobNet(tbn.BlobNetConfig(**SMALL))
    model.load_state_dict(sd)
    outs = []
    model.register_forward_hook(lambda m, i, o: outs.append(o.detach().clone()))
    step = ttrain.make_train_step(model, ttrain.make_adam(model, LR), signed_mv=True)
    res = {"metrics": [], "block_ratios": []}
    for i, (x, y) in enumerate(batches):
        m = step((x, y))
        res["metrics"].append({k: float(v) for k, v in m.items()})
        out, yt = outs[-1], torch.from_numpy(y)
        res["block_ratios"].append([
            [float(v) for v in tlosses.precision_recall(yt[r * 2:(r + 1) * 2],
                                                        out[r * 2:(r + 1) * 2])]
            for r in range(WORLD)
        ])
        if i == 0:
            res["first"] = {
                "out": out.numpy(),
                "grads": {n: p.grad.clone() for n, p in model.named_parameters()},
                "state": {k: v.clone() for k, v in model.state_dict().items()},
            }
    res["state"] = model.state_dict()
    res["model"] = model
    return res


def test_global_batchnorm_forward_and_backward_match_one_rank(two_ranks, one_device):
    """The first step: the ranks' train-mode outputs joined in rank order,
    the all-reduced gradients and the running statistics equal the one
    device's on the global batch (each rank's loss entering as its share:
    without it the gradients come out WORLD times too large)."""
    ref = one_device["first"]
    out = np.concatenate([r["first"]["out"] for r in two_ranks])
    np.testing.assert_allclose(out, ref["out"], rtol=0, atol=1e-5)
    for rank in two_ranks:
        for name, g in ref["grads"].items():
            np.testing.assert_allclose(rank["first"]["grads"][name], g.numpy(), rtol=0,
                                       atol=2e-6, err_msg=name)
        for name, v in ref["state"].items():
            if "running" in name:
                np.testing.assert_allclose(rank["first"]["state"][name], v.numpy(), rtol=0,
                                           atol=1e-6, err_msg=name)
    # Gradients large enough that twice their value misses the tolerance.
    assert any(np.abs(ref["grads"][n].numpy()).max() > 1e-3 for n in ref["grads"])


def test_data_parallel_steps_match_one_device(two_ranks, one_device):
    a, b = two_ranks
    for name in a["state"]:
        np.testing.assert_array_equal(a["state"][name], b["state"][name], err_msg=name)
    assert a["metrics"] == b["metrics"]
    noise = _bias_noise_tolerances(one_device["model"], STEPS)
    for name, value in one_device["state"].items():
        if name.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(a["state"][name], value.numpy(), rtol=0,
                                   atol=noise.get(name, 1e-5), err_msg=name)
    averaged = 0
    for got, ref, blocks in zip(a["metrics"], one_device["metrics"],
                                one_device["block_ratios"]):
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=0, atol=1e-4)
        for k, key in enumerate(("precision", "recall")):
            np.testing.assert_allclose(got[key], ref[key], rtol=0, atol=1e-6)
            averaged += abs(np.mean([blk[k] for blk in blocks]) - got[key]) > 1e-4
    # The global counts' ratios, which here differ from the ranks' mean.
    assert averaged > 0


def test_data_parallel_steps_match_jax_mesh_step(setup, two_ranks):
    jmodel, jvars, _, batches = setup
    mesh = jax_make_mesh(WORLD)
    tx = optax.adam(LR)
    jstep = jtrain.make_train_step(jmodel, tx, signed_mv=True)
    state = (jax_replicate(mesh, jvars["params"]), jax_replicate(mesh, jvars["batch_stats"]),
             jax_replicate(mesh, tx.init(jvars["params"])))
    got = two_ranks[0]
    for batch, m in zip(batches, got["metrics"]):
        state, jm = jstep(state, jax_shard_batch(mesh, tuple(jnp.asarray(a) for a in batch)))
        np.testing.assert_allclose(m["loss"], float(jm["loss"]), rtol=0, atol=1e-4)
        for key in ("precision", "recall"):
            np.testing.assert_allclose(m[key], float(jm[key]), rtol=0, atol=1e-6)
    ref = tbn.convert_flax_variables({**_flat({"params": state[0]}),
                                      **_flat({"batch_stats": state[1]})})
    noise = _bias_noise_tolerances(tbn.BlobNet(tbn.BlobNetConfig(**SMALL)), STEPS)
    for name, value in got["state"].items():
        if name.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(value, ref[name].numpy(), rtol=0,
                                   atol=noise.get(name, 1e-5), err_msg=name)


def test_one_process_group_of_one_is_the_plain_step(setup):
    """A group of one rank is the step without a group (its BatchNorm
    divides sums where the plain one takes means: float32 rounding)."""
    _, _, sd, batches = setup
    state = {k: v.numpy() for k, v in sd.items()}
    (got,) = run_ranks(data_parallel_steps, 1, "gloo",
                       args=("cpu", tbn.BlobNetConfig(**SMALL), state, batches[:1], LR, True))
    model = tbn.BlobNet(tbn.BlobNetConfig(**SMALL))
    model.load_state_dict(sd)
    m = ttrain.make_train_step(model, ttrain.make_adam(model, LR), signed_mv=True)(batches[0])
    np.testing.assert_allclose(got["metrics"][0]["loss"], float(m["loss"]), rtol=0, atol=1e-4)
    for key in ("precision", "recall"):
        assert got["metrics"][0][key] == float(m[key])
    noise = _bias_noise_tolerances(model, 1)
    for name, value in model.state_dict().items():
        np.testing.assert_allclose(got["state"][name], value.numpy(), rtol=0,
                                   atol=noise.get(name, 1e-5), err_msg=name)


def test_dryrun_multichip_on_two_cpu_ranks(capsys):
    line = dryrun_multichip(2, "cpu")
    assert capsys.readouterr().out.strip() == line
    assert line.startswith("dryrun_multichip ok on 2 devices: train loss ")
    assert "packed chunk outputs (2, 4, 16, 30) uint8" in line
    assert line.endswith("packed masks (3600,) uint8")


def test_dryrun_multichip_refuses_missing_cards():
    with pytest.raises(ValueError, match="visible"):
        dryrun_multichip(torch.cuda.device_count() + 1, "cuda")

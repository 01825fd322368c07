"""BlobNet training in the PyTorch port against the JAX package, on the CPU.

A small BlobNet (encoder (8, 16), decoder (8, 8), C=4, signed MVs) starts
from the Flax init `create_blobnet(PRNGKey(0))` converted by
`convert_flax_variables`, with dropout 0.0 on both sides (JAX feeds one
fixed dropout key to every step; the port draws fresh masks, so only
dropout-free runs can agree). Tolerances are float32 sums in another
order:

* train-mode probabilities within 1e-5, the loss (a 0-100 scale) within
  1e-4, BatchNorm running statistics within 1e-6, gradients within 2e-6
  absolute (the largest is about 1);
* after Adam steps, parameters within 1e-5, except the biases of the
  ConvTransposes that feed a BatchNorm: their true gradient is zero (the
  BatchNorm removes any constant), so both frameworks' gradients are
  rounding noise of 1e-8, and Adam's m / (sqrt(v) + eps) turns noise
  into steps of up to about lr each, in any direction: they are held
  within 2 x steps x lr, and the running mean of the BatchNorm they feed
  within 0.01 of that a step.

Also: the loss and metrics, the learning-rate schedule, the best-epoch
choice of `train_blobnet`, dropout's statistics and generator, the
truncated lecun_normal init, and the Flax-layout weights both ways.
"""

import inspect
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cova_tpu.models import blobnet as jbn
from cova_tpu.models import losses as jlosses
from cova_tpu.models import train_blobnet as jtrain
from cova_tpu.ops.preprocess import clip6_normalize as jax_clip6_normalize
from cova_tpu.utils.dataset import ArrayDataset as JaxArrayDataset
from cova_tpu_torch.models import blobnet as tbn
from cova_tpu_torch.models import losses as tlosses
from cova_tpu_torch.models import train_blobnet as ttrain
from cova_tpu_torch.ops.preprocess import clip6_normalize
from cova_tpu_torch.utils.dataset import ArrayDataset

# The suite runs one test worker per core: keep torch to one thread each.
torch.set_num_threads(1)

ARTIFACTS = pathlib.Path(__file__).resolve().parent.parent / "artifacts"
NAMES = ["blobnet_demo", "blobnet_demo1080", "blobnet_demo_holdout", "blobnet_synth"]
SMALL = dict(encoder_channels=(8, 16), decoder_channels=(8, 8), in_channels=4, dropout=0.0)
LR = 1e-3


def _flat(tree) -> dict:
    """A Flax variables pytree as the npz artifacts' flat keys."""
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(p.key for p in path): np.asarray(leaf) for path, leaf in flat}


@pytest.fixture(scope="module")
def flax_init():
    """(Flax model, variables, the port's model with the same weights)."""
    jmodel, jvars = jbn.create_blobnet(jax.random.PRNGKey(0), jbn.BlobNetConfig(**SMALL))
    tmodel = tbn.BlobNet(tbn.BlobNetConfig(**SMALL))
    tmodel.load_state_dict(tbn.convert_flax_variables(_flat(jvars)))
    return jmodel, jvars, tmodel


def _windows(n, h=23, w=40, seed=0):
    """n raw metadata windows (T=4, C=4, signed MVs offset 128) and labels
    that follow the newest frame's mb_class, float32 as ArrayDataset."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 7, size=(n, 4, h, w, 4)).astype(np.float32)
    x[..., 1:3] = rng.integers(121, 136, size=(n, 4, h, w, 2))
    y = (x[:, 0, :, :, 0] >= 4).astype(np.float32)
    return x, y


def _clone(model):
    other = tbn.BlobNet(model.config)
    other.load_state_dict(model.state_dict())
    return other


@pytest.mark.parametrize("seed", [0, 1])
def test_losses_match_jax(seed):
    rng = np.random.default_rng(seed)
    y_true = (rng.uniform(size=(3, 23, 40)) < 0.3).astype(np.float32)
    y_pred = rng.uniform(size=(3, 23, 40)).astype(np.float32)
    got = tlosses.jaccard_distance_loss(torch.from_numpy(y_true), torch.from_numpy(y_pred))
    ref = jlosses.jaccard_distance_loss(jnp.asarray(y_true), jnp.asarray(y_pred))
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)
    for thr in (0.5, 0.9):
        p, r = tlosses.precision_recall(torch.from_numpy(y_true), torch.from_numpy(y_pred), thr)
        jp, jr = jlosses.precision_recall(jnp.asarray(y_true), jnp.asarray(y_pred), thr)
        assert p.dtype == r.dtype == torch.float32
        assert (float(p), float(r)) == (float(jp), float(jr))
    empty = torch.zeros((1, 4, 4))
    assert [float(v) for v in tlosses.precision_recall(empty, empty)] == [0.0, 0.0]


def test_train_mode_forward_and_gradients_match_flax(flax_init):
    jmodel, jvars, tmodel = flax_init
    x, y = _windows(4)

    def loss_fn(params):
        out, upd = jmodel.apply(
            {"params": params, "batch_stats": jvars["batch_stats"]},
            jax_clip6_normalize(jnp.asarray(x), True), train=True, mutable=["batch_stats"],
        )
        return jlosses.jaccard_distance_loss(jnp.asarray(y), out), (out, upd["batch_stats"])

    (jloss, (jout, jstats)), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(
        jvars["params"]
    )
    model = _clone(tmodel).train()
    out = model(clip6_normalize(torch.from_numpy(x), True))
    loss = tlosses.jaccard_distance_loss(torch.from_numpy(y), out)
    loss.backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=0, atol=1e-4)
    # The gradient pytree maps through the same (linear) conversion.
    ref = tbn.convert_flax_variables({**_flat({"params": jgrads}),
                                      **_flat({"batch_stats": jstats})})
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref[name].numpy(), rtol=0, atol=2e-6,
                                   err_msg=name)
    for name, b in model.named_buffers():
        if "running" in name:  # biased batch variance, momentum 0.99
            np.testing.assert_allclose(b.numpy(), ref[name].numpy(), rtol=0, atol=1e-6,
                                       err_msg=name)


def _bias_noise_tolerances(model, steps):
    """Tolerances after `steps` Adam steps of the ConvTranspose biases that
    feed a BatchNorm, and of that BatchNorm's running mean (each batch
    mean carries the bias, weighted 0.01 a step)."""
    # Each side moves such a bias by at most about lr a step (Adam's
    # |m_hat| / sqrt(v_hat) <= 1.004 for t <= 3, by Cauchy-Schwarz), in
    # directions the noise sets.
    bias = 2 * steps * LR * 1.01
    tols = {}
    for i in range(len(model.dec_bn)):
        tols[f"dec_convt.{i}.bias"] = bias
        tols[f"dec_bn.{i}.running_mean"] = 1e-5 + (1 - tbn.BN_MOMENTUM) * steps * bias
    return tols


def test_adam_steps_match_optax(flax_init):
    jmodel, jvars, tmodel = flax_init
    tx = optax.adam(LR)
    jstep = jtrain.make_train_step(jmodel, tx, signed_mv=True)
    state = (jvars["params"], jvars["batch_stats"], tx.init(jvars["params"]))
    model = _clone(tmodel)
    step = ttrain.make_train_step(model, ttrain.make_adam(model, LR), signed_mv=True)
    steps = 3
    for i in range(steps):
        batch = _windows(4, seed=10 + i)
        state, jm = jstep(state, batch)
        m = step(batch)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=0, atol=1e-4)
        for key in ("precision", "recall"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=0, atol=1e-6)
    ref = tbn.convert_flax_variables({**_flat({"params": state[0]}),
                                      **_flat({"batch_stats": state[1]})})
    noise = _bias_noise_tolerances(model, steps)
    for name, value in model.state_dict().items():
        if name.endswith("num_batches_tracked"):
            continue
        tol = noise.get(name, 1e-5)
        np.testing.assert_allclose(value.numpy(), ref[name].numpy(), rtol=0, atol=tol,
                                   err_msg=name)


def test_lr_schedule_matches_optax_schedule():
    ref = jtrain.lr_schedule(2e-3, 10, 7)
    got = ttrain.lr_schedule(2e-3, 10, 7)
    for step in (0, 1, 62, 63, 69, 70, 71, 77, 140, 700):
        np.testing.assert_allclose(got(step), float(ref(step)), rtol=3e-7)
    assert got(69) == np.float32(2e-3)  # the last step of epoch 9: no decay yet
    assert got(70) < got(69)


def test_train_blobnet_picks_the_same_best_epoch(flax_init, capsys):
    _, jvars, tmodel = flax_init
    x, y = _windows(16, seed=3)
    epochs = 4
    _, jbest = jtrain.train_blobnet(
        JaxArrayDataset(x, y), epochs=epochs, base_lr=1e-2,
        config=jbn.BlobNetConfig(**SMALL), log_every=0, signed_mv=True,
    )
    jout = capsys.readouterr().out
    model, sd = ttrain.train_blobnet(
        ArrayDataset(x, y), epochs=epochs, base_lr=1e-2,
        config=tbn.BlobNetConfig(**SMALL), generator=torch.Generator().manual_seed(0),
        log_every=0, signed_mv=True, variables=tmodel.state_dict(), device="cpu",
    )
    tout = capsys.readouterr().out

    def f1s(text):
        return [float(ln.rsplit("f1=", 1)[1]) for ln in text.splitlines() if "f1=" in ln]

    def best(text):
        return next(ln for ln in text.splitlines() if ln.startswith("best epoch:"))

    assert len(f1s(tout)) == epochs and len(set(f1s(jout))) > 1
    np.testing.assert_allclose(f1s(tout), f1s(jout), rtol=0, atol=2e-3)
    assert best(tout).split(" (")[0] == best(jout).split(" (")[0]
    assert not model.training and all(v.device.type == "cpu" for v in sd.values())
    ref = tbn.convert_flax_variables(_flat(jbest))
    for name in ("enc_conv.0.weight", "head.weight", "enc_bn.1.running_var"):
        np.testing.assert_allclose(sd[name].numpy(), ref[name].numpy(), rtol=0, atol=1e-4)


def test_dropout_keeps_a_share_and_scales():
    g = torch.Generator().manual_seed(0)
    x = torch.ones(1000, 1000)
    y = tbn._dropout(x, 0.2, g)
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.8) < 0.005
    assert torch.all(y[kept] == 1.25)
    with pytest.raises(ValueError):
        tbn._dropout(x, 0.2, None)


def test_dropout_draws_fresh_masks_and_repeats_from_a_seed():
    cfg = tbn.BlobNetConfig(**{**SMALL, "dropout": 0.2})
    x, y = _windows(4)
    xt = clip6_normalize(torch.from_numpy(x), True)
    model, _ = tbn.create_blobnet(torch.Generator().manual_seed(1), cfg, device="cpu")
    model.train()
    g = torch.Generator().manual_seed(5)
    a, b = model(xt, generator=g), model(xt, generator=g)
    assert not torch.equal(a, b)
    with pytest.raises(ValueError):
        model(xt)
    model.eval()
    assert torch.equal(model(xt), model(xt))  # eval: no dropout

    def run(seed):
        m, _ = tbn.create_blobnet(torch.Generator().manual_seed(1), cfg, device="cpu")
        step = ttrain.make_train_step(m, ttrain.make_adam(m), True,
                                      torch.Generator().manual_seed(seed))
        losses = [float(step((x, y))["loss"]) for _ in range(2)]
        return losses, m.state_dict()

    (l1, s1), (l2, s2), (l3, _) = run(7), run(7), run(8)
    assert l1 == l2 and l1[0] != l3[0]
    for name in s1:
        assert torch.equal(s1[name], s2[name]), name


def test_truncated_lecun_init_matches_flax_distribution():
    model, sd = tbn.create_blobnet(torch.Generator().manual_seed(0), device="cpu")
    init = jax.nn.initializers.lecun_normal()  # Flax's default kernel init
    for name, fan_in, flax_shape in (("enc_conv.3.weight", 64 * 9, (3, 3, 64, 128)),
                                     ("dec_convt.0.weight", 128 * 16, (4, 4, 128, 64)),
                                     ("dec_convt.2.weight", 64 * 16, (4, 4, 64, 16))):
        w = sd[name].numpy()
        bound = 2.0 / np.sqrt(fan_in) / tbn.TRUNC_STD
        assert abs(w.std() * np.sqrt(fan_in) - 1.0) < 0.03, name
        assert np.abs(w).max() <= bound * (1 + 1e-6) and np.abs(w).max() > 0.98 * bound
        ref = np.asarray(init(jax.random.PRNGKey(0), flax_shape, jnp.float32))
        assert abs(w.std() / ref.std() - 1.0) < 0.05
        assert abs(np.abs(w).max() / np.abs(ref).max() - 1.0) < 0.02
    assert all(float(v.abs().max()) == 0.0 for k, v in sd.items() if k.endswith("bias"))
    assert torch.equal(sd["enc_bn.0.weight"], torch.ones(16))
    assert not model.training
    sig = inspect.signature(tbn.create_blobnet)
    assert sig.parameters["device"].default == "cuda"


@pytest.mark.parametrize("name", NAMES)
def test_flax_arrays_round_trip_exactly(name):
    with np.load(ARTIFACTS / f"{name}.npz") as data:
        arrays = {k: data[k] for k in data.files if k != "__meta__"}
    back = tbn.to_flax_arrays(tbn.convert_flax_variables(arrays))
    assert set(back) == set(arrays)
    for key, value in arrays.items():
        assert back[key].dtype == np.float32 and back[key].shape == value.shape, key
        np.testing.assert_array_equal(back[key], value, err_msg=key)


def test_port_saved_weights_load_in_jax(tmp_path):
    model, sd, meta = tbn.load_artifact(ARTIFACTS / "blobnet_demo.npz", "cpu")
    g = torch.Generator().manual_seed(3)
    # Weights the artifact does not hold: each scaled by 1 + N(0, 1e-3).
    changed = {k: v * (1 + 1e-3 * torch.randn(v.shape, generator=g))
               if v.is_floating_point() else v for k, v in sd.items()}
    model.load_state_dict(changed)
    path = tmp_path / "w" / "weights.npz"
    tbn.save_params_npz(path, model.state_dict(), meta)
    assert tbn.load_meta_npz(path) == meta == jbn.load_meta_npz(str(path))
    jmodel, jvars, jmeta = jbn.load_artifact(str(path))
    assert jmeta == meta
    x = np.random.default_rng(0).uniform(-1, 1, size=(2, 4, 45, 80, 4)).astype(np.float32)
    ref = np.asarray(jmodel.apply(jvars, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    again, sd2, _ = tbn.load_artifact(path, "cpu")
    for k, v in model.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(sd2[k], v), k

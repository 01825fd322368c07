"""BlobNet training loop in PyTorch (port of
cova_tpu/models/train_blobnet.py).

Replaces the reference Keras training (reference: utils/train-blobnet.py):
Adam, smoothed Jaccard distance, 20 epochs with exponential LR decay
(x e^-0.1 per epoch) after epoch 10, batch 4; the caller handles
checkpointing and a graceful SIGINT stop (`should_stop`).

Differences from the JAX package, both deliberate:
* dropout draws fresh masks from the caller's `torch.Generator` at every
  step; the JAX step feeds `PRNGKey(0)` to dropout at every step, so its
  masks repeat (ROADMAP queue 3). With `dropout=0.0` the two agree.
* Adam is `torch.optim.Adam` with optax's defaults (b1 0.9, b2 0.999,
  eps 1e-8 outside the square root), its learning rate set before each
  update from `lr_schedule` at the update's count, starting from 0 as
  optax evaluates it.
"""

from __future__ import annotations

import numpy as np
import torch

from cova_tpu_torch.models.blobnet import BlobNet, BlobNetConfig, create_blobnet
from cova_tpu_torch.models.losses import (
    jaccard_distance_loss,
    precision_recall_counts,
    precision_recall_from_counts,
)
from cova_tpu_torch.ops.preprocess import clip6_normalize
from cova_tpu_torch.pipeline.compressed import exact_float32


def lr_schedule(base_lr: float = 1e-3, decay_start_epoch: int = 10,
                steps_per_epoch: int = 1000):
    """Reference scheduler: constant, then *e^-0.1 per epoch
    (train-blobnet.py:71-77); float32 arithmetic, as the JAX package's."""

    def fn(step):
        epoch = step // steps_per_epoch
        decay_epochs = max(epoch - decay_start_epoch + 1, 0)
        return float(np.float32(base_lr)
                     * np.exp(np.float32(-0.1) * np.float32(decay_epochs)))

    return fn


def make_adam(model: BlobNet, lr: float = 1e-3) -> torch.optim.Adam:
    """Adam with optax.adam's defaults, one tensor at a time."""
    return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            foreach=False)


def make_train_step(model: BlobNet, optimizer: torch.optim.Optimizer,
                    signed_mv: bool = False, generator=None, process_group=None):
    """step(batch, lr=None) -> {"loss", "precision", "recall"} (0-dim
    tensors): one update of `model` in place. batch is (x (B, T, H, W, C)
    raw metadata, y (B, H, W) labels), numpy or tensors; `lr`, when given,
    is set on the optimizer before the update. Dropout masks come from
    `generator`, on the model's device. On the card, TF32 is turned off
    (float32 as the JAX package trains; `exact_float32`).

    Data parallel with `process_group` (one rank a device, each with
    its shard of the batch and an equal model and optimizer): the step is
    the one-device step on the global batch, as the JAX step jitted over
    a mesh-sharded batch. BatchNorm takes the global batch's statistics;
    each rank's loss enters the graph as its share of the global mean
    (the loss is a mean over samples); the gradients are summed over the
    ranks before Adam, so every rank's parameters stay equal; the loss
    returned is the global one, precision and recall ratios of the
    summed counts."""
    dev = next(model.parameters()).device
    exact_float32(dev)

    def train_step(batch, lr=None):
        x, y = batch
        # The model's input contract is clip(x,0,6)/6-normalized metadata
        # (signed_mv: the signed offset-128 MV normalization), as the
        # pipeline's metapreprocess feeds it.
        x = clip6_normalize(torch.as_tensor(x, device=dev), signed_mv)
        y = torch.as_tensor(y, device=dev)
        if lr is not None:
            for group in optimizer.param_groups:
                group["lr"] = lr
        model.train()
        out = model(x, generator=generator, process_group=process_group)
        loss = jaccard_distance_loss(y, out)
        counts = precision_recall_counts(y, out.detach())
        optimizer.zero_grad(set_to_none=True)
        if process_group is None:
            loss.backward()
        else:
            n_global = int(_all_reduce(torch.tensor(y.shape[0], device=dev), process_group))
            share = loss * (y.shape[0] / n_global)
            share.backward()
            params = [p for p in model.parameters() if p.grad is not None]
            flat = _all_reduce(torch.cat([p.grad.reshape(-1) for p in params]),
                               process_group)
            for p, g in zip(params, flat.split([p.numel() for p in params])):
                p.grad.copy_(g.view_as(p))
            loss = _all_reduce(share.detach(), process_group)
            counts = _all_reduce(counts, process_group)
        optimizer.step()
        prec, rec = precision_recall_from_counts(counts)
        return {"loss": loss.detach(), "precision": prec, "recall": rec}

    return train_step


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of `x` over the group's ranks (in place, returned)."""
    import torch.distributed as dist

    dist.all_reduce(x, group=group)
    return x


def _host_copy(model: BlobNet) -> dict:
    return {k: v.detach().to("cpu", copy=True) for k, v in model.state_dict().items()}


def train_blobnet(
    dataset,
    epochs: int = 20,
    base_lr: float = 1e-3,
    config: BlobNetConfig = BlobNetConfig(),
    generator=None,
    log_every: int = 50,
    should_stop=lambda: False,
    signed_mv: bool = False,
    variables=None,
    device="cuda",
):
    """dataset: iterable of (x (B,T,H,W,C) float, y (B,H,W) float) per
    epoch (iter is called each epoch). `generator` (on `device`; default
    seeded with 0) draws the initial weights, unless `variables` (a
    BlobNet state_dict, e.g. an artifact's or the JAX init converted)
    gives them, and the dropout masks. Returns (model, state_dict): the
    best epoch's weights by F1 over its running metrics, the model in
    eval mode on `device`, the state_dict a host copy."""
    device = torch.device(device)
    if generator is None:
        generator = torch.Generator(device).manual_seed(0)
    if generator.device.type != device.type:
        raise ValueError(f"generator on {generator.device}, training on {device}")
    if variables is None:
        model, _ = create_blobnet(generator, config, device)
    else:
        model = BlobNet(config)
        model.load_state_dict(variables)
        model.to(device)
    steps_per_epoch = getattr(dataset, "steps_per_epoch", 1000)
    schedule = lr_schedule(base_lr, 10, steps_per_epoch)
    optimizer = make_adam(model, schedule(0))
    step_fn = make_train_step(model, optimizer, signed_mv, generator)

    step = 0
    best = None  # (f1, epoch, state_dict on the host)
    for epoch in range(epochs):
        ep_loss = ep_prec = ep_rec = 0.0
        nb = 0
        for batch in dataset:
            metrics = step_fn(batch, schedule(step))
            step += 1
            ep_loss += float(metrics["loss"])
            ep_prec += float(metrics["precision"])
            ep_rec += float(metrics["recall"])
            nb += 1
            if log_every and step % log_every == 0:
                print(
                    f"epoch {epoch} step {step}: "
                    f"loss={float(metrics['loss']):.3f} "
                    f"prec={float(metrics['precision']):.3f} "
                    f"rec={float(metrics['recall']):.3f}"
                )
            if should_stop():
                break
        if nb:
            # Keep the best epoch by F1 over the epoch's running metrics —
            # the reference returns the last epoch, which can regress late
            # in training.
            p, r = ep_prec / nb, ep_rec / nb
            f1 = 2 * p * r / max(p + r, 1e-9)
            print(
                f"epoch {epoch}: mean loss={ep_loss / nb:.3f} "
                f"prec={p:.3f} rec={r:.3f} f1={f1:.3f}"
            )
            if best is None or f1 > best[0]:
                best = (f1, epoch, _host_copy(model))
        if should_stop():
            print("training interrupted, returning best weights so far")
            break
    model.eval()
    if best is not None:
        print(f"best epoch: {best[1]} (f1 {best[0]:.3f})")
        model.load_state_dict(best[2])
        return model, best[2]
    return model, _host_copy(model)

"""BatchNorm as Flax computes it, for BlobNet's plain path (PyTorch port
of the BatchNorm in cova_tpu/models/blobnet.py)."""

import torch
from torch import nn

BN_MOMENTUM = 0.99  # Flax's: running = 0.99 * running + 0.01 * batch


def batch_norm(bn: nn.BatchNorm2d, x: torch.Tensor, process_group=None) -> torch.Tensor:
    """BatchNorm over (N, C, H, W). Eval mode: the running statistics.
    Train mode, as Flax: the batch mean and biased variance
    (E[x^2] - E[x]^2, clipped at 0), y = (x - mean) * (scale *
    rsqrt(var + eps)) + bias, and the running statistics updated as
    0.99 * running + 0.01 * batch without gradient.

    With a process group (data-parallel training, each rank holding a
    shard of the batch), the batch is the global one, as in a Flax step
    jitted over a sharded batch: the per-channel sums of x and x^2 and
    the count are all-reduced with autograd, so every rank normalises
    with, and stores, the global mean and variance. The all-reduce's
    backward sums the incoming gradients over the ranks: each rank's loss
    must enter the graph as its share of the global loss."""
    if not bn.training:
        return bn(x)
    axes = (0, 2, 3)
    if process_group is None:
        mean = x.mean(dim=axes)
        ex2 = (x * x).mean(dim=axes)
    else:
        c = x.shape[1]
        count = x.new_full((1,), x.numel() // c)
        from torch.distributed.nn.functional import all_reduce

        sums = all_reduce(torch.cat([x.sum(dim=axes), (x * x).sum(dim=axes), count]),
                          group=process_group)
        mean, ex2 = sums[:c] / sums[-1], sums[c : 2 * c] / sums[-1]
    var = torch.clamp(ex2 - mean * mean, min=0.0)
    with torch.no_grad():
        bn.running_mean.mul_(BN_MOMENTUM).add_((1.0 - BN_MOMENTUM) * mean)
        bn.running_var.mul_(BN_MOMENTUM).add_((1.0 - BN_MOMENTUM) * var)
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    return (x - mean[:, None, None]) * mul[:, None, None] + bn.bias[:, None, None]

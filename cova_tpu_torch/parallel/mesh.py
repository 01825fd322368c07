"""Device mesh and sharding helpers (PyTorch port of
cova_tpu/parallel/mesh.py).

The reference scales out by fanning one bitstream across 32 entropy
decoder branches and batching their outputs through shared inference
engines. The port does so in two ways, as the JAX package does with one
jax Mesh:

  * inference, one process: GoP ranges form a leading batch axis R, and
    a `Mesh` (an ordered tuple of devices and an axis name) splits R into
    equal contiguous blocks, block i on device i (`shard_batch`), with
    one replica of the model per device (`replicate`). The compressed
    stage issues the blocks' steps in turn and joins the outputs in range
    order (pipeline/compressed.py).
  * training, one process per device: `run_ranks` starts the ranks with
    torch.multiprocessing and a process group (gloo on the CPU, NCCL
    across cards); each rank holds a shard of the batch, the parameters
    are replicated, and the data-parallel step all-reduces BatchNorm's
    batch sums and the gradients (models/train_blobnet.py), so every rank
    computes the global-batch step.

On the CPU a mesh holds `n` virtual devices, all `torch.device("cpu")`:
the counterpart of the JAX tests' --xla_force_host_platform_device_count.
"""

from __future__ import annotations

import copy
import dataclasses
import datetime
import os
import pickle
import socket
import tempfile

import numpy as np
import torch
from torch import nn

STREAM_AXIS = "stream"
# Virtual CPU devices of a CPU mesh when no count is given (the JAX
# tests run 8).
CPU_DEVICES = 8
# Seconds any collective or the rendezvous may wait before it fails.
COLLECTIVE_TIMEOUT_S = 60.0


@dataclasses.dataclass(frozen=True)
class Mesh:
    """An ordered 1-D mesh: `devices[i]` holds block i of a sharded axis."""

    devices: tuple
    axis: str = STREAM_AXIS

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(n_devices: int | None = None, axis: str = STREAM_AXIS,
              device_type: str = "cuda", devices=None) -> Mesh:
    """A mesh of the first `n_devices` devices of `device_type` (all that
    are visible when None), or of the explicit `devices` list (a device
    may repeat: [cuda:0, cuda:0] rehearses two shards on one card). On
    CUDA it raises when more devices are asked for than are visible; on
    the CPU it gives `n_devices` (default CPU_DEVICES) virtual devices."""
    if devices is not None:
        devs = tuple(torch.device(d) for d in devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        visible = torch.cuda.device_count()
        for d in devs:
            if d.type == "cuda" and (d.index or 0) >= visible:
                raise ValueError(f"mesh device {d} is not visible ({visible} CUDA devices)")
        return Mesh(devs, axis)
    if device_type == "cpu":
        n = n_devices or CPU_DEVICES
        return Mesh((torch.device("cpu"),) * n, axis)
    if device_type != "cuda":
        raise ValueError(f"unsupported device type {device_type!r}")
    visible = torch.cuda.device_count()
    n = n_devices or visible
    if n < 1 or n > visible:
        raise ValueError(
            f"requested {n}-device mesh but only {visible} CUDA devices are "
            f"visible (device_type='cpu' gives virtual CPU devices)"
        )
    return Mesh(tuple(torch.device("cuda", i) for i in range(n)), axis)


def _tree_map(fn, tree):
    """`fn` over every tensor or numpy array of a tree of dataclasses,
    dicts, lists and tuples."""
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return fn(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return type(tree)(**{f.name: _tree_map(fn, getattr(tree, f.name))
                             for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return tree


def shard_batch(mesh: Mesh, tree) -> list:
    """Split the leading axis of every array in `tree` (tensors or numpy
    arrays) into mesh.size equal contiguous blocks: returns one tree a
    device, block i as tensors on mesh.devices[i] (the counterpart of
    NamedSharding(P(axis))). Raises when the axis does not divide."""

    def block(i):
        def take(x):
            x = torch.as_tensor(x)
            if x.dim() == 0:
                raise ValueError("a scalar has no axis to shard")
            n = x.shape[0]
            if n % mesh.size:
                raise ValueError(
                    f"leading axis {n} not divisible by mesh size {mesh.size}"
                )
            b = n // mesh.size
            return x[i * b : (i + 1) * b].to(mesh.devices[i])

        return _tree_map(take, tree)

    return [block(i) for i in range(mesh.size)]


def replicate(mesh: Mesh, x) -> list:
    """One independent copy of `x` (a tensor, a tree of tensors or an
    nn.Module) on each device of the mesh."""
    if isinstance(x, nn.Module):
        return [copy.deepcopy(x).to(d) for d in mesh.devices]
    return [_tree_map(lambda t, d=d: torch.as_tensor(t).to(d, copy=True), x)
            for d in mesh.devices]


def _free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, fn, world_size, backend, port, out_dir, args):
    import torch.distributed as dist

    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(
        backend, init_method=f"tcp://localhost:{port}", world_size=world_size,
        rank=rank, timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S),
    )
    try:
        result = fn(rank, world_size, *args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def run_ranks(fn, world_size: int, backend: str, args=()) -> list:
    """Run `fn(rank, world_size, *args)` in `world_size` processes
    (torch.multiprocessing, spawn) joined by one default process group of
    `backend` ("gloo", or "nccl" with rank r on cuda:r) over a free
    localhost port; every collective and the rendezvous time out after
    COLLECTIVE_TIMEOUT_S. `fn` must be importable (a module-level function) and
    its arguments and result picklable: return host data. Returns the
    ranks' results in rank order; raises if any rank raised."""
    import torch.multiprocessing as mp

    port = _free_port()
    with tempfile.TemporaryDirectory() as out_dir:
        mp.spawn(_rank_main, nprocs=world_size, join=True,
                 args=(fn, world_size, backend, port, out_dir, tuple(args)))
        results = []
        for rank in range(world_size):
            with open(os.path.join(out_dir, f"rank{rank}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    return results

"""Entry points: a one-device forward check and a multi-device dry run
(the PyTorch port's counterpart of __graft_entry__.py).

    python -m cova_tpu_torch.graft_entry [N_DEVICES] [--device cpu]

runs `dryrun_multichip`: N ranks, one a device (N CUDA cards over NCCL,
or N CPU processes over gloo with --device cpu), each through the four
parts of the JAX dry run on its shard, and prints one
`dryrun_multichip ok on N devices: ...` line. Unlike the JAX function it
does not pick the platform for the caller: `device_type` says where the
ranks run, and CUDA ranks need N visible cards.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from cova_tpu_torch.models.blobnet import BlobNet, BlobNetConfig, create_blobnet


def entry(device="cuda"):
    """(forward, (model, x)): BlobNet's eval forward at the default
    (full-width) config on a zero (8, 4, 45, 80, 3) batch on `device`."""
    model, _ = create_blobnet(torch.Generator().manual_seed(0), BlobNetConfig(), device)

    def forward(model, x):
        with torch.no_grad():
            return model(x)

    x = torch.zeros((8, 4, 45, 80, 3), dtype=torch.float32, device=device)
    return forward, (model, x)


def _block(a, rank: int, world_size: int):
    """Rank `rank`'s contiguous block of the leading axis of `a`."""
    b = len(a) // world_size
    return a[rank * b : (rank + 1) * b]


def data_parallel_steps(rank, world_size, device, config, state, batches, lr=1e-3,
                        signed_mv=False):
    """One rank's part of len(batches) data-parallel train steps over the
    default process group (run through parallel.mesh.run_ranks): BlobNet
    of `config` from `state` (a state_dict as numpy arrays) on `device`,
    Adam at `lr`, and rank `rank`'s block of each global batch (x, y).
    Returns host data: each step's metrics, this rank's outputs of the
    first step's forward, the gradients and the state after the first
    step, and the final state."""
    import torch.distributed as dist

    from cova_tpu_torch.models.train_blobnet import make_adam, make_train_step

    dev = torch.device(device)
    if dev.type == "cpu":
        torch.set_num_threads(1)
    model = BlobNet(config)
    model.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in state.items()})
    model.to(dev)
    outs = []
    hook = model.register_forward_hook(lambda m, i, o: outs.append(o.detach().cpu().numpy()))
    step = make_train_step(model, make_adam(model, lr), signed_mv,
                           process_group=dist.group.WORLD)

    def host_state():
        return {k: v.detach().cpu().numpy().copy() for k, v in model.state_dict().items()}

    metrics = []
    first = {}
    for i, (x, y) in enumerate(batches):
        m = step((_block(x, rank, world_size), _block(y, rank, world_size)))
        metrics.append({k: float(v) for k, v in m.items()})
        if i == 0:
            first = {
                "out": outs[0],
                "grads": {n: p.grad.cpu().numpy().copy() for n, p in model.named_parameters()},
                "state": host_state(),
            }
    hook.remove()
    return {"metrics": metrics, "first": first, "state": host_state()}


def _dryrun_rank(rank, world_size, device_type):
    """One rank of dryrun_multichip; returns its report line's parts."""
    import torch.distributed as dist

    from cova_tpu_torch.config import CompressedStageConfig, CovaConfig, SortConfig
    from cova_tpu_torch.models.train_blobnet import make_adam, make_train_step
    from cova_tpu_torch.pipeline.compressed import compressed_masks_step, compressed_stage_step
    from cova_tpu_torch.tracker.sort import sort_init

    if device_type == "cpu":
        dev = torch.device("cpu")
        torch.set_num_threads(1)
    else:
        dev = torch.device("cuda", rank)

    # ---- training step, data parallel: batch 2 a rank, the parameters
    # replicated (every rank draws the same init), BatchNorm and the
    # gradients over the global batch.
    model, _ = create_blobnet(torch.Generator().manual_seed(0), BlobNetConfig(), dev)
    step = make_train_step(model, make_adam(model),
                           generator=torch.Generator(dev).manual_seed(rank),
                           process_group=dist.group.WORLD)
    b = 2
    metrics = step((np.zeros((b, 4, 45, 80, 3), np.float32),
                    np.zeros((b, 45, 80), np.float32)))

    # ---- compressed-domain chunk step, stream parallel: one GoP range
    # a rank, the outputs gathered in range order.
    cfg = CovaConfig(sort=SortConfig(max_tracks=16),
                     compressed=CompressedStageConfig(batch_frames=4))
    f, t = 4, cfg.video.timestep
    model.eval()

    def gathered(x):
        parts = [torch.empty_like(x) for _ in range(world_size)]
        dist.all_gather(parts, x.contiguous())
        return torch.cat(parts)

    metadata = torch.zeros((1, f + t - 1, 45, 80, 3), dtype=torch.uint8, device=dev)
    ts0 = torch.zeros((1,), dtype=torch.int32, device=dev)
    _, packed, _, _ = compressed_stage_step(
        model, cfg, metadata, sort_init(cfg.sort.max_tracks, 1, dev), ts0, max_boxes=8
    )
    packed = gathered(packed)

    # ---- the masks step (host_tracking=True), on 3-channel u8 input and
    # on the codec's 2-byte wire16 input.
    masks = gathered(compressed_masks_step(model, cfg, metadata))
    wire = torch.zeros((1, f + t - 1, 45, 80, 2), dtype=torch.uint8, device=dev)
    masks16 = gathered(compressed_masks_step(model, cfg, wire))
    if masks16.shape != masks.shape:
        raise AssertionError(f"wire16 masks {tuple(masks16.shape)} != {tuple(masks.shape)}")
    return {"loss": float(metrics["loss"]),
            "packed": (tuple(packed.shape), str(packed.dtype).replace("torch.", "")),
            "masks": (tuple(masks.shape), str(masks.dtype).replace("torch.", ""))}


def dryrun_multichip(n_devices: int, device_type: str = "cuda") -> str:
    """Run the data-parallel BlobNet train step (full width, batch 2 a
    rank), the stream-parallel all-device stage step (SortConfig(
    max_tracks=16), F=4, max_boxes=8) and the masks step on u8 and wire16
    input, over `n_devices` ranks: NCCL across as many CUDA cards, or
    gloo across CPU processes (device_type="cpu"). Prints and returns
    the report line."""
    from cova_tpu_torch.parallel.mesh import make_mesh, run_ranks

    make_mesh(n_devices, device_type=device_type)  # raises without the devices
    backend = "gloo" if device_type == "cpu" else "nccl"
    rep = run_ranks(_dryrun_rank, n_devices, backend, args=(device_type,))[0]
    (pshape, pdtype), (mshape, mdtype) = rep["packed"], rep["masks"]
    line = (f"dryrun_multichip ok on {n_devices} devices: "
            f"train loss {rep['loss']:.3f}, "
            f"packed chunk outputs {pshape} {pdtype}, "
            f"packed masks {mshape} {mdtype}")
    print(line, flush=True)
    return line


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Multi-device dry run of the port.")
    ap.add_argument("n_devices", nargs="?", type=int, default=None,
                    help="ranks (default: every visible card; 2 with --device cpu)")
    ap.add_argument("--device", default="cuda", help="cuda (NCCL) or cpu (gloo)")
    return ap


def main(argv=None) -> None:
    args = parser().parse_args(argv)
    n = args.n_devices
    if n is None:
        n = 2 if args.device == "cpu" else torch.cuda.device_count()
    dryrun_multichip(n, args.device)


if __name__ == "__main__":
    main()

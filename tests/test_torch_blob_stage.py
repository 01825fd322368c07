"""The tail of a BlobNet encoder stage (K4, ops/cuda/blob_stage.py).

On the CPU: `blob_stage_plain` equals, bit for bit, the sequence BlobNet's
forward ran inline before the kernel, on every stage shape of the 45x80
and 68x120 grids, in eval and train mode; the wrapper runs the plain
version on the CPU and raises on what the kernel does not take; train
mode and the CPU never launch the kernel (BlobNet's eval forward against the
JAX package stays in tests/test_torch_blobnet.py).

On the card (marked `cuda`, skipped without one; run there with
`python -m pytest tests/test_torch_blob_stage.py -m cuda`): the kernel
against the plain version on every stage shape of both grids, from
channels-last input (float4-aligned, and one float off), and NCHW input,
at 4 and 2048 windows' timesteps; BlobNet's probabilities on the first
chunk of both benchmark clips against its forward with the plain tails;
four launches a chunk, none in train mode; an eval forward that asks for
a gradient raises."""

import dataclasses
import functools
import pathlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cova_tpu_torch import trace
from cova_tpu_torch.models import blobnet as tbn
from cova_tpu_torch.ops.cuda.blob_stage import blob_stage, blob_stage_plain

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
T = 4
GRIDS = [(45, 80), (68, 120)]
STAGES = range(4)
# K4 against its plain version on the card: BatchNorm and the K = 4 mixes
# round in other orders (cuDNN, cuBLAS), a few ulps of the stage's
# largest output (the kernel's arithmetic built on the CPU read 2.6e-7).
KERNEL_REL_TOL = 1e-6
PROBS_TOL = 1e-5
BENCH_CLIPS = {
    "720p": ("bench_port/data/synth_1800.mp4", "bench_port/data/blobnet_synth.npz"),
    "1080p": ("bench_port/data/synth_1800_1080p.mp4", "bench_port/data/blobnet_demo1080.npz"),
}


def _stage_shape(grid, stage, cin=4, channels=(16, 32, 64, 128)):
    """(C_in, C, H, W) of encoder stage `stage` on an (h, w) grid."""
    h, w = grid
    for _ in range(stage):
        h, w = h // 2 + h % 2, w // 2 + w % 2
    return (cin, *channels)[stage], channels[stage], h, w


def _modules(c, gen, dropout=0.2):
    """A BatchNorm2d and a PointWiseTemporal of c channels with seeded
    weights, statistics and mixes (negative BatchNorm scales included)."""
    bn = torch.nn.BatchNorm2d(c, eps=tbn.BN_EPS)
    pwt = tbn.PointWiseTemporal(2, T, dropout)
    with torch.no_grad():
        bn.weight.copy_(torch.randn(c, generator=gen))
        bn.bias.copy_(0.5 * torch.randn(c, generator=gen))
        bn.running_mean.copy_(torch.rand(c, generator=gen))
        bn.running_var.copy_(0.1 + torch.rand(c, generator=gen))
        for m in pwt.mix:
            m.copy_(0.7 * torch.randn(T, T, generator=gen))
    return bn, pwt


def _conv_output(batch, c, h, w, gen, channels_last, device="cpu", offset=False):
    """A seeded (batch * T, c, h, w) stand-in for a convolution's output,
    in the layout cuDNN gives it: channels-last for stage 1, whose input
    is the permuted metadata, NCHW for the others. `offset`: channels-last
    data that starts one float into its buffer, so no tap is
    float4-aligned."""
    y = torch.randn(batch * T, c, h, w, generator=gen).to(device)
    if offset:
        buf = torch.empty(y.numel() + 1, device=device)[1:]
        return buf.view(batch * T, h, w, c).copy_(y.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
    return y.contiguous(memory_format=torch.channels_last) if channels_last else y


def _former_tail(y, bn, pwt, batch, generator, process_group=None):
    """BlobNet.forward's encoder tail as it stood inline before K4."""
    y = tbn.batch_norm(bn, F.relu(y), process_group)
    h, w = y.shape[-2:]
    if h >= 2 and w >= 2:
        z = F.max_pool2d(y, 2)
    else:
        z = y.new_zeros(y.shape[:-2] + (h // 2, w // 2))
    y = F.pad(z, (w % 2, 0, h % 2, 0))
    return pwt(y.reshape((batch, T) + y.shape[1:]), generator)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("stage", STAGES)
@pytest.mark.parametrize("grid", GRIDS, ids=["45x80", "68x120"])
def test_plain_equals_former_sequence(grid, stage, train):
    gen = torch.Generator().manual_seed(100 * stage + grid[0])
    _, c, h, w = _stage_shape(grid, stage)
    bn, pwt = _modules(c, gen)
    bn_ref, pwt_ref = _modules(c, torch.Generator().manual_seed(100 * stage + grid[0]))
    for m in (bn, pwt, bn_ref, pwt_ref):
        m.train(train)
    y = _conv_output(2, c, h, w, gen, channels_last=stage == 0)
    norm = functools.partial(tbn.batch_norm, bn, process_group=None)
    with torch.no_grad():
        got = blob_stage_plain(y, norm, pwt, 2, torch.Generator().manual_seed(7))
        ref = _former_tail(y, bn_ref, pwt_ref, 2, torch.Generator().manual_seed(7))
    assert got.shape == (2, T, c, h // 2 + h % 2, w // 2 + w % 2)
    assert torch.equal(got, ref)
    assert torch.equal(bn.running_mean, bn_ref.running_mean)
    assert torch.equal(bn.running_var, bn_ref.running_var)


@pytest.mark.parametrize("stage", STAGES)
@pytest.mark.parametrize("grid", GRIDS, ids=["45x80", "68x120"])
def test_wrapper_takes_every_stage_and_runs_plain_on_cpu(grid, stage):
    gen = torch.Generator().manual_seed(stage)
    _, c, h, w = _stage_shape(grid, stage)
    bn, pwt = _modules(c, gen)
    bn.eval(), pwt.eval()
    y = _conv_output(1, c, h, w, gen, channels_last=stage == 0)
    launches = blob_stage.launches
    with torch.no_grad():
        got = blob_stage(y, bn, pwt, 1)
        ref = blob_stage_plain(y, bn, pwt, 1)
    assert got.is_contiguous() and torch.equal(got, ref)
    assert blob_stage.launches == launches


def _refused(case):
    """(y, bn, pwt, batch, grad) of one argument set the wrapper refuses."""
    gen = torch.Generator().manual_seed(1)
    bn, pwt = _modules(8, gen)
    bn.eval(), pwt.eval()
    y = torch.randn(2 * T, 8, 6, 10, generator=gen)
    grad = False
    if case == "float64":
        y = y.double()
    elif case == "meta_device":
        y = y.to("meta")
    elif case == "batch_times_t":
        y = y[:6]
    elif case == "three_dims":
        y = y[:, 0]
    elif case == "bn_train":
        bn.train()
    elif case == "pwt_train":
        pwt.train()
    elif case == "five_mixes":
        pwt = tbn.PointWiseTemporal(5, T).eval()
    elif case == "mix_3x3":
        pwt = tbn.PointWiseTemporal(2, 3).eval()
    elif case == "bn_channels":
        bn = torch.nn.BatchNorm2d(4).eval()
    elif case == "bn_float64":
        bn = torch.nn.BatchNorm2d(8).double().eval()
    elif case == "no_running_stats":
        bn = torch.nn.BatchNorm2d(8, track_running_stats=False).eval()
    elif case == "gradient":
        grad = True
    return y, bn, pwt, 2, grad


@pytest.mark.parametrize("case", [
    "float64", "meta_device", "batch_times_t", "three_dims", "bn_train", "pwt_train",
    "five_mixes", "mix_3x3", "bn_channels", "bn_float64", "no_running_stats", "gradient"])
def test_wrapper_refuses(case):
    y, bn, pwt, batch, grad = _refused(case)
    with torch.set_grad_enabled(grad), pytest.raises(ValueError, match="."):
        blob_stage(y, bn, pwt, batch)


def _counted_forward(model, x, **kw):
    """The forward's output and its counters (summed over runs)."""
    trace.take()
    trace.enable()
    try:
        out = model(x, **kw)
    finally:
        trace.disable()
    counts = {}
    for per in trace.take()["counters"].values():
        for k, v in per.items():
            counts[k] = counts.get(k, 0) + v
    return out, counts


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_cpu_and_train_mode_launch_no_kernel(train):
    model = tbn.BlobNet(tbn.BlobNetConfig(in_channels=4))
    model.reset_parameters(torch.Generator().manual_seed(0))
    model.train(train)
    x = torch.rand(2, T, 23, 40, 4, generator=torch.Generator().manual_seed(1))
    launches = blob_stage.launches
    with torch.set_grad_enabled(train):
        _, counts = _counted_forward(model, x, generator=torch.Generator().manual_seed(2))
    assert counts.get("blobnet.stages") == 4
    assert counts.get("blobnet.stages_fused", 0) == 0
    assert blob_stage.launches == launches


# --- on the card ----------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: K4 has no CPU build")
    from cova_tpu_torch.pipeline.compressed import exact_float32

    exact_float32("cuda")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("windows", [1, 512], ids=["BT4", "BT2048"])
@pytest.mark.parametrize("layout", ["channels_last", "channels_last_offset", "nchw"])
@pytest.mark.parametrize("stage", STAGES)
@pytest.mark.parametrize("grid", GRIDS, ids=["45x80", "68x120"])
def test_cuda_kernel_matches_plain(cuda_device, grid, stage, layout, windows):
    gen = torch.Generator().manual_seed(10 * stage + windows)
    _, c, h, w = _stage_shape(grid, stage)
    bn, pwt = _modules(c, gen)
    bn, pwt = bn.to(cuda_device).eval(), pwt.to(cuda_device).eval()
    y = _conv_output(windows, c, h, w, gen, layout != "nchw", cuda_device,
                     offset=layout == "channels_last_offset")
    assert (y.stride(1) == 1) == (layout != "nchw")
    launches = blob_stage.launches
    with torch.no_grad():
        ref = blob_stage_plain(y, bn, pwt, windows)
        for _ in range(3):
            got = blob_stage(y, bn, pwt, windows)
            torch.cuda.synchronize()
            assert got.shape == ref.shape and got.is_contiguous()
            err = float((got - ref).abs().max())
            assert err <= KERNEL_REL_TOL * float(ref.abs().max()), err
    assert blob_stage.launches == launches + 3


def _first_chunk_windows(name, device):
    """BlobNet on `device` and the preprocessed windows (R * F, T, H, W, C)
    of the first chunk (R = 4 GoP ranges, F = 128) of a benchmark clip,
    with its weights' input contract."""
    from cova_tpu_torch import bench
    from cova_tpu_torch.codec import Mp4Demuxer
    from cova_tpu_torch.config import CovaConfig, ParallelConfig
    from cova_tpu_torch.examples.profile_device import with_weights_contract
    from cova_tpu_torch.ops.preprocess import metapreprocess, unpack_wire16
    from cova_tpu_torch.pipeline.ranges import RangePlan

    clip, weights = (REPO / p for p in BENCH_CLIPS[name])
    model, _, meta = tbn.load_artifact(weights, device)
    cfg = with_weights_contract(CovaConfig(), meta)
    r, t = 4, cfg.video.timestep
    demux = Mp4Demuxer(str(clip))
    try:
        plan = RangePlan.build(
            [demux], dataclasses.replace(cfg, parallel=ParallelConfig(num_ranges=r)))
        b = bench.Bench(str(clip), demux, cfg, model, torch.device("cpu"), 8, plan, None)
        chunk = bench.fresh_chunk(b, r)
        bench.fill_chunk(b, chunk.numpy(), [0] * r, 0, b.plan)
    finally:
        demux.close()
    c = cfg.compressed
    md = unpack_wire16(chunk.to(device), c.use_nnz_channel, c.signed_mv)
    x = metapreprocess(md, t, c.gamma, c.signed_mv)
    return model, cfg, x.reshape((-1,) + x.shape[2:])


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(BENCH_CLIPS))
def test_cuda_blobnet_on_bench_clip_matches_eager(cuda_device, name, monkeypatch):
    model, cfg, x = _first_chunk_windows(name, cuda_device)
    with torch.no_grad():
        launches = blob_stage.launches
        got, counts = _counted_forward(model, x)
        assert blob_stage.launches == launches + 4
        # The eager forward: the model's own, each stage's tail the plain version.
        monkeypatch.setattr(tbn, "blob_stage", lambda y, bn, pwt, b: blob_stage_plain(y, bn, pwt, b))
        ref, _ = _counted_forward(model, x)
        assert blob_stage.launches == launches + 4
    assert counts["blobnet.stages"] == counts["blobnet.stages_fused"] == 4
    err = float((got - ref).abs().max())
    assert err <= PROBS_TOL, err
    thr = cfg.compressed.mask_threshold
    assert torch.equal(got > thr, ref > thr)


@pytest.mark.cuda
def test_cuda_four_launches_a_chunk_none_in_train_mode(cuda_device):
    from cova_tpu_torch.pipeline.compressed import compressed_masks_step

    model, cfg, _ = _first_chunk_windows("720p", cuda_device)
    rng = np.random.default_rng(3)
    chunk = torch.from_numpy(rng.integers(0, 256, size=(4, 131, 45, 80, 2), dtype=np.uint8))
    launches = blob_stage.launches
    compressed_masks_step(model, cfg, chunk.to(cuda_device))
    torch.cuda.synchronize()
    assert blob_stage.launches == launches + 4
    model.train()
    x = torch.rand(2, T, 45, 80, 4, device=cuda_device)
    _, counts = _counted_forward(model, x, generator=torch.Generator(device=cuda_device).manual_seed(0))
    assert counts["blobnet.stages"] == 4 and counts.get("blobnet.stages_fused", 0) == 0
    assert blob_stage.launches == launches + 4


@pytest.mark.cuda
def test_cuda_eval_forward_asking_for_a_gradient_raises(cuda_device):
    model = tbn.BlobNet(tbn.BlobNetConfig(in_channels=4)).to(cuda_device).eval()
    x = torch.rand(1, T, 23, 40, 4, device=cuda_device)
    launches = blob_stage.launches
    with torch.enable_grad(), pytest.raises(ValueError, match="no backward"):
        model(x)
    assert blob_stage.launches == launches

"""An upsampling block of BlobNet's decoder (K12, ops/cuda/blob_up.py).

On the CPU: a chain of `blob_up_plain` equals, bit for bit, the decoder
BlobNet's forward ran inline before the kernel, block by block on the
45x80 and 68x120 grids, in eval and in train mode (dropout from a seeded
generator, BatchNorm's running statistics updated alike), and so does the
whole forward; the four-phase decomposition the kernel computes, written
as a torch expression at the wrapper's crop offsets, equals
ConvTranspose2d and the centre crop/pad; the wrapper refuses what the
kernel does not take, the CPU among it, and takes every block of both
grids and of planes 256 and 480 macroblocks wide; train mode and the CPU
send no block to the kernel.

On the card (marked `cuda`, skipped without one; run there with
`python -m pytest tests/test_torch_blob_up.py -m cuda`): the kernel
against the plain version on every block of both grids at 1 and 512
windows, and on planes 256 and 480 macroblocks wide with skips of either
sign; BlobNet's eval forward on the first chunk of both benchmark
clips against its forward with the plain decoder, the masks equal but
where the plain probability lies within 1e-4 of the threshold; the
engaged share 1.0 in eval and 0 in train mode; an eval forward that asks
for a gradient raises."""

import pathlib

import pytest
import torch
import torch.nn.functional as F
from test_torch_blob_stage import _counted_forward, _first_chunk_windows, cuda_device  # noqa: F401

from cova_tpu_torch.models import blobnet as tbn
from cova_tpu_torch.ops.cuda import blob_up as bu
from cova_tpu_torch.ops.cuda.blob_up import blob_up, blob_up_plain, crop_offset, crop_or_pad_center

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
GRIDS = [(45, 80), (68, 120)]
GRID_IDS = ["45x80", "68x120"]
# Planes wider than one warp's quad columns in the last blocks (4096 and
# 7680 pixels across), which the kernel splits into column bands.
WIDE = [(9, 256), (9, 480)]
WIDE_IDS = ["9x256", "9x480"]
BLOCKS = range(4)
# Each grid's committed weights, as the benchmark's pipelines load them.
WEIGHTS = {(45, 80): "blobnet_synth.npz", (68, 120): "blobnet_demo1080.npz"}
# K12 against its plain version on the card: the transposed convolution
# sums its 4 * Cin products in another order than cuDNN's.
KERNEL_REL_TOL = 1e-6
NEAR_THRESHOLD = 1e-4


def _model(grid, train=False, seed=0):
    """The grid's committed BlobNet on the CPU, its decoder's BatchNorm
    statistics seeded (negative scales among them), in eval or train
    mode."""
    weights = WEIGHTS.get(grid, WEIGHTS[(68, 120)])
    model = tbn.load_artifact(REPO / "artifacts" / weights, "cpu")[0]
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for bn in model.dec_bn:
            c = bn.num_features
            bn.weight.copy_(torch.randn(c, generator=gen))
            bn.bias.copy_(0.5 * torch.randn(c, generator=gen))
            bn.running_mean.copy_(0.5 * torch.randn(c, generator=gen))
            bn.running_var.copy_(0.1 + torch.rand(c, generator=gen))
    return model.train(train)


def _feats(model, grid, batch, seed, device="cpu"):
    """Seeded stand-ins for the decoder's inputs: the t = 0 slice of each
    encoder stage's output (non-negative, as K4's), deepest first, read
    through the strides of the (batch, 4, C, h, w) tensor it lies in."""
    gen = torch.Generator().manual_seed(seed)
    h, w = grid
    feats = []
    for c in model.config.encoder_channels:
        h, w = h // 2 + h % 2, w // 2 + w % 2
        feats.append(torch.rand(batch, 4, c, h, w, generator=gen).to(device)[:, 0])
    return feats[::-1]


def _former_decoder(model, feats, h0, w0, generator=None):
    """BlobNet.forward's decoder as it stood inline before K12; returns
    each block's output (BatchNorm's, before the concatenation; the last
    block's probabilities)."""
    drop = model.training and model.config.dropout > 0.0
    targets = [f.shape[-2:] for f in feats[1:]] + [(h0, w0)]
    outs = []
    x = feats[0]
    for i, convt in enumerate(model.dec_convt):
        x = F.relu(x)
        if drop:
            x = tbn._dropout(x, model.config.dropout, generator)
        x = convt(x)
        x = crop_or_pad_center(x, *targets[i])
        if i < len(model.dec_bn):
            x = tbn.batch_norm(model.dec_bn[i], x, None)
            outs.append(x)
            x = torch.cat([x, feats[i + 1]], dim=1)
    outs.append(torch.sigmoid(model.head(x).to(torch.float32))[:, 0])
    return outs


def _block_args(model, feats, h0, w0, i):
    """(convt, bn, head, target) of decoder block i, as BlobNet.forward
    hands them over."""
    bn = model.dec_bn[i] if i < len(model.dec_bn) else None
    target = feats[i + 1].shape[-2:] if i + 1 < len(feats) else (h0, w0)
    return model.dec_convt[i], bn, model.head if bn is None else None, tuple(target)


def _plain_decoder(model, feats, h0, w0, generator=None):
    """The decoder as a chain of blob_up_plain, as BlobNet.forward runs it
    in train mode and on the CPU; returns each block's output."""
    drop = model.training and model.config.dropout > 0.0
    dropout = (lambda t, g: tbn._dropout(t, model.config.dropout, g)) if drop else None
    outs, x, skip = [], feats[0], None
    for i in range(len(model.dec_convt)):
        convt, bn, head, target = _block_args(model, feats, h0, w0, i)
        x = blob_up_plain(x, skip, convt, bn, head, target, dropout, generator)
        outs.append(x)
        skip = None if bn is None else feats[i + 1]
    return outs


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("grid", GRIDS, ids=GRID_IDS)
def test_plain_equals_former_decoder(grid, block, train):
    model, ref_model = _model(grid, train), _model(grid, train)
    feats = _feats(model, grid, 2, seed=block)
    with torch.no_grad():
        got = _plain_decoder(model, feats, *grid, torch.Generator().manual_seed(7))
        ref = _former_decoder(ref_model, feats, *grid, torch.Generator().manual_seed(7))
    assert got[block].shape == ref[block].shape
    assert torch.equal(got[block], ref[block])
    if block < len(model.dec_bn):
        assert torch.equal(model.dec_bn[block].running_mean, ref_model.dec_bn[block].running_mean)
        assert torch.equal(model.dec_bn[block].running_var, ref_model.dec_bn[block].running_var)


def _former_forward(model, x, generator=None):
    """BlobNet.forward as it stood before K12, on the CPU: the encoder's
    plain stage tails, then the decoder inline (`_former_decoder`)."""
    from cova_tpu_torch.ops.cuda.blob_stage import blob_stage_plain

    b, t, h0, w0, _ = x.shape
    x = x.to(torch.float32).permute(0, 1, 4, 2, 3)
    skips = []
    for conv, bn, pwt in zip(model.enc_conv, model.enc_bn, model.enc_pwt):
        y = conv(x.reshape((b * t,) + x.shape[2:]))
        x = blob_stage_plain(y, lambda z, bn=bn: tbn.batch_norm(bn, z, None), pwt, b, generator)
        skips.append(x)
    feats = [s[:, 0] for s in reversed(skips)]
    return _former_decoder(model, feats, h0, w0, generator)[-1]


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_forward_equals_former_forward_on_cpu(train):
    model, ref_model = _model(GRIDS[0], train), _model(GRIDS[0], train)
    x = torch.rand(2, 4, 23, 40, 4, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        got = model(x, generator=torch.Generator().manual_seed(5))
        ref = _former_forward(ref_model, x, torch.Generator().manual_seed(5))
    assert got.shape == (2, 23, 40)
    assert torch.equal(got, ref)
    for bn, ref_bn in zip(model.dec_bn, ref_model.dec_bn):
        assert torch.equal(bn.running_mean, ref_bn.running_mean)


def _phases(x, weight, bias, th, tw, oy, ox):
    """The transposed convolution as the kernel computes it: output (y, x)
    is full-output (Y, X) = (y + oy, x + ox); with Y = 2 qy + e and
    X = 2 qx + f, z = bias + sum over a, b in {0, 1} of
    in[qy - a, qx - b] . W[:, :, e + 2a, f + 2b] (in = 0 outside the
    input), and 0 where (Y, X) lies outside the full output (a pad)."""
    _, _, h, w = x.shape
    xp = F.pad(x, (1, 1, 1, 1))  # input index i sits at i + 1
    ys, xs = torch.arange(th) + oy, torch.arange(tw) + ox
    qy, e = torch.div(ys, 2, rounding_mode="floor"), ys % 2
    qx, f = torch.div(xs, 2, rounding_mode="floor"), xs % 2
    z = bias[None, :, None, None].expand(x.shape[0], -1, th, tw).clone()
    for a in (0, 1):
        rows = (qy - a + 1).clamp(0, h + 1)
        for b in (0, 1):
            cols = (qx - b + 1).clamp(0, w + 1)
            v = xp[:, :, rows][:, :, :, cols]  # (B, Cin, th, tw)
            wt = weight[:, :, (e + 2 * a)[:, None], (f + 2 * b)[None, :]]  # (Cin, Cout, th, tw)
            z = z + torch.einsum("bcyx,coyx->boyx", v, wt)
    inside = ((ys >= 0) & (ys < 2 * h + 2))[:, None] & ((xs >= 0) & (xs < 2 * w + 2))[None, :]
    return torch.where(inside, z, torch.zeros((), dtype=z.dtype))


# (input plane, target plane): the model's blocks on both grids (crop
# offsets 2, 1 and 1, even and odd), and pads (negative offsets, odd and
# even).
PLANES = [((5, 8), (9, 15)), ((9, 15), (17, 30)), ((17, 30), (34, 60)), ((34, 60), (68, 120)),
          ((3, 5), (6, 10)), ((12, 20), (23, 40)), ((23, 40), (45, 80)),
          ((3, 4), (11, 13)), ((2, 2), (7, 6)), ((4, 7), (13, 16))]


@pytest.mark.parametrize("plane,target", PLANES,
                         ids=[f"{p[0]}x{p[1]}-{t[0]}x{t[1]}" for p, t in PLANES])
def test_phase_decomposition_equals_convt_and_crop(plane, target):
    gen = torch.Generator().manual_seed(plane[0] * 100 + target[1])
    convt = torch.nn.ConvTranspose2d(12, 5, 4, stride=2).double()
    with torch.no_grad():
        convt.weight.copy_(torch.randn(convt.weight.shape, generator=gen))
        convt.bias.copy_(torch.randn(5, generator=gen))
        x = torch.randn(3, 12, *plane, generator=gen, dtype=torch.float64)
        ref = crop_or_pad_center(convt(x), *target)
        h, w = plane
        oy, ox = crop_offset(2 * h + 2, target[0]), crop_offset(2 * w + 2, target[1])
        got = _phases(x, convt.weight, convt.bias, *target, oy, ox)
    assert got.shape == ref.shape == (3, 5, *target)
    assert float((got - ref).abs().max()) <= 1e-12 * float(ref.abs().max())


def _refused(case):
    """(x, skip, convt, bn, head, target, grad) of one argument set the
    wrapper refuses, and the words its reason holds."""
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(2, 16, 5, 6, generator=gen)
    skip = torch.rand(2, 4, 16, 5, 6, generator=gen)[:, 0]
    convt = torch.nn.ConvTranspose2d(32, 32, 4, stride=2)
    bn, head = torch.nn.BatchNorm2d(32).eval(), None
    target, grad = (11, 13), False
    if case == "float64":
        x, match = x.double(), "float32"
    elif case == "three_dims":
        x, match = x[0], r"\(B, C, h, w\)"
    elif case == "skip_plane":
        skip, match = skip[:, :, :4], "the skip must be"
    elif case == "skip_batch":
        skip, match = skip[:1], "the skip must be"
    elif case == "conv2d":
        convt, match = torch.nn.Conv2d(32, 32, 4), "ConvTranspose2d"
    elif case == "kernel_3":
        convt, match = torch.nn.ConvTranspose2d(32, 32, 3, stride=2), "4x4 stride-2"
    elif case == "stride_1":
        convt, match = torch.nn.ConvTranspose2d(32, 32, 4), "4x4 stride-2"
    elif case == "padding":
        convt, match = torch.nn.ConvTranspose2d(32, 32, 4, stride=2, padding=1), "4x4 stride-2"
    elif case == "output_padding":
        convt = torch.nn.ConvTranspose2d(32, 32, 4, stride=2, output_padding=1)
        match = "4x4 stride-2"
    elif case == "no_bias":
        convt, match = torch.nn.ConvTranspose2d(32, 32, 4, stride=2, bias=False), "with a bias"
    elif case == "groups":
        convt, match = torch.nn.ConvTranspose2d(32, 32, 4, stride=2, groups=2), "4x4 stride-2"
    elif case == "in_channels":
        convt, match = torch.nn.ConvTranspose2d(24, 32, 4, stride=2), "must take 32 channels"
    elif case == "cout_24":
        convt, bn = torch.nn.ConvTranspose2d(32, 24, 4, stride=2), torch.nn.BatchNorm2d(24).eval()
        match = "multiple of 16"
    elif case == "bn_and_head":
        head, match = torch.nn.Conv2d(32, 1, 1), "one of the two"
    elif case == "neither":
        bn, match = None, "one of the two"
    elif case == "bn_train":
        bn, match = bn.train(), "eval mode"
    elif case == "no_running_stats":
        bn, match = torch.nn.BatchNorm2d(32, track_running_stats=False).eval(), "running"
    elif case == "bn_float64":
        bn, match = bn.double(), "contiguous float32"
    elif case == "weight_strided":
        convt.weight = torch.nn.Parameter(convt.weight.detach().transpose(2, 3))
        match = "contiguous float32"
    elif case == "head_32_channels":
        bn, head, match = None, torch.nn.Conv2d(32, 1, 1), "must give 16 channels"
    elif case == "head_3x3":
        convt = torch.nn.ConvTranspose2d(32, 16, 4, stride=2)
        bn, head, match = None, torch.nn.Conv2d(16, 1, 3), "1x1 Conv2d"
    elif case == "head_no_bias":
        convt = torch.nn.ConvTranspose2d(32, 16, 4, stride=2)
        bn, head, match = None, torch.nn.Conv2d(16, 1, 1, bias=False), "1x1 Conv2d"
    elif case == "empty_target":
        target, match = (0, 13), "must not be empty"
    elif case == "offsets_32bit":
        x = torch.empty_strided((2, 16, 5, 6), (2**31, 30, 6, 1), device="meta")
        skip, convt, bn = skip.to("meta"), convt.to("meta"), bn.to("meta")
        match = "2\\*\\*31"
    elif case == "gradient":
        grad, match = True, "no backward"
    elif case == "cpu":
        match = "CUDA only"
    return x, skip, convt, bn, head, target, grad, match


REFUSED = ["float64", "three_dims", "skip_plane", "skip_batch", "conv2d", "kernel_3", "stride_1",
           "padding", "output_padding", "no_bias", "groups", "in_channels", "cout_24",
           "bn_and_head", "neither", "bn_train", "no_running_stats", "bn_float64",
           "weight_strided", "head_32_channels", "head_3x3", "head_no_bias", "empty_target",
           "offsets_32bit", "gradient", "cpu"]


@pytest.mark.parametrize("case", REFUSED)
def test_wrapper_refuses(case):
    x, skip, convt, bn, head, target, grad, match = _refused(case)
    launches = blob_up.launches
    with torch.set_grad_enabled(grad), pytest.raises(ValueError, match=match):
        blob_up(x, skip, convt, bn, head, target)
    assert blob_up.launches == launches


@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("grid", GRIDS + WIDE, ids=GRID_IDS + WIDE_IDS)
def test_wrapper_takes_every_block_but_on_the_cpu(grid, block):
    """Every check but the device passes for the model's own blocks at 512
    windows, on the benchmark's grids and on wide planes (on the meta
    device, which holds no data)."""
    model = _model(grid).to("meta")
    feats = _feats(_model(grid), grid, 1, seed=0)
    feats = [torch.empty_strided((512, *f.shape[1:]), (4 * f[0].numel(), *f.stride()[1:]),
                                 device="meta") for f in feats]
    convt, bn, head, target = _block_args(model, feats, *grid, block)
    c1 = convt.in_channels - (feats[block].shape[1] if block else 0)
    x = feats[0] if block == 0 else torch.empty((512, c1, *feats[block].shape[2:]), device="meta")
    skip = feats[block] if block else None
    with torch.no_grad():
        why = bu._refusal(x, skip, convt, bn, head, target)
    assert why is not None and why.startswith("the kernel runs on CUDA only")


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_cpu_and_train_mode_send_no_block_to_the_kernel(train):
    model = tbn.BlobNet(tbn.BlobNetConfig(in_channels=4))
    model.reset_parameters(torch.Generator().manual_seed(0))
    model.train(train)
    x = torch.rand(2, 4, 23, 40, 4, generator=torch.Generator().manual_seed(1))
    launches = blob_up.launches
    with torch.set_grad_enabled(train):
        _, counts = _counted_forward(model, x, generator=torch.Generator().manual_seed(2))
    assert counts.get("blobnet.up_blocks") == 4
    assert counts.get("blobnet.up_fused", 0) == 0
    assert blob_up.launches == launches


# --- on the card ----------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("windows", [1, 512])
@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("grid", GRIDS, ids=GRID_IDS)
def test_cuda_kernel_matches_plain(cuda_device, grid, block, windows):
    model = _model(grid).to(cuda_device)
    feats = _feats(model, grid, windows, seed=10 * block + windows, device=cuda_device)
    convt, bn, head, target = _block_args(model, feats, *grid, block)
    skip = feats[block] if block else None
    c1 = convt.in_channels - (skip.shape[1] if block else 0)
    gen = torch.Generator().manual_seed(block)
    # The previous block's output, normalised: either sign.
    x = feats[0] if block == 0 else torch.randn(
        windows, c1, *skip.shape[2:], generator=gen).to(cuda_device)
    launches = blob_up.launches
    with torch.no_grad():
        ref = blob_up_plain(x, skip, convt, bn, head, target)
        for _ in range(3):
            got = blob_up(x, skip, convt, bn, head, target)
            torch.cuda.synchronize()
            assert got.shape == ref.shape and got.is_contiguous()
            err = float((got - ref).abs().max())
            assert err <= KERNEL_REL_TOL * float(ref.abs().max()), err
    assert blob_up.launches == launches + 3


@pytest.mark.cuda
@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("grid", WIDE, ids=WIDE_IDS)
def test_cuda_kernel_matches_plain_on_wide_planes_and_signed_skips(cuda_device, grid, block):
    """Column bands (the last blocks' planes take more than a warp's quad
    columns) and relu on the skip's channels too: x and the skip of
    either sign."""
    model = _model(grid).to(cuda_device)
    feats = _feats(model, grid, 3, seed=block, device=cuda_device)
    convt, bn, head, target = _block_args(model, feats, *grid, block)
    gen = torch.Generator().manual_seed(20 + block)
    skip = None
    if block:
        skip = torch.randn(3, 4, *feats[block].shape[1:], generator=gen).to(cuda_device)[:, 0]
    c1 = convt.in_channels - (skip.shape[1] if block else 0)
    x = torch.randn(3, c1, *feats[block].shape[2:], generator=gen).to(cuda_device)
    with torch.no_grad():
        ref = blob_up_plain(x, skip, convt, bn, head, target)
        got = blob_up(x, skip, convt, bn, head, target)
    assert got.shape == ref.shape
    err = float((got - ref).abs().max())
    assert err <= KERNEL_REL_TOL * float(ref.abs().max()), err


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["720p", "1080p"])
def test_cuda_blobnet_on_bench_clip_matches_former(cuda_device, name, monkeypatch):
    model, cfg, x = _first_chunk_windows(name, cuda_device)
    with torch.no_grad():
        launches = blob_up.launches
        got, counts = _counted_forward(model, x)
        assert blob_up.launches == launches + 4
        # The former forward: the model's own, each decoder block the plain version.
        monkeypatch.setattr(tbn, "blob_up", lambda x, skip, convt, bn, head, target:
                            blob_up_plain(x, skip, convt, bn, head, target))
        ref, _ = _counted_forward(model, x)
        assert blob_up.launches == launches + 4
    assert counts["blobnet.up_blocks"] == counts["blobnet.up_fused"] == 4
    thr = cfg.compressed.mask_threshold
    flipped = (got > thr) != (ref > thr)
    near = (ref - thr).abs() <= NEAR_THRESHOLD
    assert not (flipped & ~near).any(), int((flipped & ~near).sum())


@pytest.mark.cuda
def test_cuda_engaged_share_is_one_in_eval_and_zero_in_train(cuda_device):
    from cova_tpu_torch.pipeline.compressed import compressed_masks_step

    model, cfg, _ = _first_chunk_windows("1080p", cuda_device)
    gen = torch.Generator().manual_seed(3)
    chunk = torch.randint(0, 256, (4, 131, 68, 120, 2), dtype=torch.uint8, generator=gen)
    launches = blob_up.launches
    with torch.no_grad():
        _, counts = _counted_forward(
            lambda md: compressed_masks_step(model, cfg, md), chunk.to(cuda_device))
    torch.cuda.synchronize()
    assert counts["blobnet.up_fused"] / counts["blobnet.up_blocks"] == 1.0
    assert blob_up.launches == launches + 4
    model.train()
    x = torch.rand(2, 4, 68, 120, 4, device=cuda_device)
    _, counts = _counted_forward(model, x, generator=torch.Generator(device=cuda_device).manual_seed(0))
    assert counts["blobnet.up_blocks"] == 4 and counts.get("blobnet.up_fused", 0) == 0
    assert blob_up.launches == launches + 4


@pytest.mark.cuda
def test_cuda_eval_forward_asking_for_a_gradient_raises(cuda_device):
    model = tbn.BlobNet(tbn.BlobNetConfig(in_channels=4)).to(cuda_device).eval()
    feats = _feats(model, (23, 40), 1, seed=0, device=cuda_device)
    convt, bn, head, target = _block_args(model, feats, 23, 40, 0)
    launches = blob_up.launches
    with torch.enable_grad(), pytest.raises(ValueError, match="no backward"):
        blob_up(feats[0], None, convt, bn, head, target)
    assert blob_up.launches == launches

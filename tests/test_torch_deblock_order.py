"""The loop filter's row walk (K10, csrc/h264_deblock.cu), replayed on the
CPU with the plain version's helpers (ops/h264/deblock.py).

K10 gives each macroblock row to a block that walks it left to right on
its own copy of the samples. Macroblock x of row y takes its own samples
from the picture one step early and keeps the left neighbour's from the
step before. It filters its vertical edges (V), writes back the left
neighbour's last four luma columns (two chroma), which completes that
neighbour, and publishes x + 1. Before its horizontal edges (H), where
its top edge is filtered, it reads the top strip (luma rows 12-15,
chroma rows 6-7 of (x, y - 1)) once row y - 1 has published x + 2, one
step early where it already has; with no filtered top edge it does not
wait for the row above at all. After H it writes back its own first
twelve luma columns (six chroma), all sixteen (eight) at the last
column, and the top strip's rows 13-15 (chroma row 7). Each write-back is
skipped where no filtered edge changed its samples, and the row ends by
publishing mb_w + 1. The replay below does
the same per row on a private copy, one phase of a step at a time, in
interleavings drawn from a seed; every picture of the committed deblock,
slices and nodeblock streams must come out bit for bit as the plain
version's waves x + 2y make it.

Marked cuda (skipped here): K10 itself against the plain version on the
first pictures of the benchmark's 720p and 1080p (1088 rows) renders,
whose many rows exercise the handoff between rows.
"""

import dataclasses
import pathlib
import random

import pytest
import torch

from cova_tpu_torch.codec import Mp4Demuxer, pixrec
from cova_tpu_torch.ops.h264 import deblock, inter, intra
from cova_tpu_torch.ops.h264 import transform as tf
from cova_tpu_torch.ops.h264.picture import S_ALPHA, S_BETA

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
STREAMS = REPO / "cova_tpu_torch" / "data" / "h264"
RENDERS = REPO / "bench_port" / "data"
SEED = 20261018


def filter_mb(flat, pic, bs, m, d):
    """Macroblock m's edges in direction d (0 vertical, 1 horizontal) on
    the plane `flat` (one slot, from offset 0), as one macroblock of
    deblock.deblock's waves."""
    W, H, mw = pic.width, pic.height, pic.mb_w
    b = bs[m:m + 1]
    if not bool((b[:, d] > 0).any()):
        return
    mbs = torch.tensor([m])
    X, Y = (mbs % mw) * 16, (mbs // mw) * 16
    sl = pic.mb[m, 1].long()
    aoff, boff = pic.slices[sl, S_ALPHA], pic.slices[sl, S_BETA]
    qp, qpc = pic.mb[:, 2], pic.mb[:, 3:5]
    pn = mbs - 1 if d == 0 else mbs - mw
    for e in range(4):
        bse = b[:, d, e].repeat_interleave(4, 1)
        if not bool((bse > 0).any()):
            continue
        pq = pn.clamp(min=0) if e == 0 else mbs
        qpav = (qp[pq] + qp[mbs] + 1) >> 1
        ia = (qpav + aoff).clamp(0, 51).long()[:, None].expand(-1, 16)
        ib = (qpav + boff).clamp(0, 51).long()[:, None].expand(-1, 16)
        x0 = X + 4 * e if d == 0 else X
        y0 = Y if d == 0 else Y + 4 * e
        li = deblock._edge_lines(0, W, x0, y0, d, 16, 4)
        flat[li.reshape(-1)] = deblock._filter_luma(
            flat[li].to(torch.int32), bse, ia, ib).to(torch.uint8).reshape(-1)
    cbase = W * H + torch.arange(2) * ((W // 2) * (H // 2))
    for ce in range(2):
        e = 2 * ce
        bse = b[:, d, e].repeat_interleave(2, 1)
        if not bool((bse > 0).any()):
            continue
        pq = pn.clamp(min=0) if e == 0 else mbs
        qpav = (qpc[pq] + qpc[mbs] + 1) >> 1
        ia = (qpav + aoff).clamp(0, 51).long()[:, :, None].expand(-1, -1, 8)
        ib = (qpav + boff).clamp(0, 51).long()[:, :, None].expand(-1, -1, 8)
        x0 = X // 2 + 4 * ce if d == 0 else X // 2
        y0 = Y // 2 if d == 0 else Y // 2 + 4 * ce
        li = deblock._edge_lines(0, W // 2, x0, y0, d, 8, 2)[:, None] \
            + cbase[None, :, None, None]
        new = deblock._filter_chroma(flat[li].to(torch.int32),
                                     bse[:, None].expand(-1, 2, -1), ia, ib)
        flat[li.reshape(-1)] = new.to(torch.uint8).reshape(-1)


class Plane:
    """Index sets of one picture's samples in a slot: rectangles of luma
    rows and columns, with the same rectangle halved in both chroma
    planes."""

    def __init__(self, pic):
        self.W, self.H = pic.width, pic.height

    def rect(self, r0, r1, c0, c1):
        """Flat indices of luma rows [r0, r1) x columns [c0, c1) and of
        chroma rows [r0/2, r1/2) x columns [c0/2, c1/2) in Cb and Cr."""
        W, H = self.W, self.H
        r, c = torch.arange(r0, r1), torch.arange(c0, c1)
        out = [(r[:, None] * W + c[None, :]).flatten()]
        cr, cc = torch.arange(r0 // 2, r1 // 2), torch.arange(c0 // 2, c1 // 2)
        for k in range(2):
            base = W * H + k * (W // 2) * (H // 2)
            out.append((base + cr[:, None] * (W // 2) + cc[None, :]).flatten())
        return torch.cat(out)


def walk_row(y, pic, bs, plane, glob, progress, garbage):
    """Row y as K10's block walks it: a generator that yields between the
    phases of each step (the scheduler may run other rows there) and,
    before a top strip it reads, the count that row y - 1 must have
    published."""
    mw = pic.mb_w
    m0 = y * mw
    work = garbage.clone()  # nothing the row did not fetch is sound
    v = (bs[m0:m0 + mw, 0] > 0).flatten(1).any(1).tolist()
    h = (bs[m0:m0 + mw, 1] > 0).flatten(1).any(1).tolist()
    top = (bs[m0:m0 + mw, 1, 0] > 0).any(1).tolist()

    def tile(x):
        return plane.rect(16 * y, 16 * y + 16, 16 * x, 16 * x + 16)

    def strip(x):
        return plane.rect(16 * y - 4, 16 * y, 16 * x, 16 * x + 16)

    def write_back(idx):
        glob[idx] = work[idx]

    t = tile(0)
    work[t] = glob[t]
    have = dirty = False
    for x in range(mw):
        last = x + 1 == mw
        # The next macroblock's samples, read now and put in place after
        # the step.
        staged = []
        if not last:
            t = tile(x + 1)
            staged.append((t, glob[t].clone()))
        yield 0
        filter_mb(work, pic, bs, m0 + x, 0)
        if x and (dirty or v[x]):
            write_back(plane.rect(16 * y, 16 * y + 16, 16 * x - 4, 16 * x))
        progress[y] = x + 1
        if top[x] and not have:
            yield x + 2
            assert progress[y - 1] >= x + 2
            s = strip(x)
            work[s] = glob[s]
        have = False
        if not last and top[x + 1] and progress[y - 1] >= x + 3:
            s = strip(x + 1)
            staged.append((s, glob[s].clone()))
            have = True
        yield 0
        filter_mb(work, pic, bs, m0 + x, 1)
        dirty = v[x] or h[x]
        if dirty:
            write_back(plane.rect(16 * y, 16 * y + 16, 16 * x, 16 * x + (16 if last else 12)))
        if top[x]:
            # Luma rows 13-15 and chroma row 7 of (x, y - 1): the strip's
            # last two luma rows with the chroma row they halve to, and
            # luma row 13.
            write_back(plane.rect(16 * y - 2, 16 * y, 16 * x, 16 * x + 16))
            r = torch.arange(16 * y - 3, 16 * y - 2)[:, None] * plane.W \
                + torch.arange(16 * x, 16 * x + 16)[None, :]
            write_back(r.flatten())
        for idx, val in staged:
            work[idx] = val
    progress[y] = mw + 1


def replay(glob, pic, rng):
    """Filter the plane `glob` in place by K10's walk, rows interleaved by
    `rng` at every phase of every step."""
    bs = deblock.boundary_strength(pic)
    plane = Plane(pic)
    progress = [0] * pic.mb_h
    garbage = torch.randint(0, 256, glob.shape, dtype=torch.uint8,
                            generator=torch.Generator().manual_seed(rng.randrange(1 << 30)))
    rows = {y: walk_row(y, pic, bs, plane, glob, progress, garbage) for y in range(pic.mb_h)}
    waits = {y: next(rows[y]) for y in rows}
    while rows:
        ready = [y for y in rows if waits[y] == 0 or progress[y - 1] >= waits[y]]
        assert ready, "the walk deadlocked"
        y = rng.choice(ready)
        try:
            waits[y] = next(rows[y])
        except StopIteration:
            del rows[y], waits[y]
    assert progress == [pic.mb_w + 1] * pic.mb_h


@pytest.mark.parametrize("stream", ["deblock", "slices", "nodeblock"])
def test_row_walk_equals_the_waves(stream):
    """Every picture of the stream: K10's row walk equals the waves."""
    rng = random.Random(f"{SEED}-{stream}")
    seen = []

    def rec(pool, slot, pic):
        res = tf.residual(pic.coef, pic.mb, pic.ls4, pic.ls8)
        inter.reconstruct_inter(pool, slot, pic, res)
        intra.reconstruct_intra(pool, slot, pic, res)
        walked = pool[slot].clone()
        deblock.deblock(pool, slot, pic)
        replay(walked, pic, rng)
        seen.append(torch.equal(walked, pool[slot]))

    d = Mp4Demuxer(str(STREAMS / f"{stream}.mp4"))
    dec = pixrec.PixelDecoder(d.extradata(), device="cpu")
    orig = pixrec.reconstruct
    pixrec.reconstruct = rec
    try:
        for i in range(d.num_samples):
            dec.send(d.read_sample(i), d.sample(i).pts)
    finally:
        pixrec.reconstruct = orig
        dec.close()
    assert seen and all(seen), seen


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("render", ["synth_1800.mp4", "synth_1800_1080p.mp4"])
def test_cuda_deblock_on_the_renders(cuda_device, render):
    """K10 on the render's I picture and the P/B pictures after it, each
    from the same state as the plain version (on the CPU), three launches,
    bit-equal."""
    from cova_tpu_torch.ops.cuda import h264_kernels as K

    pictures = 6
    checked = []

    def check(pool, slot, pic):
        K.h264_inter(pool, slot, pic)
        K.h264_intra(pool, slot, pic)
        cpu = dataclasses.replace(pic, **{
            f.name: getattr(pic, f.name).cpu() for f in dataclasses.fields(pic)
            if isinstance(getattr(pic, f.name), torch.Tensor)})
        start = pool[slot].clone()
        ref = pool.cpu()
        deblock.deblock(ref, slot, cpu)
        for _ in range(3):
            pool[slot].copy_(start)
            K.h264_deblock(pool, slot, pic)
            assert torch.equal(pool[slot].cpu(), ref[slot]), pic.poc
        checked.append(bool((pic.mb[:, 0] & tf.F_INTRA).all()))

    d = Mp4Demuxer(str(RENDERS / render))
    dec = pixrec.PixelDecoder(d.extradata(), device=cuda_device)
    orig = pixrec.reconstruct
    pixrec.reconstruct = check
    try:
        for i in range(d.num_samples):
            if len(checked) == pictures:
                break
            dec.send(d.read_sample(i), d.sample(i).pts)
    finally:
        pixrec.reconstruct = orig
        dec.close()
    assert len(checked) == pictures and checked[0] and not all(checked), checked

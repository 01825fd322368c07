#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (cova_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py [--kernels-only | --k7-split | --pixdec-only | --only NAME]

Phases (--kernels-only stops after phase 2; --k7-split runs phases 0-1
and then only K7's four timed inputs, for timing two checkouts in turns
in one call; --pixdec-only runs phases 0-1 and 15a-c; --only NAME runs
phases 0-1 and the part of phase 2 of one kernel, by its KERNELS name,
e.g. ms_deform_attn or blob_up); the seconds each took are printed as it
ends:
  0  the card, the software versions, and the NVDEC probe (recorded, not
     built: is libnvcuvid visible to ldconfig or in the driver's library
     directories, does the toolkit ship nvcuvid.h);
  1  builds every CUDA kernel of the port from the sources in the
     checkout (the CC, NMS, MOG2, SORT, the three H.264 reconstruction
     kernels, K4, K11 and K12, one nvcc each, all at once), and the
     port's codec library (with its syntax decoder, csrc/rec); prints
     what ptxas says of each kernel (registers, spills) and, from
     `cuobjdump -sass`, the MOG2 and SORT kernels' instruction counts
     and atomics (the listing goes beside the built library);
  2  holds each kernel against its plain PyTorch version on the card,
     every case three times: CC labels, the four NMS outputs, the MOG2
     foreground and state, and the SORT scan's (K7) state and outputs
     equal bit for bit, K7's auction rounds and searches equal to the
     plain version's counts (six cases: the production chunk's first 16
     windows, its next 16 on the carried state, nwin tails with gamma 2,
     a full table of 64 slots, an auction stopped at max_iters,
     graft_entry's MD=8; then K7 alone on the whole chunk, three runs
     equal, their first 16 windows equal to the plain version's); K4
     (the BlobNet encoder stage's tail) on the four stages of the 68x120
     and 45x80 grids at B*T = 2048, within 1e-6 of the largest output of
     its plain version (cuDNN's BatchNorm and cuBLAS's K = 4 products
     round in other orders); K12 (a BlobNet decoder block) on the four
     blocks of both grids at 512 windows, within 1e-6 of the largest
     output of its plain version, timed also against the cuDNN sequence
     it replaces, with its share of the FLOP bound; K11 (RT-DETR's
     deformable attention core) on the six decoder layers' inputs of one
     frame of the port's RT-DETR-R50 on its seeded initialisation and on
     seeded inputs at the published shapes, within 1e-6 of the largest
     output of its plain version; the
     MOG2 kernel's short division against `__fdiv_rn` over 7 * 2^26
     seeded pairs and the edges; times each kernel at the main path's
     shapes as device time per launch (a CUDA graph of 100 launches, for
     K7 of 2 to 100 by its time, no host time between them), as the
     wrapper's time per call (host time included), against its plain
     version (K7's on the chunk's first 16 windows), its bound and the
     launch floor (a one-element torch op timed as the kernels are); K7
     alone on four inputs (the production chunk, seeded random boxes, an
     empty chunk whose auction runs no round, the synth render's first
     chunk): its auction rounds a lane and window, a window's cost at 0
     rounds, and a round of a lane;
  3  the all-device compressed stage on a seeded chunk (R=8, F=128, T=4):
     the whole stage on two chunks and its parts, a small chunk against
     the CPU (the SORT bit for bit);
  4  `CovaPipeline` (host_tracking=False) end to end on a generated
     1280x736 PAFF clip, counting the kernel launches that run made (K7
     once a chunk), its four CSVs byte-identical to the port's run on the
     CPU;
  5  the host-tracking masks step (`run_chunk_masks`) timed at R=8,
     F=128 on 45x80 and 68x120, and a sub-chunk against the CPU; the
     split of a 68x120 chunk (R=4): preprocessing, the encoder's
     convolutions, K4, K12 (the decoder), the threshold and pack;
  6  the default `CovaPipeline` (host_tracking=True) on the same clip,
     its CSVs byte-identical to the port's run on the CPU;
  7  the pixel-domain oracle: full-width YOLOv4-608 (80 classes) on
     seeded darknet-format weights, through `make_yolo_detector` on
     1280x720 I420 frames built from artifacts/synth_bg.npy, counting
     the NMS kernel's launches; per-frame preprocess, network and
     decode+NMS times at the reference thresholds and with every
     candidate reaching NMS; one frame against the same detector on the
     CPU, and the cfg-built network against the hand-written one (phase
     15d drives it through the pipeline);
  8  BlobNet training at full width: MOG2 labels through `generate_labels`
     on the card (512 frames at 368x640, counting K6's launches) equal to
     the plain version's, their time a frame split into upload, K6,
     morphology, the copy to the host and the host's hole filling; the
     PAFF clip's metadata windows paired with them; `train_blobnet` for
     two epochs from the demo artifact's weights; the first steps again
     on the CPU (dropout 0), losses within LOSS_TOL; the trained weights
     saved in the Flax layout, loaded back and run through a masks step;
  9  the synth query answered from the committed render (BlobNet on the
     card, the host replay), held to the float32 reference exactly;
 10  examples/profile_device.py on one chunk of the committed render (R=8,
     F=128, medians of 5 runs a probe, a pipelined run of 2 chunks): the
     all-device split with K1 and K7, the masks/+labels/+stats probes
     again with the plain labelling, every probe's scalar equal to the
     CPU's on the same chunk;
 11  examples/soak.py: the committed render looped 5 times (9,000
     frames; 10 before its pixel stage came to the card), 8 ranges,
     last="full" (the pixel stage on the card, K10 launched); RSS growth
     within its budget, the peak device memory;
 12  multi-device on the one card: the masks step and the all-device
     stage (both F=128) sharded over the mesh [cuda:0, cuda:0], bit for
     bit equal to one device, the stage's time against one device's; the
     data-parallel train step at full width with two gloo ranks sharing
     cuda:0 against the one-device step on the global batch;
     `dryrun_multichip` over the visible cards (NCCL);
 13  cova_tpu_torch.bench, the headline compressed-domain bench, on the
     committed 720p and 1080p renders of the synth scene (R=8, F=128, 5
     passes, 4 rounds a device-only pass): each render's first chunk of
     packed masks equal to the CPU's, its JSON line, platform cuda,
     frames a pass equal to the demuxer's windows, no kernel launched;
 14  reproduce_1080p's pipeline configuration (4 ranges,
     blobnet_demo1080.npz, cc 7, mask 0.6) with last="select" on the whole
     1080p render, its CSVs byte-identical to the port's run on the CPU
     (the CPU's plain pixel decoder would take hours at 1080p, so this
     comparison stops before the pixel stage; 15b-c hold the pixels);
 15  the pixel decoder (codec/pixrec.py, K8 h264_inter, K9 h264_intra, K10
     h264_deblock): (a) every picture of every committed small stream
     (cova_tpu_torch/data/h264) through each kernel three times, each
     bit-equal to its plain version on the CPU from the same state; (b)
     both committed renders decoded on the card, every popped (pts,
     sha256 of Y, U, V) equal to libavcodec's (data/pixdec_hashes.json),
     frames/s and the split a picture (host syntax, upload, K8, K9, K10,
     pop), then each kernel timed on each render's first pictures (the
     launch alone, the wrapper, the plain version, and K9 as one launch a
     wave instead; K10's chain of macroblock steps); (c)
     CovaPipeline(last="full") on the 720p render at reproduce_synth's
     operating point with the background built on the card through
     decode_luma_halfres: background and CSVs equal to the JAX package's
     run with libavcodec
     (data/pixdec_full_csvs.json), K8-K10 launched on this main path; (d)
     the same run with full-width YOLOv4 on seeded weights: K5's launches
     and the run's split (entropy decode, masks, host tracking, pixel
     decode, oracle).
Every phase raises on failure; nothing falls back to the CPU. Without a
CUDA device, or without the repository beside it, it exits non-zero and
prints no result.

Output: one line per measurement, then a JSON line with the kernels'
launches, errors and times, the card's name and power limit from
nvidia-smi, and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
It imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time

REPO = pathlib.Path(__file__).resolve().parent
SEED = 0

# The kernels of the port: (name, route, source, TPU kernel it replaces).
# None has a one-call PyTorch counterpart (no torch op labels connected
# components, none runs class-aware greedy NMS with a score filter and a
# max_out, none runs a Gaussian-mixture background model, none runs
# SORT), so their library_ms is null.
KERNELS = {
    "cc_label": (
        "cuda",
        "cova_tpu_torch/csrc/cc_kernel.cu",
        "cova_tpu/ops/pallas/cc_kernel.py:34",
    ),
    # No Pallas original: the fori_loop sweep XLA ran on the TPU.
    "nms": (
        "cuda",
        "cova_tpu_torch/csrc/nms_kernel.cu",
        "cova_tpu/ops/nms.py:47",
    ),
    # No Pallas original: the lax.scan of the MOG2 step XLA ran on the TPU.
    "mog2": (
        "cuda",
        "cova_tpu_torch/csrc/mog2_kernel.cu",
        "cova_tpu/utils/mog.py:30",
    ),
    # No Pallas original: the lax.scan of sort_step (vmapped over the
    # ranges, the auction's while_loop inside) XLA ran on the TPU.
    "sort_scan": (
        "cuda",
        "cova_tpu_torch/csrc/sort_kernel.cu",
        "cova_tpu/pipeline/compressed.py:96",
    ),
    # No device original: the JAX package's pixels come from libavcodec's
    # software decoder (the role NVDEC plays in the reference); no torch
    # op decodes H.264, so library_ms is null.
    "h264_inter": ("cuda", "cova_tpu_torch/csrc/h264_inter.cu", "cova_tpu/csrc/pixdec.cc"),
    "h264_intra": ("cuda", "cova_tpu_torch/csrc/h264_intra.cu", "cova_tpu/csrc/pixdec.cc"),
    "h264_deblock": ("cuda", "cova_tpu_torch/csrc/h264_deblock.cu", "cova_tpu/csrc/pixdec.cc"),
    # No Pallas original: XLA's fusion of BlobNet's encoder tail (relu,
    # BatchNorm, the pool and pad, PointWiseTemporal); no one torch op
    # computes that tail, so library_ms is null.
    "blob_stage": ("cuda", "cova_tpu_torch/csrc/blob_stage.cu", "cova_tpu/models/blobnet.py:152"),
    # No Pallas original: XLA's ConvTranspose and fusions of a BlobNet
    # decoder block; its one-call library counterpart is the cuDNN
    # sequence BlobNet ran before it (library_ms).
    "blob_up": ("cuda", "cova_tpu_torch/csrc/blob_up.cu", "cova_tpu/models/blobnet.py:168"),
    # No TPU original: the JAX package has no transformer detector; K11 is
    # the deformable attention core of the port's RT-DETR oracle, which no
    # one torch op computes, so library_ms is null.
    "ms_deform_attn": ("cuda", "cova_tpu_torch/csrc/msda_kernel.cu", None),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = 5) -> float:
    """Median milliseconds of `fn()` over `reps` runs after one warm-up,
    each timed with CUDA events around the call."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def phase0_environment() -> str:
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[0] card: {smi}")
    log(
        f"[0] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}"
    )
    log(
        "[0] codec: the port builds libcovacodec from cova_tpu/csrc with "
        "pixdec.cc replaced by cova_tpu_torch/csrc/pixdec_stub.cc (no "
        "libavcodec) and its own syntax decoder (cova_tpu_torch/csrc/rec); "
        "pixels are rebuilt on the card by K8-K10 (codec/pixrec.py)"
    )
    # NVDEC, recorded and not built: is the driver's video library
    # visible, and does the toolkit ship the Video Codec SDK's headers?
    lib = subprocess.run(["bash", "-c", "ldconfig -p | grep libnvcuvid || true"],
                         capture_output=True, text=True).stdout.strip()
    dirs = [pathlib.Path(p) for p in ("/usr/lib/x86_64-linux-gnu", "/usr/lib64",
                                     "/usr/local/nvidia/lib64", "/usr/lib/wsl/lib")]
    found = sorted(str(q) for d in dirs if d.is_dir() for q in d.glob("libnvcuvid*"))
    headers = sorted(str(q) for q in pathlib.Path("/usr/local/cuda").glob("**/nvcuvid.h"))
    log(f"[0] NVDEC probe: ldconfig libnvcuvid: {lib or 'none'}; in the driver's library "
        f"directories: {found or 'none'}; nvcuvid.h under /usr/local/cuda: {headers or 'none'}")
    return smi


def phase1_build() -> None:
    """One nvcc per kernel source and the codec's g++ build, all started
    together."""
    from concurrent.futures import ThreadPoolExecutor

    from cova_tpu_torch import codec
    from cova_tpu_torch.ops.cuda import _build

    def timed(label, fn):
        t0 = time.perf_counter()
        fn()
        return label, time.perf_counter() - t0

    from cova_tpu_torch.ops.cuda import h264_kernels

    h264_deps = h264_kernels.deps()
    jobs = [(source, lambda u=pathlib.Path(source).stem: _build.build(
                u, verbose=True, deps=h264_deps if u.startswith("h264") else ()))
            for _, source, _ in KERNELS.values()]
    jobs.append(("libcovacodec", codec.lib))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(jobs)) as pool:
        done = [f.result() for f in [pool.submit(timed, *job) for job in jobs]]
    for label, dt in done:
        log(f"[1] built {label} in {dt:.3f} s")
    log(f"[1] all builds in {time.perf_counter() - t0:.3f} s")
    _sass_counts(_build.build("mog2_kernel"))
    _sass_counts(_build.build("sort_kernel"))


def _sass_counts(lib: pathlib.Path) -> None:
    """Instruction counts of each kernel in `lib` from `cuobjdump -sass`:
    the whole kernel, and the address range of its widest loop (from the
    target of a backward branch to the branch; for the MOG2 kernel the
    loop over frames, rare branches placed inside it included), with the
    reciprocals, range checks, calls and branches in it; and the kernel's
    atomic instructions. The listing is written beside the library, as
    <lib>.sass."""
    import re

    from cova_tpu_torch.ops.cuda import _build

    tool = pathlib.Path(_build.nvcc()).with_name("cuobjdump")
    res = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"cuobjdump failed on {lib.name}: {res.stderr.strip()[:400]}")
    lib.with_suffix(".sass").write_text(res.stdout)
    line = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\d\s+)?([A-Z][A-Z0-9_.]*)(.*?);")
    for block in res.stdout.split("Function : ")[1:]:
        name = block.split()[0]
        ins = [(int(a, 16), op, rest) for a, op, rest in line.findall(block)]
        ins = [i for i in ins if i[1] != "NOP"]
        loops = []
        for addr, op, rest in ins:
            target = re.search(r"0x([0-9a-f]+)", rest) if op.startswith("BRA") else None
            if target and int(target.group(1), 16) <= addr:
                loops.append((int(target.group(1), 16), addr))
        text = f"[1] sass {name[:60]}: {len(ins)} instructions"
        if loops:
            lo, hi = max(loops, key=lambda r: r[1] - r[0])
            body = [op for addr, op, _ in ins if lo <= addr <= hi]
            kinds = {k: sum(op.startswith(k) for op in body)
                     for k in ("MUFU", "FCHK", "CALL", "BRA", "FFMA", "FSEL", "FSETP")}
            text += f", {len(body)} in its widest loop ({kinds})"
        atomics = sorted({op for _, op, _ in ins if op.startswith("ATOM")})
        if atomics:
            text += f"; atomics {atomics}"
        log(text)


# The card's published peaks (NVIDIA H100 SXM data sheet, at 700 W), for
# each kernel's bound: the larger of its bytes (each input read once,
# each output written once) over the memory rate and its operations over
# the CUDA cores' float32 rate: 67e12 counts a fused multiply-add as two
# operations; a kernel whose arithmetic must round every operation (no
# contraction) has half of it.
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12
OPS_PER_S_NO_FMA = 33.5e12
# Operations of one IoU test in csrc/nms_kernel.cu (`iou`): 4 adds, 2
# mins, 4 maxes, 3 subtractions, 3 multiplies, 1 divide, the compare.
IOU_OPS = 18
# 32-bit operations a pixel of the union-find, at most: the mask test,
# up to four neighbour tests, a union's compares and a find's steps.
CC_OPS_PER_PIXEL = 10
# Operations a pixel and frame of csrc/mog2_kernel.cu whose result the
# common pixel (matched, a heavy owner) reads, a division as one: matching
# 16, the keys and their compares 8, the weights 12, rho 2, the owner's
# update 5, clipping 2, the sum 3, the quotients 4, the verdict 2, the
# load and store 2. Every one rounds on its own (the kernel forbids
# contraction), so they run at OPS_PER_S_NO_FMA.
MOG2_OPS_PER_PIXEL_FRAME = 56
# Operations of csrc/sort_kernel.cu whose result the data needs, each
# rounding on its own (OPS_PER_S_NO_FMA): an existing slot's predict and
# box 64, a pair of an existing slot and a valid box 26 (IoU 24, the cost
# and its sign), an unassigned row's search in an auction round 3 a box
# and 4, a match's Kalman update 2296 (the inverse 150, K 196, the mean
# 56, I - KH 28, the two 7-term products 1274, (KR)Kᵀ 539, the sum 49).
SORT_PREDICT_OPS = 64
SORT_PAIR_OPS = 26
SORT_ROW_OPS_PER_BOX = 3
SORT_ROW_OPS = 4
SORT_UPDATE_OPS = 2296
# K7 takes a tenth of a second or more a launch on the production chunk,
# whose auction runs to max_iters in most windows: a graph of at least 2
# launches times it, and of as many as fill about SORT_GRAPH_MS (at most
# GRAPH_LAUNCHES) on a shorter input. The plain version (host-bound:
# about 1.3 s a window there) is held to it and timed on SORT_CHECK_F
# windows a case.
SORT_GRAPH_LAUNCHES = 2
SORT_GRAPH_MS = 500.0
SORT_CHECK_F = 16
# Launches in one timed CUDA graph, and times each check is repeated (a
# race in the kernel's atomics shows as a difference between repeats).
GRAPH_LAUNCHES = 100
REPEATS = 3
# K4 at the benchmark's chunk (R=4 ranges x F=128 windows, B*T = 2048) on
# both grids, with the weights each grid's pipeline loads; held to its
# plain version within K4_REL_TOL of the stage's largest output (BatchNorm
# and the K = 4 mixes round in other orders in cuDNN and cuBLAS).
K4_WINDOWS = 4 * 128
K4_GRIDS = (("blobnet_demo1080.npz", (68, 120)), ("blobnet_demo.npz", (45, 80)))
K4_REL_TOL = 1e-6
# Operations of csrc/blob_stage.cu a pooled cell and timestep: relu,
# subtraction and fused multiply-add (2) on each of the 4 taps, 3 maxes,
# each of the two mixes' product and three fused multiply-adds (7) and
# relu, the residual add and the last relu.
K4_OPS_PER_CELL = 4 * 4 + 3 + 2 * 8 + 2
# K12 on the decoder blocks of both grids at the benchmark's chunk, with
# the weights each grid's pipeline loads, held to its plain version within
# K12_REL_TOL of the block's largest output (the transposed convolution
# sums its 4 * Cin products in another order than cuDNN's).
K12_WINDOWS = 4 * 128
K12_GRIDS = (("blobnet_demo1080.npz", (68, 120)), ("blobnet_synth.npz", (45, 80)))
K12_REL_TOL = 1e-6
# K11 against its plain version: the softmax and the sum over the 12
# samples round in other orders; the sampling coordinates are the same.
K11_REL_TOL = 1e-6
# K11's seeded inputs besides the model's: samples near their boxes,
# around them and mostly outside the maps (the offsets' scale).
K11_SPREADS = (1.0, 4.0, 16.0)


def graph_ms(fn, launches: int = GRAPH_LAUNCHES, replays: int = 5) -> float:
    """Device milliseconds per launch of `fn`: `launches` calls captured
    in one CUDA graph, so no host time lies between the launches, the
    graph replayed `replays` times, each replay timed with CUDA events;
    the median replay over `launches`."""
    import torch

    fn()  # builds, loads and sets kernel attributes outside the capture
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / launches)
    return statistics.median(times)


def launch_floor_ms() -> float:
    """Device milliseconds per launch of a one-element torch op, timed as
    the kernels are (graph_ms): what any launch costs on this card."""
    import torch

    x = torch.zeros(1, device="cuda")
    ms = graph_ms(lambda: x.add_(1.0))
    log(f"[2] launch floor: a one-element torch op, {ms:.5f} ms a launch "
        f"(graph of {GRAPH_LAUNCHES})")
    return ms


def bound_ms(nbytes: int, ops: int, ops_per_s: float = OPS_PER_S) -> tuple:
    """(least milliseconds, "bytes" or "operations") for work that moves
    `nbytes` and does `ops` operations at `ops_per_s` on this card."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _timing(fn, plain, nbytes, ops, floor, ops_per_s: float = OPS_PER_S) -> tuple:
    """Times of one kernel case: device ms a launch (graph), the
    wrapper's ms a call (one call between two events, host time
    included), the plain version's ms, and the bound. Returns (record
    fields, log text)."""
    dev = graph_ms(fn)
    call = cuda_ms(fn)
    plain_ms = cuda_ms(plain)
    bound, by = bound_ms(nbytes, ops, ops_per_s)
    rec = {"device_ms": dev, "ms": call, "plain_ms": plain_ms, "bound_ms": bound,
           "bound_by": by, "launch_floor_ms": floor}
    text = (f"device {dev:.5f} ms a launch (graph of {GRAPH_LAUNCHES}; launch floor "
            f"{floor:.5f}), wrapper call {call:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {bound:.6f} ms by {by} ({nbytes} bytes, {ops} operations), "
            f"{bound / dev:.2%} of it")
    return rec, text


def _spiral(h: int = 45, w: int = 80):
    import numpy as np

    mask = np.zeros((h, w), bool)
    mask[0, :] = True
    mask[:, w - 1] = True
    mask[h - 1, 2:] = True
    mask[4:h, 2] = True
    mask[4, 2 : w - 10] = True
    return mask


def _checkerboard(h: int = 45, w: int = 80):
    """One component joined only through diagonals."""
    import numpy as np

    r, c = np.indices((h, w))
    return (r + c) % 2 == 0


def _comb(h: int = 45, w: int = 80):
    """Teeth on every other column, joined only by the bottom row: the
    comb's label, pixel 0, reaches most teeth through the far end."""
    import numpy as np

    mask = np.zeros((h, w), bool)
    mask[:, ::2] = True
    mask[h - 1, :] = True
    return mask


def _cc_cases() -> list:
    """(label, masks, timed): the device-tracking path's chunk (B = R*F =
    1024 frames) at three foreground shares and three grids, timed; then
    the union-find's edge cases."""
    import numpy as np

    rng = np.random.default_rng(SEED)
    cases = [(f"B=1024 45x80 p={p}", rng.uniform(size=(1024, 45, 80)) < p, True)
             for p in (0.05, 0.3, 0.6)]
    cases.append(("B=1024 46x80 p=0.05", rng.uniform(size=(1024, 46, 80)) < 0.05, True))
    cases.append(("B=1024 68x120 p=0.3", rng.uniform(size=(1024, 68, 120)) < 0.3, True))
    for label, m in (("spiral 45x80", _spiral()), ("checkerboard 45x80", _checkerboard()),
                     ("comb 45x80", _comb()), ("empty 45x80", np.zeros((45, 80), bool)),
                     ("full 45x80", np.ones((45, 80), bool)),
                     ("full 68x120", np.ones((68, 120), bool))):
        cases.append((label, m[None], False))
    cases.append(("B=64 1x80 p=0.6", rng.uniform(size=(64, 1, 80)) < 0.6, False))
    cases.append(("B=64 45x1 p=0.6", rng.uniform(size=(64, 45, 1)) < 0.6, False))
    return cases


def phase2_cc(floor: float) -> dict:
    """Every CC kernel case against the plain version, labels exactly
    equal, REPEATS times; device times at the path's shapes. Returns the
    JSON record of the kernel (without launches)."""
    import torch

    from cova_tpu_torch.ops.cuda.cc_kernel import (
        connected_components,
        connected_components_plain,
    )

    timed = {}
    max_err = 0
    for label, m, time_it in _cc_cases():
        masks = torch.from_numpy(m).cuda()
        ref = connected_components_plain(masks)
        for _ in range(REPEATS):
            got = connected_components(masks)
            torch.cuda.synchronize()
            if got.dtype != torch.int32 or got.shape != masks.shape:
                raise AssertionError(f"{label}: bad output {got.dtype} {tuple(got.shape)}")
            err = int((got.long() - ref.long()).abs().max()) if got.numel() else 0
            max_err = max(max_err, err)
            if not torch.equal(got, ref):
                raise AssertionError(f"{label}: kernel labels differ from plain (max {err})")
        line = f"[2] cc_label {label}: labels equal to plain, {REPEATS} times"
        if time_it:
            timed[label], text = _timing(
                lambda: connected_components(masks),
                lambda: connected_components_plain(masks),
                masks.numel() * (1 + 4), masks.numel() * CC_OPS_PER_PIXEL, floor,
            )
            line += "; " + text
        log(line)
    route, source, replaces = KERNELS["cc_label"]
    return {"name": "cc_label", "route": route, "source": source, "replaces": replaces,
            "max_abs_err": max_err, "library_ms": None,
            **timed["B=1024 45x80 p=0.05"]}


def phase2_blob_stage(floor: float) -> dict:
    """K4 against its plain version on the card at the main path's
    shapes: every encoder stage of the 68x120 and 45x80 grids at
    K4_WINDOWS windows, the convolution's output seeded in the layout
    cuDNN gives it (channels-last for stage 1, NCHW after), the stage's
    BatchNorm and mixes from the grid's weights; within K4_REL_TOL of the
    largest output, REPEATS times. Device ms a launch (graph), the
    wrapper's call, the plain version, the bound by bytes (the part of
    the convolution's output the pool reads, once, and the stage's output
    written once).
    Returns the JSON record of stage 1 at 68x120 (without launches)."""
    import torch

    from cova_tpu_torch.models.blobnet import load_artifact
    from cova_tpu_torch.ops.cuda.blob_stage import blob_stage, blob_stage_plain
    from cova_tpu_torch.pipeline.compressed import exact_float32

    exact_float32("cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    b = K4_WINDOWS
    timed, max_err = {}, 0.0
    for weights, (h, w) in K4_GRIDS:
        model = load_artifact(REPO / "artifacts" / weights, "cuda")[0]
        for i, (conv, bn, pwt) in enumerate(zip(model.enc_conv, model.enc_bn, model.enc_pwt)):
            c = conv.out_channels
            y = torch.randn(b * 4, c, h, w, device="cuda", generator=gen)
            layout = "channels-last" if i == 0 else "NCHW"
            if i == 0:
                y = y.contiguous(memory_format=torch.channels_last)
            label = f"stage {i + 1} {h}x{w} C={c} B*T={b * 4} {layout}"
            with torch.no_grad():
                ref = blob_stage_plain(y, bn, pwt, b)
                scale = float(ref.abs().max())
                for _ in range(REPEATS):
                    got = blob_stage(y, bn, pwt, b)
                    torch.cuda.synchronize()
                    err = float((got - ref).abs().max())
                    if got.shape != ref.shape or not got.is_contiguous() or \
                            err > K4_REL_TOL * scale:
                        raise AssertionError(f"{label}: K4 {tuple(got.shape)} off the plain "
                                             f"version by {err} (largest output {scale})")
                    max_err = max(max_err, err)
                # The pool reads 2 * (H // 2) rows by 2 * (W // 2) columns a plane.
                read = b * 4 * c * 2 * (h // 2) * 2 * (w // 2)
                nbytes = 4 * (read + ref.numel() + 4 * c + sum(m.numel() for m in pwt.mix))
                timed[label], text = _timing(
                    lambda: blob_stage(y, bn, pwt, b), lambda: blob_stage_plain(y, bn, pwt, b),
                    nbytes, ref.numel() * K4_OPS_PER_CELL, floor)
            log(f"[2] blob_stage {label}: within {err / scale:.3g} of the largest output "
                f"({scale:.4g}) of plain, {REPEATS} times; {text}")
            h, w = ref.shape[-2:]
            del y, ref, got
    route, source, replaces = KERNELS["blob_stage"]
    return {"name": "blob_stage", "route": route, "source": source, "replaces": replaces,
            "max_abs_err": max_err, "library_ms": None,
            **timed[f"stage 1 68x120 C=16 B*T={b * 4} channels-last"]}


def phase2_blob_up(floor: float) -> dict:
    """K12 against its plain version on the card at the main path's
    shapes: every decoder block of the 68x120 and 45x80 grids at
    K12_WINDOWS windows, with the grid's weights; x the previous block's
    output (seeded, either sign), the skip the t = 0 slice of a seeded
    (windows, 4, C, h, w) stage output, read in place; within K12_REL_TOL
    of the largest output, REPEATS times. Device ms a launch (graph), the
    wrapper's call, the plain version, the cuDNN sequence it replaces as
    device ms a launch (`library_ms`: the plain version in a graph), and
    the bound by operations: 2 * 4 * Cin * Cout FLOPs an output kept (the
    crop's), the head's 2 * 16 a pixel on the last block, at OPS_PER_S.
    Returns the JSON record of block 4 at 68x120."""
    import torch

    from cova_tpu_torch.models.blobnet import load_artifact
    from cova_tpu_torch.ops.cuda.blob_up import blob_up, blob_up_plain
    from cova_tpu_torch.pipeline.compressed import exact_float32

    exact_float32("cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    b = K12_WINDOWS
    timed, max_err = {}, 0.0
    for weights, (h, w) in K12_GRIDS:
        model = load_artifact(REPO / "artifacts" / weights, "cuda")[0]
        planes = [(h, w)]
        for _ in model.config.encoder_channels:
            planes.append((planes[-1][0] // 2 + planes[-1][0] % 2,
                           planes[-1][1] // 2 + planes[-1][1] % 2))
        skips = list(reversed(model.config.encoder_channels))
        for i, convt in enumerate(model.dec_convt):
            bn = model.dec_bn[i] if i < len(model.dec_bn) else None
            head = model.head if bn is None else None
            ih, iw = planes[len(planes) - 1 - i]
            target = planes[len(planes) - 2 - i]
            c2 = skips[i] if i else 0
            c1 = convt.in_channels - c2
            if i:
                x = torch.randn(b, c1, ih, iw, device="cuda", generator=gen)
                skip = torch.rand(b, 4, c2, ih, iw, device="cuda", generator=gen)[:, 0]
            else:
                x = torch.rand(b, 4, c1, ih, iw, device="cuda", generator=gen)[:, 0]
                skip = None
            cout = convt.out_channels
            label = (f"block {i + 1} {h}x{w} {c1}+{c2}->{cout} {ih}x{iw}->{target[0]}x{target[1]}"
                     f" B={b}")
            with torch.no_grad():
                ref = blob_up_plain(x, skip, convt, bn, head, target)
                scale = float(ref.abs().max())
                for _ in range(REPEATS):
                    got = blob_up(x, skip, convt, bn, head, target)
                    torch.cuda.synchronize()
                    err = float((got - ref).abs().max())
                    if got.shape != ref.shape or not got.is_contiguous() or \
                            err > K12_REL_TOL * scale:
                        raise AssertionError(f"{label}: K12 {tuple(got.shape)} off the plain "
                                             f"version by {err} (largest output {scale})")
                    max_err = max(max_err, err)
                kept = b * target[0] * target[1]
                flops = 2 * kept * cout * 4 * (c1 + c2) + (2 * kept * cout if head else 0)
                nbytes = 4 * (x.numel() + (skip.numel() if i else 0) + ref.numel()
                              + convt.weight.numel())
                timed[label], text = _timing(
                    lambda: blob_up(x, skip, convt, bn, head, target),
                    lambda: blob_up_plain(x, skip, convt, bn, head, target),
                    nbytes, flops, floor)
                library = graph_ms(lambda: blob_up_plain(x, skip, convt, bn, head, target))
                timed[label]["library_ms"] = library
            rec = timed[label]
            log(f"[2] blob_up {label}: within {err / scale:.3g} of the largest output "
                f"({scale:.4g}) of plain, {REPEATS} times; {text}; the cuDNN sequence "
                f"{library:.5f} ms a launch (graph), K12 {library / rec['device_ms']:.2f}x "
                f"faster; {flops / 1e9:.3f} GFLOP, {rec['bound_ms'] / rec['device_ms']:.2%} of "
                f"the FLOP bound ({rec['bound_ms'] / library:.2%} for cuDNN's)")
            del x, skip, ref, got
    route, source, replaces = KERNELS["blob_up"]
    return {"name": "blob_up", "route": route, "source": source, "replaces": replaces,
            "max_abs_err": max_err,
            **timed[f"block 4 68x120 16+16->16 34x60->68x120 B={b}"]}


def _msda_cases() -> tuple:
    """K11's inputs at RT-DETR-R50's shapes: the six decoder layers' of one
    frame (phase 7's first synth frame through the port's model on its
    PyTorch initialisation, seeded with SEED), then seeded random ones
    (value N(0, 1), boxes of size up to 0.5, offsets at each of
    K11_SPREADS). Returns ([(label, args)], the frame's launches)."""
    import torch

    from cova_tpu_torch.models.rtdetr import make_rtdetr_detector

    torch.manual_seed(SEED)
    detector = make_rtdetr_detector(device="cuda")
    captured = []
    for layer in detector.model.decoder.decoder.layers:
        def grab(*a, _core=layer.cross_attn.ms_deformable_attn_core):
            captured.append(a)
            return _core(*a)

        layer.cross_attn.ms_deformable_attn_core = grab
    from cova_tpu_torch.ops.cuda.msda_kernel import ms_deform_attn

    launches = ms_deform_attn.launches
    detector(_oracle_frames(1, SEED))
    launches = ms_deform_attn.launches - launches
    cases = [(f"RT-DETR layer {i + 1}", a) for i, a in enumerate(captured)]
    g = torch.Generator(device="cuda").manual_seed(SEED)
    shapes = [(80, 80), (40, 40), (20, 20)]
    for spread in K11_SPREADS:
        boxes = torch.rand(1, 300, 4, device="cuda", generator=g)
        boxes[..., 2:] *= 0.5
        cases.append((f"seeded, offsets x{spread:g}", (
            torch.randn(1, 8400, 8, 32, device="cuda", generator=g), shapes, boxes,
            spread * torch.randn(1, 300, 192, device="cuda", generator=g),
            torch.randn(1, 300, 96, device="cuda", generator=g), 3, 4)))
    return cases, launches


def phase2_msda(floor: float) -> dict:
    """K11 against its plain version on the card (_msda_cases), within
    K11_REL_TOL of the plain version's largest output, REPEATS times.
    Device ms a launch (graph), the wrapper's call, the plain version and
    the bound (`msda_work` beside the wrapper: the value rows the samples
    touch, read once, the boxes, offsets and logits read once, the output
    written once; 10 operations a sample and channel).
    Returns the JSON record of the frame's first layer, with the frame's
    launches."""
    import torch

    from cova_tpu_torch.ops.cuda.msda_kernel import ms_deform_attn, msda_work
    from cova_tpu_torch.ops.msda import ms_deform_attn_plain

    cases, launches = _msda_cases()
    timed, max_err = {}, 0.0
    for label, (value, shapes, boxes, offsets, logits, levels, points) in cases:
        args = (value, shapes, boxes, offsets, logits, levels, points)
        with torch.no_grad():
            ref = ms_deform_attn_plain(*args)
            scale = float(ref.abs().max())
            for _ in range(REPEATS):
                got = ms_deform_attn(*args)
                torch.cuda.synchronize()
                err = float((got - ref).abs().max())
                if got.shape != ref.shape or err > K11_REL_TOL * scale:
                    raise AssertionError(f"{label}: K11 {tuple(got.shape)} off the plain "
                                         f"version by {err} (largest output {scale})")
                max_err = max(max_err, err)
            ops, nbytes = msda_work(tuple(value.shape), shapes, boxes, offsets, levels, points)
            timed[label], text = _timing(lambda: ms_deform_attn(*args),
                                         lambda: ms_deform_attn_plain(*args), nbytes, ops, floor)
        log(f"[2] ms_deform_attn {label}: within {err / scale:.3g} of the largest output "
            f"({scale:.4g}) of plain, {REPEATS} times; {text}")
    log(f"[2] ms_deform_attn: {launches} launches for the RT-DETR frame")
    route, source, replaces = KERNELS["ms_deform_attn"]
    return {"name": "ms_deform_attn", "route": route, "source": source, "replaces": replaces,
            "max_abs_err": max_err, "library_ms": None, "launches": launches,
            **timed["RT-DETR layer 1"]}


def _nms_case(seed, n, classes, spread=600.0, ties=False, top=1.0, ordered=False):
    """Seeded NMS candidates (tests/test_torch_nms.py's generator):
    (n, 4) ltwh, (n,) scores, (n,) int32 classes; `ordered` sorts them by
    descending score, stably, as the oracle hands them over."""
    import numpy as np

    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, spread, (n, 2))
    wh = rng.uniform(8, 120, (n, 2))
    ltwh = np.concatenate([xy, wh], 1).astype(np.float32)
    scores = rng.uniform(0, top, n).astype(np.float32)
    if ties:
        scores = (np.round(scores * 8) / 8).astype(np.float32)
    cls = rng.integers(0, classes, n).astype(np.int32)
    if ordered:
        order = np.argsort(-scores, kind="stable")
        ltwh, scores, cls = ltwh[order], scores[order], cls[order]
    return ltwh, scores, cls


NMS_CASES = {
    "N=512 80 classes": dict(seed=0, n=512, classes=80),
    "N=512 2 classes, heavy overlap": dict(seed=1, n=512, classes=2, spread=60.0),
    "N=512 80 classes, exact ties": dict(seed=2, n=512, classes=80, ties=True),
    "N=512 2 classes, ties, overlap": dict(seed=3, n=512, classes=2, spread=120.0,
                                           ties=True),
    "N=512 all below 0.25": dict(seed=4, n=512, classes=80, top=0.25),
    "N=40 3 classes": dict(seed=5, n=40, classes=3),
    # The oracle's input: its top 512, already in stable descending order.
    "N=512 80 classes, sorted": dict(seed=0, n=512, classes=80, ordered=True),
    "N=512 80 classes, ties, sorted": dict(seed=2, n=512, classes=80, ties=True,
                                           ordered=True),
    "N=512 all zero": dict(seed=6, n=512, classes=80, top=0.0),
    "N=1024 2 classes, overlap": dict(seed=7, n=1024, classes=2, spread=120.0),
    "N=33 2 classes, overlap": dict(seed=8, n=33, classes=2, spread=50.0),
    "N=1": dict(seed=9, n=1, classes=1),
}
NMS_MAX_OUT = (1, 8, 64, 512)


def _nms_bytes_ops(args, thr, max_out) -> tuple:
    """Bytes and operations of one NMS call on these inputs: each input
    read once, each output written once; an IoU test for every pair of
    alive candidates of one class."""
    import torch

    ltwh, scores, cls = args
    b, n = scores.shape
    nbytes = b * n * (16 + 4 + 4) + b * max_out * (16 + 4 + 4 + 1)
    pairs = 0
    for i in range(b):
        counts = torch.bincount(cls[i][scores[i] > thr].long())
        pairs += int((counts * (counts - 1) // 2).sum())
    return nbytes, pairs * IOU_OPS


def phase2_nms(floor: float) -> dict:
    """Every NMS case against the plain version on the card, image by
    image and the five unsorted N=512 images as one batch, at score
    thresholds 0.25 and 0.0 and every max_out of NMS_MAX_OUT: the four
    outputs equal bit for bit, REPEATS times. Device times at the
    oracle's shape (one image, N=512, 80 classes, max_out 64), sorted as
    the oracle hands it over and unsorted. Returns the JSON record of the
    kernel (without launches)."""
    import torch

    from cova_tpu_torch.ops.cuda.nms_kernel import nms, nms_plain

    dev = torch.device("cuda")

    def check(label, args, thr, max_out):
        ref = nms_plain(*args, 0.2, thr, max_out)
        err = 0.0
        for _ in range(REPEATS):
            got = nms(*args, 0.2, thr, max_out)
            torch.cuda.synchronize()
            for g, r, name in zip(got, ref, ("ltwh", "scores", "classes", "valid")):
                if g.dtype != r.dtype or g.shape != r.shape:
                    raise AssertionError(f"{label}: {name} {g.dtype} {tuple(g.shape)} "
                                         f"!= {r.dtype} {tuple(r.shape)}")
                err = max(err, float((g.double() - r.double()).abs().max()))
                if not torch.equal(g, r):
                    raise AssertionError(f"{label}: kernel {name} differs from plain")
        return err, int(ref[3].sum())

    max_err = 0.0
    inputs = {label: [torch.from_numpy(a)[None].to(dev) for a in _nms_case(**kw)]
              for label, kw in NMS_CASES.items()}
    for label, args in inputs.items():
        kept = {}
        for thr in (0.25, 0.0):
            for k in NMS_MAX_OUT:
                err, kept[thr, k] = check(f"{label} thr={thr} max_out={k}", args, thr, k)
                max_err = max(max_err, err)
        log(f"[2] nms {label}: outputs equal to plain at max_out {NMS_MAX_OUT}, "
            f"{REPEATS} times; kept {kept[0.25, 512]} at score 0.25, "
            f"{kept[0.0, 512]} at 0.0")
    batch = [label for label in list(NMS_CASES)[:6] if NMS_CASES[label]["n"] == 512]
    stacked = [torch.cat(parts) for parts in zip(*(inputs[k] for k in batch))]
    for thr in (0.25, 0.0):
        for k in NMS_MAX_OUT:
            err, _ = check(f"batch of {len(batch)} thr={thr} max_out={k}", stacked, thr, k)
            max_err = max(max_err, err)
    log(f"[2] nms batch of {len(batch)} images x 512: outputs equal to plain")

    timed = {}
    for label in ("N=512 80 classes, sorted", "N=512 80 classes"):
        args = inputs[label]
        for thr in (0.25, 0.0):
            timed[label, thr], text = _timing(
                lambda: nms(*args, 0.2, thr, 64), lambda: nms_plain(*args, 0.2, thr, 64),
                *_nms_bytes_ops(args, thr, 64), floor,
            )
            log(f"[2] nms B=1 {label} score {thr} max_out 64: {text}")
    route, source, replaces = KERNELS["nms"]
    return {"name": "nms", "route": route, "source": source, "replaces": replaces,
            "max_abs_err": max_err, "library_ms": None,
            **timed["N=512 80 classes, sorted", 0.25]}


def _luma_frames(f: int, h: int, w: int, seed: int):
    """f frames of (h, w) u8 luma: the synth scene's background
    (artifacts/synth_bg.npy, 640x360) padded by reflection to (h, w), seeded
    noise of +-6 a frame, and four bright rectangles of seeded size, start
    and speed moving across it."""
    import numpy as np

    bg = np.load(REPO / "artifacts" / "synth_bg.npy").astype(np.int16)
    pad = ((0, max(h - bg.shape[0], 0)), (0, max(w - bg.shape[1], 0)))
    bg = np.pad(bg, pad, mode="reflect")[:h, :w]
    rng = np.random.default_rng(seed)
    frames = np.repeat(bg[None], f, axis=0) + rng.integers(-6, 7, size=(f, h, w), dtype=np.int16)
    for _ in range(4):
        rh, rw = int(rng.integers(h // 12, h // 4)), int(rng.integers(w // 12, w // 4))
        top, left = int(rng.integers(0, h - rh)), int(rng.integers(0, w))
        speed, value = int(rng.integers(2, 8)), int(rng.integers(200, 256))
        for i in range(f):
            x = (left + i * speed) % max(w - rw, 1)
            frames[i, top : top + rh, x : x + rw] = value
    return np.clip(frames, 0, 255).astype(np.uint8)


MOG2_CHUNK = 256


def _mog2_cases() -> list:
    """(label, frames (F, H, W) u8 on the card, the state to start from,
    timed): 256-frame chunks at 360x640 (720p at half resolution) and
    540x960 (1080p), from a fresh state and from the state an earlier
    chunk of the same sequence left (computed by the plain version); one
    frame; odd sizes; a constant sequence, where all weights tie; and the
    kernel's rarer branches: levels between components 30 apart, so that
    one, two and three of them match; equal weights at the owner and at a
    lower index; a state no chunk left (variances out of range, weights
    of 0 and 1e-30, sums other than 1); lumas of 0, 1 and 2."""
    import numpy as np
    import torch

    from cova_tpu_torch.ops.cuda.mog2_kernel import mog2_chunk_plain, mog2_init

    cases = []
    for h, w in ((360, 640), (540, 960)):
        seq = torch.from_numpy(_luma_frames(2 * MOG2_CHUNK, h, w, SEED)).cuda()
        first, second = seq[:MOG2_CHUNK].contiguous(), seq[MOG2_CHUNK:].contiguous()
        fresh = mog2_init(first[0])
        carried = [t.clone() for t in fresh]
        mog2_chunk_plain(first, *carried)
        cases.append((f"{h}x{w} F={MOG2_CHUNK} fresh", first, fresh, True))
        cases.append((f"{h}x{w} F={MOG2_CHUNK} carried", second, carried, True))
    for label, frames in (
        ("360x640 F=1", _luma_frames(1, 360, 640, SEED + 1)),
        ("odd 45x81 F=33", _luma_frames(33, 45, 81, SEED + 2)),
        ("odd 361x639 F=40", _luma_frames(40, 361, 639, SEED + 3)),
        ("constant 360x640 F=32", np.full((32, 360, 640), 77, np.uint8)),
    ):
        frames = torch.from_numpy(frames).cuda()
        cases.append((label, frames, mog2_init(frames[0]), False))

    rng = np.random.default_rng(SEED + 4)
    h, w, f = 90, 160, 64

    def state(weight, mean, var):
        return [torch.from_numpy(np.broadcast_to(np.asarray(a, np.float32), (h, w, 4)).copy())
                .cuda() for a in (weight, mean, var)]

    levels = np.array([100, 115, 145, 130, 250, 108, 160, 122])
    many = levels[np.arange(f) % len(levels)][:, None, None] + rng.integers(-3, 4, (f, h, w))
    many = torch.from_numpy(many.astype(np.uint8)).cuda()
    cases.append(("many-match 90x160 F=64", many,
                  state([0.4, 0.3, 0.2, 0.1], [100.0, 100.0, 130.0, 160.0], 15.0), False))
    noisy = torch.from_numpy(_luma_frames(f, h, w, SEED + 5)).cuda()
    tied_w = np.tile(np.array([0.05, 0.45, 0.05, 0.45], np.float32), (h, w, 1))
    tied_w[::2, :, 0], tied_w[::2, :, 3] = 0.45, 0.05
    tied_m = np.tile(np.array([10.0, 60.0, 200.0, 120.0], np.float32), (h, w, 1))
    tied_m[..., 3] = noisy[0].cpu().numpy()
    cases.append(("tied weights 90x160 F=64", noisy, state(tied_w, tied_m, 15.0), False))
    out_w = rng.uniform(0, 3, (h, w, 4))
    out_w[::3, :, 1] = 0.0
    out_w[1::3, :, 2] = 1e-30
    out_m = noisy[0].cpu().numpy()[..., None] + rng.normal(0, 8, (h, w, 4))
    cases.append(("outside state 90x160 F=64", noisy,
                  state(out_w, out_m, rng.uniform(0.5, 200, (h, w, 4))), False))
    black = rng.integers(0, 3, (f, h, w)) * rng.integers(0, 2, (f, h, w))
    black = torch.from_numpy(black.astype(np.uint8)).cuda()
    cases.append(("black 90x160 F=64", black, mog2_init(black[0]), False))
    return cases


DIV_BATCH = 1 << 26


def _division_batches(gen):
    """(label, dividends, divisors) float32 on the card, DIV_BATCH pairs
    each, from the ranges the MOG2 recurrence produces and the range the
    kernel's short division is used on, drawn from `gen`."""
    import torch

    n = DIV_BATCH
    dev = gen.device

    def uniform(lo, hi):
        return torch.rand(n, generator=gen, device=dev, dtype=torch.float64) * (hi - lo) + lo

    def ints(lo, hi):
        return torch.randint(lo, hi, (n,), generator=gen, device=dev, dtype=torch.int32)

    def floats(exp_lo, exp_hi, mantissa=None):
        """2**e * 1.m for e in [exp_lo, exp_hi) and random (or given)
        mantissa bits."""
        m = ints(0, 1 << 23) if mantissa is None else mantissa
        return (((ints(exp_lo, exp_hi) + 127) << 23) | m).view(torch.float32)

    alpha = 1.0 / 9000
    for rep in (1, 2):
        b = uniform(0.74, 1.01)
        yield f"weights over their sum {rep}", (uniform(0, 1) * b).float(), b.float()
    near_one = (ints(-64, 65) + 0x3F800000).view(torch.float32)
    yield "weights over a sum within 64 ulps of 1", uniform(0, 1).float(), near_one
    yield ("the whole range: 2^-60..2^60 over 2^-30..2^30", floats(-60, 60), floats(-30, 30))
    # Divisors next to a power of two (mantissa all ones, zero, one),
    # dividends that are powers of two, alpha times one, or random.
    edge_m = torch.tensor([0x7FFFFF, 0, 1, 0x7FFFFE], device=dev, dtype=torch.int32)[ints(0, 4)]
    a = floats(-60, 60)
    a = torch.where(ints(0, 3) == 0, floats(-60, 60, torch.zeros_like(edge_m)), a)
    a = torch.where(ints(0, 3) == 0, floats(-46, 60) * alpha, a)
    yield "divisors next to a power of two", a, floats(-30, 30, edge_m)
    b = uniform(4.0, 75.0).float()
    d = ints(0, 256).float() - uniform(0, 255).float()
    yield "distance keys d2 / var", torch.minimum(d * d, 32.0 * b), b
    w = torch.clamp(floats(-20, 0), min=1e-6)
    yield "rho = alpha / weight", torch.full_like(w, alpha), w


def phase2_mog2_division() -> None:
    """The MOG2 kernel's short division (the hardware's reciprocal, one
    Newton step, one corrected product, with no range check) against
    `__fdiv_rn` on the card, pair by pair: 7 batches of DIV_BATCH seeded
    pairs, then the edges. Raises on the first pair that differs."""
    import numpy as np
    import torch

    from cova_tpu_torch.ops.cuda.mog2_kernel import mog2_div_pairs

    def check(label, a, b):
        quick, ieee = mog2_div_pairs(a.contiguous(), b.contiguous())
        torch.cuda.synchronize()
        bad = torch.nonzero(quick.view(torch.int32) != ieee.view(torch.int32))
        if len(bad):
            i = int(bad[0])
            raise AssertionError(
                f"short division differs from __fdiv_rn on {len(bad)} of {a.numel()} pairs "
                f"({label}); the first: {float(a[i]).hex()} / {float(b[i]).hex()} gives "
                f"{float(quick[i]).hex()}, __fdiv_rn {float(ieee[i]).hex()}")
        torch_bad = int((ieee.view(torch.int32) != (a / b).view(torch.int32)).sum())
        log(f"[2] mog2 division, {label}: {a.numel()} pairs, 0 differ from __fdiv_rn "
            f"({torch_bad} of __fdiv_rn's differ from torch's a / b)")
        return a.numel()

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    t0 = time.perf_counter()
    total = sum(check(*batch) for batch in _division_batches(gen))
    one = np.float32(1)
    alpha = np.float32(1.0 / 9000)
    sums = [np.nextafter(one, np.float32(0)), one, np.nextafter(one, np.float32(2)),
            np.float32(0.75), np.float32(2.0**-30), np.float32(2.0**30)]
    tops = [np.float32(0), alpha, np.float32(0.25), np.float32(2.0**-60), np.float32(2.0**60)]
    edges = np.array([(a, b) for b in sums for a in [*tops, b]], np.float32)
    edges = torch.from_numpy(edges).cuda()
    total += check("edges (0, alpha, 2^-60, the divisor itself; sums an ulp off 1)",
                   edges[:, 0], edges[:, 1])
    log(f"[2] mog2 division: {total} pairs (2^28 = {1 << 28}) in "
        f"{time.perf_counter() - t0:.3f} s, none differs")


def _mog2_timed(frames, state0) -> tuple:
    """(kernel, plain, restore) callables for timing one MOG2 case: each
    launch first restores the state it mutates (three copies)."""
    from cova_tpu_torch.ops.cuda.mog2_kernel import mog2_chunk, mog2_chunk_plain

    state = [t.clone() for t in state0]

    def restore():
        for dst, src in zip(state, state0):
            dst.copy_(src)

    def kernel():
        restore()
        return mog2_chunk(frames, *state)

    def plain():
        restore()
        return mog2_chunk_plain(frames, *state)

    return kernel, plain, restore


def phase2_mog2(floor: float) -> dict:
    """Every MOG2 case against the plain version on the card: the
    foreground and the three state arrays equal bit for bit, REPEATS
    times from the same state. Device times of the 256-frame chunks, each
    launch restoring the state it mutates (three copies, timed alone
    too). Returns the JSON record of the kernel (without launches)."""
    import torch

    from cova_tpu_torch.ops.cuda.mog2_kernel import mog2_chunk, mog2_chunk_plain

    phase2_mog2_division()
    timed = {}
    max_err = 0.0
    for label, frames, state0, time_it in _mog2_cases():
        ref_state = [t.clone() for t in state0]
        ref = mog2_chunk_plain(frames, *ref_state)
        for _ in range(REPEATS):
            state = [t.clone() for t in state0]
            got = mog2_chunk(frames, *state)
            torch.cuda.synchronize()
            if got.dtype != torch.bool or got.shape != frames.shape:
                raise AssertionError(f"{label}: bad output {got.dtype} {tuple(got.shape)}")
            for g, r, name in zip([got, *state], [ref, *ref_state],
                                  ("fg", "weight", "mean", "var")):
                max_err = max(max_err, float((g.double() - r.double()).abs().max()))
                if not torch.equal(g, r):
                    raise AssertionError(f"{label}: kernel {name} differs from plain")
        line = (f"[2] mog2 {label}: foreground and state equal to plain, {REPEATS} times; "
                f"{float(ref.float().mean()):.4f} of pixels foreground")
        if time_it:
            kernel, plain, restore = _mog2_timed(frames, state0)
            f, h, w = frames.shape
            nbytes = 2 * f * h * w + 2 * 3 * h * w * 4 * 4
            timed[label], text = _timing(kernel, plain, nbytes,
                                         f * h * w * MOG2_OPS_PER_PIXEL_FRAME, floor,
                                         OPS_PER_S_NO_FMA)
            line += f"; {text}; the state's restore alone {graph_ms(restore):.5f} ms"
        log(line)
    route, source, replaces = KERNELS["mog2"]
    return {"name": "mog2", "route": route, "source": source, "replaces": replaces,
            "max_abs_err": max_err, "library_ms": None,
            **timed[f"360x640 F={MOG2_CHUNK} fresh"]}


def _production_masks():
    """Phase 3's production chunk (seeded wire16 bytes, R=8, F=128, T=4,
    45x80) through BlobNet on the card: (cfg, masks (R, F, 45, 80))."""
    import numpy as np
    import torch

    from cova_tpu_torch.pipeline.compressed import compressed_probs

    dev = torch.device("cuda")
    model, _, meta = _demo_weights(dev)
    cfg = _cfg_from_meta(meta)
    r, f, t = 8, cfg.compressed.batch_frames, cfg.video.timestep
    chunk = np.random.default_rng(SEED).integers(0, 256, size=(r, f + t - 1, 45, 80, 2),
                                                 dtype=np.uint8)
    probs = compressed_probs(model, cfg, torch.as_tensor(chunk, device=dev))
    return cfg, probs > cfg.compressed.mask_threshold


def _whole_boxes(rng, r, f, md, p):
    """Seeded boxes in whole macroblock units on the 45x80 grid, each slot
    valid with probability p, as Boxes (R, F, MD) on the card."""
    import numpy as np
    import torch

    from cova_tpu_torch.types import Boxes

    lt = rng.integers(0, 70, size=(r, f, md, 2))
    wh = rng.integers(1, 12, size=(r, f, md, 2))
    valid = rng.random((r, f, md)) < p
    ltwh = np.where(valid[..., None], np.concatenate([lt, wh], -1), 0).astype(np.float32)
    ids = np.full((r, f, md), -1, np.int32)
    return Boxes(**{k: torch.from_numpy(v).cuda() for k, v in (
        ("ltwh", ltwh), ("valid", valid), ("area", ltwh[..., 2] * ltwh[..., 3]),
        ("class_id", ids), ("conf", np.zeros((r, f, md), np.float32)),
        ("track_id", ids.copy()))})


def _contested_boxes():
    """tests/test_torch_sort_scan.py's contested input: in lane 0, 64 equal
    tracks for 32 equal boxes in window 2, whose auction stops at
    max_iters; lane 1 seeded boxes."""
    import numpy as np

    b = _whole_boxes(np.random.default_rng(SEED + 7), 2, 4, 32, 0.3)
    for i, box in enumerate(((10, 10, 4, 4), (16, 10, 4, 4), (12, 10, 6, 4))):
        b.ltwh[0, i] = b.ltwh.new_tensor(box)
        b.valid[0, i] = True
    b.ltwh[0, 3] = 0
    b.valid[0, 3] = False
    return b


def _sort_cases(cfg, boxes, boxes8):
    """(label, SortConfig, gamma, boxes, ts0, nwin, state) for K7 against
    its plain version, state None for a fresh one or "carry" for the first
    case's new state: the production chunk's first SORT_CHECK_F windows,
    its next SORT_CHECK_F on the carried state, nwin tails with gamma 2, a
    full table of 64 slots, the contested auction, graft_entry's MD=8."""
    import dataclasses as dc

    import numpy as np
    import torch

    r, k, t = boxes.valid.shape[0], SORT_CHECK_F, cfg.video.timestep

    def i32(vals):
        return torch.tensor(vals, dtype=torch.int32, device="cuda")

    def windows(b, lo, hi):
        return b.map(lambda a: a[:, lo:hi].contiguous())

    return [
        (f"production, windows 0-{k - 1}", cfg.sort, 1, windows(boxes, 0, k), i32([t - 1] * r),
         i32([k] * r), None),
        (f"production, windows {k}-{2 * k - 1} on the carried state", cfg.sort, 1,
         windows(boxes, k, 2 * k), i32([t - 1 + k] * r), i32([k] * r), "carry"),
        (f"nwin tails, gamma=2, windows 0-{k - 1}", cfg.sort, 2, windows(boxes, 0, k),
         i32([t - 1] * r), i32([k, 12, 8, 1, 0, k, 9, 5]), None),
        ("full MT=64 (32 boxes a window)", dc.replace(cfg.sort, max_age=60), 1,
         _whole_boxes(np.random.default_rng(SEED + 3), r, 8, 32, 0.95), i32([t - 1] * r),
         i32([8] * r), None),
        ("contested (max_iters)", cfg.sort, 1, _contested_boxes(), i32([3, 3]), i32([4, 4]),
         None),
        (f"MD=8 MT=16 as graft_entry, windows 0-{2 * k - 1}", dc.replace(cfg.sort, max_tracks=16),
         1, windows(boxes8, 0, 2 * k), i32([t - 1] * r), i32([2 * k] * r), None),
    ]


def _bitwise_equal(got, ref) -> tuple:
    """(every field of two SortState/SortOutputs trees equal bit for bit,
    the largest absolute difference of a float field)."""
    import torch

    same, err = True, 0.0
    for fld in dataclasses.fields(ref):
        g, w = getattr(got, fld.name), getattr(ref, fld.name)
        if g.dtype != w.dtype or g.shape != w.shape:
            return False, float("inf")
        if g.dtype == torch.float32:
            err = max(err, float((g.double() - w.double()).abs().max())) if g.numel() else err
            g, w = g.view(torch.int32), w.view(torch.int32)
        same &= bool(torch.equal(g, w))
    return same, err


def _sort_bytes_ops(boxes, state, out, row_rounds) -> tuple:
    """(bytes, operations) K7 needs on these inputs: the boxes, ts0 and
    nwin read, the state read and written, the outputs written (53 bytes
    a slot and window, 4 a box); the operations of the SORT_* counts on
    this run's existing slots, valid boxes, searching rows and matches."""
    r, f, md = boxes.valid.shape
    mt = state.mean.shape[1]
    state_bytes = r * mt * (7 * 4 + 49 * 4 + 2 + 9 * 4) + 2 * r * 4
    nbytes = (r * f * md * (16 + 1) + 2 * r * 4 + 2 * state_bytes
              + r * f * mt * 53 + r * f * md * 4)
    n_exist = out.predicted.sum(dim=2).double()
    n_valid = boxes.valid.sum(dim=2).double()
    ops = (float(n_exist.sum()) * SORT_PREDICT_OPS
           + float((n_exist * n_valid).sum()) * SORT_PAIR_OPS
           + row_rounds * (SORT_ROW_OPS_PER_BOX * md + SORT_ROW_OPS)
           + int((out.matched_det >= 0).sum()) * SORT_UPDATE_OPS)
    return nbytes, int(ops)


def _k7_counts(r, f):
    """Zeroed (R, F) int32 buffers on the card for K7's rounds and
    searches."""
    import torch

    return tuple(torch.zeros((r, f), dtype=torch.int32, device="cuda") for _ in range(2))


def _synth_boxes():
    """Phase 10's chunk of the committed synth render (R=8, F=PROFILE_F,
    the demo weights, TF32 off) through BlobNet on the card, then
    `mask_to_boxes`: (boxes, SortConfig, gamma)."""
    import torch

    from cova_tpu_torch.examples.profile_device import load_chunk, profile_cfg
    from cova_tpu_torch.ops.cc import mask_to_boxes
    from cova_tpu_torch.pipeline.compressed import compressed_probs, exact_float32

    exact_float32("cuda")
    model, _, meta = _demo_weights("cuda")
    cfg = profile_cfg(meta, PROFILE_F)
    chunk = torch.as_tensor(load_chunk(SYNTH_RENDER, cfg), device="cuda")
    masks = compressed_probs(model, cfg, chunk) > cfg.compressed.mask_threshold
    return mask_to_boxes(masks, cfg.compressed.cc_threshold), cfg.sort, cfg.compressed.gamma


def _k7_split(cfg, boxes, state, ts0, nwin) -> list:
    """K7 alone on four inputs, each timed as device ms a launch (a CUDA
    graph of launches, CUDA events): the production chunk, seeded random
    boxes (30 % of the slots valid), an empty chunk (no valid box, a
    fresh state: its auction runs no round, so its time is the fixed cost
    of F windows, less the predicts) and the committed synth render's
    first chunk (phase 10's). A round of a lane: the time less the empty
    chunk's, over the mean lane's rounds (and over the slowest lane's,
    which ends the launch). Returns a record for each input."""
    import numpy as np

    from cova_tpu_torch.ops.cuda.sort_kernel import sort_scan

    r, f, md = boxes.valid.shape
    synth, synth_cfg, synth_gamma = _synth_boxes()
    inputs = [
        ("production", boxes, cfg.sort, 1),
        ("seeded random boxes, 30 % valid", _whole_boxes(np.random.default_rng(SEED), r, f, md, 0.3),
         cfg.sort, 1),
        ("empty (no valid box)", _whole_boxes(np.random.default_rng(SEED), r, f, md, 0.0),
         cfg.sort, 1),
        ("synth render's first chunk", synth, synth_cfg, synth_gamma),
    ]
    recs = []
    for label, b, scfg, gamma in inputs:
        rounds, searches = _k7_counts(r, f)
        sort_scan(state, b, ts0, nwin, gamma, scfg, rounds=rounds, searches=searches)
        one = cuda_ms(lambda: sort_scan(state, b, ts0, nwin, gamma, scfg), reps=1)
        n = max(SORT_GRAPH_LAUNCHES, min(GRAPH_LAUNCHES, int(SORT_GRAPH_MS / max(one, 1e-3))))
        ms = graph_ms(lambda: sort_scan(state, b, ts0, nwin, gamma, scfg), launches=n, replays=3)
        lane = rounds.sum(dim=1)
        recs.append({"label": label, "ms": ms, "launches": n, "rounds": int(lane.sum()),
                     "searches": int(searches.sum()), "mean_lane": float(lane.sum()) / r,
                     "slowest_lane": int(lane.max()), "valid": int(b.valid.sum())})
    empty_ms = recs[2]["ms"]
    for rec in recs:
        text = (f"[2] sort_scan split, {rec['label']} (R={r} F={f} MD={md}, {rec['valid']} valid "
                f"boxes): {rec['ms']:.4f} ms a launch (graph of {rec['launches']}); auction "
                f"rounds {rec['rounds']}, {rec['mean_lane'] / f:.2f} a lane and window "
                f"(slowest lane {rec['slowest_lane'] / f:.2f}), searches {rec['searches']} "
                f"({rec['searches'] / max(rec['rounds'], 1):.2f} a round); a window at 0 rounds "
                f"{empty_ms / f:.6f} ms (the empty chunk over F)")
        if rec["rounds"]:
            extra = rec["ms"] - empty_ms
            text += (f"; a round of a lane {extra / rec['mean_lane'] * 1e3:.4f} us (slowest lane "
                     f"{extra / rec['slowest_lane'] * 1e3:.4f} us), the rounds "
                     f"{extra / rec['ms']:.4f} of the launch")
        log(text)
    return recs


def phase2_sort(floor: float) -> dict:
    """Every K7 case against the plain version on the card: every output
    and state field bit for bit and the auction's rounds and searches
    equal to the plain version's counts, REPEATS times from the same
    state. Then K7 on the whole production chunk (R=8, F=128), REPEATS
    times: the runs equal bit for bit, their first SORT_CHECK_F windows
    equal to the plain version's. Its device time (a graph of
    SORT_GRAPH_LAUNCHES), the wrapper's call, the plain version's time on
    the first SORT_CHECK_F windows (from the check), the bound from this
    run's work, the launch floor. Returns the JSON record of the kernel
    (without launches)."""
    import numpy as np
    import torch

    from cova_tpu_torch.ops.assignment import solve_assignment_overflow as auction
    from cova_tpu_torch.ops.cc import mask_to_boxes
    from cova_tpu_torch.ops.cuda.sort_kernel import sort_scan, sort_scan_plain
    from cova_tpu_torch.tracker.sort import sort_init

    cfg, masks = _production_masks()
    boxes = mask_to_boxes(masks, cfg.compressed.cc_threshold)
    boxes8 = mask_to_boxes(masks, cfg.compressed.cc_threshold, 8)
    max_err, first = 0.0, None
    for label, scfg, gamma, b, ts0, nwin, state in _sort_cases(cfg, boxes, boxes8):
        r, f = b.valid.shape[:2]
        state = first[0] if state == "carry" else sort_init(scfg.max_tracks, r, "cuda")
        counts0 = auction.rounds, auction.row_rounds
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        ref_state, ref_out = sort_scan_plain(state, b, ts0, nwin, gamma, scfg)
        t1.record()
        t1.synchronize()
        want = (auction.rounds - counts0[0], auction.row_rounds - counts0[1])
        for _ in range(REPEATS):
            rounds, searches = _k7_counts(r, f)
            got_state, got_out = sort_scan(state, b, ts0, nwin, gamma, scfg, rounds=rounds,
                                           searches=searches)
            torch.cuda.synchronize()
            for got, ref, what in ((got_state, ref_state, "state"), (got_out, ref_out, "outputs")):
                same, err = _bitwise_equal(got, ref)
                max_err = max(max_err, err)
                if not same:
                    raise AssertionError(f"sort_scan {label}: kernel {what} differ from plain "
                                         f"(max float difference {err})")
            if (int(rounds.sum()), int(searches.sum())) != want:
                raise AssertionError(f"sort_scan {label}: {int(rounds.sum())} auction rounds and "
                                     f"{int(searches.sum())} searches, the plain version counted "
                                     f"{want}")
        if first is None:
            first = (ref_state, ref_out, t0.elapsed_time(t1))
        if label.startswith("full") and not bool(ref_out.exists.all(dim=2).any()):
            raise AssertionError(f"sort_scan {label}: no window filled every slot")
        log(f"[2] sort_scan {label} (R={r} F={f} MT={scfg.max_tracks} MD={b.valid.shape[2]}): "
            f"state and outputs equal to plain bit for bit, {REPEATS} times; auction rounds "
            f"{want[0]} ({want[0] / (r * f):.2f} a lane and window, at most {int(rounds.max())}), "
            f"searches {want[1]}, equal to the plain version's counts; "
            f"{int(ref_out.matched_det.ge(0).sum())} matches, {int(ref_out.death.sum())} deaths, "
            f"{int(ref_state.id_counter.sum())} ids; the plain version took "
            f"{t0.elapsed_time(t1) / 1e3:.3f} s")

    # The whole production chunk: K7 alone (the plain version would take
    # minutes), its runs against each other and its head against the plain.
    r, f = boxes.valid.shape[:2]
    t = cfg.video.timestep
    ts0 = torch.full((r,), t - 1, dtype=torch.int32, device="cuda")
    nwin = torch.full((r,), f, dtype=torch.int32, device="cuda")
    state = sort_init(cfg.sort.max_tracks, r, "cuda")
    runs = []
    for _ in range(REPEATS):
        rounds, searches = _k7_counts(r, f)
        out = sort_scan(state, boxes, ts0, nwin, 1, cfg.sort, rounds=rounds, searches=searches)
        torch.cuda.synchronize()
        runs.append((out, rounds, searches))
    (k_state, k_out), rounds, searches = runs[0]
    for (s2, o2), r2, q2 in runs[1:]:
        if not (_bitwise_equal(s2, k_state)[0] and _bitwise_equal(o2, k_out)[0]
                and torch.equal(r2, rounds) and torch.equal(q2, searches)):
            raise AssertionError("sort_scan on the whole chunk: two runs differ")
    head = type(k_out)(**{fl.name: getattr(k_out, fl.name)[:, :SORT_CHECK_F]
                          for fl in dataclasses.fields(k_out)})
    if not _bitwise_equal(head, first[1])[0]:
        raise AssertionError(f"sort_scan on the whole chunk: its first {SORT_CHECK_F} windows "
                             "differ from the plain version's")
    lane_rounds, row_rounds = int(rounds.sum()), int(searches.sum())
    nbytes, ops = _sort_bytes_ops(boxes, state, k_out, row_rounds)
    split = _k7_split(cfg, boxes, state, ts0, nwin)
    dev_ms = split[0]["ms"]
    call_ms = cuda_ms(lambda: sort_scan(state, boxes, ts0, nwin, 1, cfg.sort), reps=2)
    plain_ms = first[2]
    bound, by = bound_ms(nbytes, ops, OPS_PER_S_NO_FMA)
    log(f"[2] sort_scan production R={r} F={f} MT={cfg.sort.max_tracks} MD={boxes.valid.shape[2]}: "
        f"{REPEATS} runs equal bit for bit, the first {SORT_CHECK_F} windows equal to the plain "
        f"version's; auction rounds {lane_rounds} ({lane_rounds / (r * f):.2f} a lane and window, "
        f"at most {int(rounds.max())}), searches {row_rounds}; {int(k_out.matched_det.ge(0).sum())} "
        f"matches, {int(k_out.death.sum())} deaths, {int(k_state.id_counter.sum())} ids; device "
        f"{dev_ms:.4f} ms a launch (graph of {split[0]['launches']}; launch floor {floor:.5f}), "
        f"wrapper call {call_ms:.4f} ms, plain {plain_ms:.4f} ms on the first {SORT_CHECK_F} "
        f"windows, bound {bound:.6f} ms by {by} ({nbytes} bytes, {ops} operations), "
        f"{bound / dev_ms:.4%} of it")
    route, source, replaces = KERNELS["sort_scan"]
    return {"name": "sort_scan", "route": route, "source": source, "replaces": replaces,
            "max_abs_err": max_err, "library_ms": None, "device_ms": dev_ms, "ms": call_ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by, "launch_floor_ms": floor}


def _demo_weights(device):
    from cova_tpu_torch.models.blobnet import load_artifact

    return load_artifact(REPO / "artifacts" / "blobnet_demo.npz", device)


def _cfg_from_meta(meta, host_tracking=False):
    """CovaConfig defaults with the artifact's metadata channels."""
    from cova_tpu_torch.config import CovaConfig

    cfg = CovaConfig()
    return dataclasses.replace(
        cfg,
        compressed=dataclasses.replace(
            cfg.compressed,
            use_nnz_channel=bool(meta["use_nnz_channel"]),
            signed_mv=bool(meta["signed_mv"]),
            host_tracking=host_tracking,
        ),
    )


def phase3_compressed_stage() -> None:
    """A chunk of seeded wire16 bytes (R=8, F=128, T=4, 45x80) through
    CompressedStage.run_chunk on the card: the whole stage timed on two
    chunks (the second on the carried SORT state), and its parts
    (metapreprocess+BlobNet, CC+box stats, the SORT scan K7); then a small
    chunk checked stage by stage against the CPU, the SORT outputs and
    state bit for bit."""
    import numpy as np
    import torch

    from cova_tpu_torch.ops.cc import mask_to_boxes
    from cova_tpu_torch.pipeline.compressed import (
        CompressedStage,
        compressed_probs,
        track_chunk,
    )
    from cova_tpu_torch.tracker.sort import sort_init

    dev = torch.device("cuda")
    model, _, meta = _demo_weights(dev)
    cfg = _cfg_from_meta(meta)
    r, f, t = 8, cfg.compressed.batch_frames, cfg.video.timestep
    rng = np.random.default_rng(SEED)
    chunk = rng.integers(0, 256, size=(r, f + t - 1, 45, 80, 2), dtype=np.uint8)
    ts0 = np.full(r, t - 1, np.int32)
    stage = CompressedStage(model, cfg, r, dev)
    thr = cfg.compressed.mask_threshold
    mt = cfg.sort.max_tracks

    md = torch.as_tensor(chunk, device=dev)
    front_ms = cuda_ms(lambda: compressed_probs(model, cfg, md), reps=3)
    masks = compressed_probs(model, cfg, md) > thr
    boxes_ms = cuda_ms(lambda: mask_to_boxes(masks, cfg.compressed.cc_threshold), reps=3)
    boxes = mask_to_boxes(masks, cfg.compressed.cc_threshold)
    ts, nw = torch.as_tensor(ts0, device=dev), torch.full((r,), f, dtype=torch.int32, device=dev)
    sort_ms = cuda_ms(lambda: track_chunk(sort_init(mt, r, dev), boxes, ts, nw,
                                          cfg.compressed.gamma, cfg.sort), reps=3)
    times = []
    for k in range(2):
        t0 = time.perf_counter()
        packed, masks, boxes = stage.run_chunk(chunk, ts0 + k * f * cfg.compressed.gamma)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if tuple(packed.shape) != stage.packed_shape or packed.dtype != torch.uint8:
            raise AssertionError(f"packed {tuple(packed.shape)} != {stage.packed_shape}")
        if not bool(torch.isfinite(boxes.ltwh).all()):
            raise AssertionError("non-finite boxes")
    log(
        f"[3] compressed stage chunk R={r} F={f} T={t} 45x80 (from host memory): "
        f"{times[0] * 1e3:.3f} ms, then {times[1] * 1e3:.3f} ms on the carried SORT state; "
        f"{int(boxes.valid.sum())} valid boxes, {int(masks.sum())} mask pixels"
    )
    log(
        f"[3] parts on a device chunk: metapreprocess+BlobNet {front_ms:.3f} ms, CC+box stats "
        f"{boxes_ms:.3f} ms, SORT (K7, fresh state) {sort_ms:.3f} ms; the rest of the second "
        f"chunk (upload, pack) {times[1] * 1e3 - front_ms - boxes_ms - sort_ms:.3f} ms"
    )

    # Small chunk, card against CPU: probabilities within 1e-4 (cuDNN
    # sums in another order), boxes from the card's masks exactly equal
    # to the plain labelling's, the SORT (K7 against the plain version on
    # the CPU) equal bit for bit.
    rs, fs = 2, 16
    small = chunk[:rs, : fs + t - 1]
    cpu = torch.device("cpu")
    model_cpu, _, _ = _demo_weights(cpu)
    p_gpu = compressed_probs(model, cfg, torch.from_numpy(small).to(dev))
    p_cpu = compressed_probs(model_cpu, cfg, torch.from_numpy(small))
    perr = float((p_gpu.cpu() - p_cpu).abs().max())
    if not perr <= 1e-4:
        raise AssertionError(f"BlobNet card vs CPU: max abs err {perr}")
    m_gpu = p_gpu > cfg.compressed.mask_threshold
    b_gpu = mask_to_boxes(m_gpu, cfg.compressed.cc_threshold)
    b_cpu = mask_to_boxes(m_gpu.cpu(), cfg.compressed.cc_threshold)
    for name in ("ltwh", "valid", "area"):
        if not torch.equal(getattr(b_gpu, name).cpu(), getattr(b_cpu, name)):
            raise AssertionError(f"boxes.{name}: card differs from CPU")
    ts = torch.full((rs,), t - 1, dtype=torch.int32)
    nwin = torch.full((rs,), fs, dtype=torch.int32)
    s_gpu, o_gpu = track_chunk(sort_init(mt, rs, dev), b_gpu, ts.to(dev), nwin.to(dev),
                               cfg.compressed.gamma, cfg.sort)
    s_cpu, o_cpu = track_chunk(sort_init(mt, rs, cpu), b_cpu, ts, nwin,
                               cfg.compressed.gamma, cfg.sort)
    for got, ref, what in ((s_gpu, s_cpu, "state"), (o_gpu, o_cpu, "outputs")):
        got = type(got)(**{k.name: getattr(got, k.name).cpu() for k in dataclasses.fields(got)})
        if not _bitwise_equal(got, ref)[0]:
            raise AssertionError(f"SORT {what}: card (K7) differs from the CPU")
    log(
        f"[3] small chunk R={rs} F={fs}: probs max err {perr:.3g}, boxes equal, "
        f"SORT outputs and state (K7 on the card, the plain version on the CPU) equal bit "
        f"for bit"
    )


def _paff_clip(tmp: pathlib.Path, frames: int) -> pathlib.Path:
    from cova_tpu_torch.tools import paff_gen as pg
    from cova_tpu_torch.utils.mp4loop import mux_rec_to_mp4

    rec = tmp / "paff.rec"
    mp4 = tmp / "paff.mp4"
    pg.scenario_pipeline(80, 46, frames, 30).write_rec(str(rec))
    mux_rec_to_mp4(str(rec), str(mp4))
    return mp4


def _pipeline_cfg(meta, host_tracking):
    from cova_tpu_torch.config import ParallelConfig, SortConfig

    return dataclasses.replace(
        _cfg_from_meta(meta, host_tracking),
        sort=SortConfig(min_hits=3, max_age=10),
        parallel=ParallelConfig(num_ranges=8),
        last="select",
    )


CSVS = ("track", "dnn", "assoc", "stationary")


def _run_pipeline(tag, mp4, out, cfg, sd, device, samples, max_frames=None):
    """Warm up, zero the kernels' launch counts, run CovaPipeline once
    (`max_frames` a range at most), check its output and log it. Returns
    (result, launch counts, number of chunks)."""
    import torch

    from cova_tpu_torch.pipeline.cova import CovaPipeline
    from cova_tpu_torch.pipeline.ranges import RangePlan

    pipe = CovaPipeline(str(mp4), str(out), cfg, sd, device=device, log=log)
    if device == "cuda":
        pipe.warmup()
        torch.cuda.synchronize()
    _launches(reset=True)
    res = pipe.run(max_frames)
    if device == "cuda":
        torch.cuda.synchronize()
    launches = _launches()
    tm = res.timers
    log(
        f"[{tag}] pipeline on {device}: {res.num_frames} frames in "
        f"{res.elapsed_seconds:.3f} s ({res.num_frames / res.elapsed_seconds:.1f} "
        f"frames/s), {pipe.num_chunks} chunks, dead tracks {res.dead_tracks}, "
        f"decode filter rate {res.decode_filter_rate:.4f}, "
        f"inference filter rate {res.inference_filter_rate:.4f}"
    )
    log(
        f"[{tag}] StageTimers: entropy_decode {tm.entropy_decode:.3f} s, "
        f"device_dispatch {tm.device_dispatch:.3f} s, "
        f"host_mirror {tm.host_mirror:.3f} s, pixel_stage {tm.pixel_stage:.3f} s"
    )
    if max_frames:
        samples = sum(c for _, _, c in RangePlan.build(
            [st.demux for st in pipe.streams], pipe.cfg, max_frames).bounds)
    if res.num_frames != samples:
        raise AssertionError(f"num_frames {res.num_frames} != {samples} samples")
    if res.dead_tracks <= 0:
        raise AssertionError("no dead tracks reported")
    for name in CSVS:
        if not (out / f"{name}.csv").exists():
            raise AssertionError(f"{name}.csv missing")
    rows = (out / "track.csv").read_text().strip().splitlines()
    if len(rows) < 2:
        raise AssertionError("track.csv has no rows")
    log(f"[{tag}] track.csv rows: {len(rows) - 1}, launches {launches}")
    return res, launches, pipe.num_chunks


def _same_csvs(tag, out, ref, res, cpu) -> None:
    """The four CSVs of two pipeline runs byte-identical, and their
    counts equal."""
    for name in CSVS:
        if (out / f"{name}.csv").read_bytes() != (ref / f"{name}.csv").read_bytes():
            raise AssertionError(f"[{tag}] {name}.csv: card run differs from the CPU run")
    for key in ("dropped", "decoded_dependency", "decoded_inference", "dead_tracks"):
        if getattr(res, key) != getattr(cpu, key):
            raise AssertionError(
                f"[{tag}] {key}: card {getattr(res, key)} != CPU {getattr(cpu, key)}"
            )


def phase4_pipeline(mp4, samples, tmp) -> tuple:
    """CovaPipeline(device="cuda") with host_tracking=False end to end on
    the whole clip, K7 launched once a chunk; then the same on the CPU:
    the four CSVs byte-identical and the counts equal. Returns (the card's
    result, its launch counts)."""
    _, sd, meta = _demo_weights("cpu")
    cfg = _pipeline_cfg(meta, False)
    res, launches, n_chunks = _run_pipeline("4", mp4, tmp / "out4", cfg, sd, "cuda", samples)
    if launches["cc_label"] < n_chunks:
        raise AssertionError(
            f"cc_label launched {launches['cc_label']} times for {n_chunks} chunks"
        )
    if launches["sort_scan"] != n_chunks:
        raise AssertionError(
            f"sort_scan launched {launches['sort_scan']} times for {n_chunks} chunks"
        )
    from cova_tpu_torch.ops.assignment import solve_assignment_overflow as auction

    rounds0 = auction.rounds
    cpu, _, _ = _run_pipeline("4", mp4, tmp / "out4cpu", cfg, sd, "cpu", samples)
    rounds = auction.rounds - rounds0
    _same_csvs("4", tmp / "out4", tmp / "out4cpu", res, cpu)
    lane_windows = cfg.parallel.num_ranges * n_chunks * cfg.compressed.batch_frames
    log(f"[4] the four CSVs of the card run (K7) equal the CPU run's (the plain SORT), byte "
        f"for byte; sort_scan launches {launches['sort_scan']} for {n_chunks} chunks; the CPU "
        f"run took {cpu.elapsed_seconds:.3f} s, its auction {rounds} rounds "
        f"({rounds / lane_windows:.2f} a lane and window)")
    return res, launches


def _masks_split(model, cfg, md, runs: int = 10) -> dict:
    """Device ms of each part of the masks step (compressed_masks_step) on
    the device chunk `md`, read from the step itself: CUDA events recorded
    on the stream at the edges of the model's own encoder convolutions and
    of each K4 and K12 launch (BlobNet's `blob_stage` and `blob_up`,
    wrapped for the runs). The time between two events goes to the part it
    lies in: preprocessing (unpack_wire16, metapreprocess) before the
    first convolution, "between" from a K4 launch to the next convolution
    or the decoder, the threshold and pack after the last K12 launch.
    Medians over `runs` steps after a warm-up; "whole step" is the median
    from the first event to the last."""
    import torch

    from cova_tpu_torch.models import blobnet
    from cova_tpu_torch.pipeline.compressed import compressed_masks_step

    parts = ("preprocess", "encoder convs", "K4", "between", "K12 (the decoder)",
             "threshold and pack")
    marks = []  # (the part that starts here, event)

    def mark(part):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((part, ev))

    def hooks(module, before, after):
        return (module.register_forward_pre_hook(lambda *_: mark(before)),
                module.register_forward_hook(lambda *_: mark(after)))

    handles = [h for conv in model.enc_conv for h in hooks(conv, "encoder convs", "between")]
    k4, k12 = blobnet.blob_stage, blobnet.blob_up

    def timed(kernel, part, after):
        def run(*args):
            mark(part)
            out = kernel(*args)
            mark(after)
            return out
        return run

    blobnet.blob_stage = timed(k4, "K4", "between")
    blobnet.blob_up = timed(k12, "K12 (the decoder)", "threshold and pack")
    runs_ms = []
    try:
        for i in range(runs + 1):
            marks.clear()
            mark("preprocess")
            compressed_masks_step(model, cfg, md)
            mark(None)
            torch.cuda.synchronize()
            if i == 0:  # warm-up
                continue
            got = dict.fromkeys(parts, 0.0)
            for (part, ev), (_, nxt) in zip(marks, marks[1:]):
                got[part] += ev.elapsed_time(nxt)
            got["whole step"] = marks[0][1].elapsed_time(marks[-1][1])
            runs_ms.append(got)
    finally:
        blobnet.blob_stage, blobnet.blob_up = k4, k12
        for h in handles:
            h.remove()
    return {k: statistics.median(r[k] for r in runs_ms) for k in runs_ms[0]}


def phase5_masks_step() -> None:
    """The host-tracking device step, run_chunk_masks, on a seeded
    production chunk (R=8, F=128, T=4) at 45x80 and 68x120: its time, and
    a sub-chunk (R=2, F=16) against the port on the CPU, packed bytes
    equal except at pixels whose CPU probability lies within 1e-4 of the
    threshold."""
    import numpy as np
    import torch

    from cova_tpu_torch.models.blobnet import load_artifact
    from cova_tpu_torch.pipeline.compressed import (
        CompressedStage,
        compressed_masks_step,
        compressed_probs,
        unpack_masks,
    )

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    for weights, (h, w) in (("blobnet_demo.npz", (45, 80)),
                            ("blobnet_demo1080.npz", (68, 120))):
        model, _, meta = load_artifact(REPO / "artifacts" / weights, dev)
        cfg = _cfg_from_meta(meta, host_tracking=True)
        r, f, t = 8, cfg.compressed.batch_frames, cfg.video.timestep
        thr = cfg.compressed.mask_threshold
        chunk = rng.integers(0, 256, size=(r, f + t - 1, h, w, 2), dtype=np.uint8)
        stage = CompressedStage(model, cfg, r, dev)
        out = stage.run_chunk_masks(chunk)
        torch.cuda.synchronize()
        if out.device.type != "cuda" or out.dtype != torch.uint8:
            raise AssertionError(f"masks step output {out.dtype} on {out.device}")
        if tuple(out.shape) != (r * f * h * w // 8,) or stage.masks_shape != (r, f, h, w):
            raise AssertionError(
                f"masks step shape {tuple(out.shape)}, {stage.masks_shape}"
            )
        host_ms = cuda_ms(lambda: stage.run_chunk_masks(chunk))
        md = torch.as_tensor(chunk, device=dev)
        dev_ms = cuda_ms(lambda: stage.run_chunk_masks(md))
        on = float(unpack_masks(out.cpu().numpy(), stage.masks_shape).mean())
        log(
            f"[5] run_chunk_masks R={r} F={f} T={t} {h}x{w} ({weights}): "
            f"{host_ms:.3f} ms from host memory, {dev_ms:.3f} ms from a device "
            f"chunk; {on:.4f} of pixels on"
        )
        if (h, w) == (68, 120):
            split = _masks_split(stage.models[0], cfg, md[:4])
            parts = sum(v for k, v in split.items() if k != "whole step")
            log(f"[5] the split of a 68x120 chunk (R=4, F={f}), device ms of each part "
                "within the step (medians of 10): "
                + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
                + f"; the parts sum to {parts:.3f}")

        rs, fs = 2, 16
        small = chunk[:rs, : fs + t - 1]
        got = stage.run_chunk_masks(small).cpu().numpy()
        model_cpu, _, _ = load_artifact(REPO / "artifacts" / weights, "cpu")
        x_cpu = torch.from_numpy(small)
        ref = compressed_masks_step(model_cpu, cfg, x_cpu).numpy()
        p_cpu = compressed_probs(model_cpu, cfg, x_cpu).numpy()
        shape = (rs, fs, h, w)
        flipped = unpack_masks(got, shape) != unpack_masks(ref, shape)
        gap = np.abs(p_cpu - thr)
        near = gap <= 1e-4
        if (flipped & ~near).any():
            raise AssertionError(
                f"{h}x{w}: {int((flipped & ~near).sum())} mask pixels differ from "
                "the CPU away from the threshold"
            )
        log(
            f"[5] sub-chunk R={rs} F={fs} {h}x{w} card vs CPU: "
            f"{int((got != ref).sum())} bytes differ, {int(flipped.sum())} pixels "
            f"flipped, {int(near.sum())} pixels within 1e-4 of the threshold, "
            f"smallest |p - threshold| {float(gap.min()):.3g}"
        )


def phase6_default_pipeline(mp4, samples, tmp, phase4) -> None:
    """CovaPipeline(device="cuda") with the CovaConfig defaults
    (host_tracking=True) end to end; its four CSVs byte-identical to the
    port's run on the CPU."""
    _, sd, meta = _demo_weights("cpu")
    cfg = _pipeline_cfg(meta, True)
    res, launches, _ = _run_pipeline("6", mp4, tmp / "out6", cfg, sd, "cuda", samples)
    cpu, _, _ = _run_pipeline("6", mp4, tmp / "out6cpu", cfg, sd, "cpu", samples)
    _same_csvs("6", tmp / "out6", tmp / "out6cpu", res, cpu)
    log("[6] the four CSVs of the card run equal the CPU run's, byte for byte")
    for label, r_ in (("phase 4 (device tracking, the whole clip)", phase4),
                      ("phase 6 (host tracking)", res)):
        log(
            f"[6] {label}: dead tracks {r_.dead_tracks}, dropped {r_.dropped}, "
            f"decoded dependency {r_.decoded_dependency}, decoded inference "
            f"{r_.decoded_inference}, wall {r_.elapsed_seconds:.3f} s"
        )


YOLO_CFG = REPO / "cova_tpu" / "models" / "cfg" / "yolov4.cfg"
# Card against CPU on one frame: the 608x608 input (the antialiased
# resize sums in another order; the tests hold it to JAX at the same
# tolerance) and the raw heads (float32 sums in other orders through 110
# layers, TF32 off on the card; 1.6e-6 measured on an H100).
INPUT_TOL = 1e-4
HEAD_TOL = 1e-4


def _yolo_weights(path: pathlib.Path, seed: int, gain: float = 0.8) -> None:
    """Seeded darknet-format weights for full-width YOLOv4 (80 classes),
    in cfg order, by the recipe of tests/test_yolov4.py's golden test,
    which keeps 110 stacked convs finite: biases N(0, 0.1), BN scale
    U(0.9, 1.1), mean N(0, 0.1), variance U(0.8, 1.2), conv weights
    N(0, gain * sqrt(2 / fan_in)). The golden test's gain of 0.5 lets
    the frame's content die out on the way (two different frames give
    heads within 1e-6 of each other, and the 512 best scores lie in a
    band 0.01 wide with hundreds of exact ties); at 0.8 the heads still
    follow the frame, and stay below 1 in magnitude."""
    import numpy as np

    from cova_tpu_torch.models.yolov4 import YOLOv4, darknet_convs

    rng = np.random.default_rng(seed)
    with open(path, "wb") as fh:
        fh.write(np.zeros(5, np.int32).tobytes())
        for m in darknet_convs(YOLOv4(80)):
            f, cin, k = m.conv.out_channels, m.conv.in_channels, m.conv.kernel_size[0]
            if m.bn is None:
                parts = [rng.normal(0, 0.1, f)]
            else:
                parts = [rng.normal(0, 0.1, f), rng.uniform(0.9, 1.1, f),
                         rng.normal(0, 0.1, f), rng.uniform(0.8, 1.2, f)]
            parts.append(rng.normal(0, gain * np.sqrt(2.0 / (k * k * cin)), f * cin * k * k))
            for p in parts:
                fh.write(p.astype(np.float32).tobytes())


def _oracle_frames(n: int, seed: int) -> list:
    """n 1280x720 I420 frames [(ts, y, u, v)]: the synth scene's
    background (artifacts/synth_bg.npy, 640x360 luma) upscaled 2x, grey
    chroma, and four bright rectangles of seeded size, place and colour
    drawn into each."""
    import numpy as np

    y0 = np.load(REPO / "artifacts" / "synth_bg.npy").repeat(2, 0).repeat(2, 1)
    rng = np.random.default_rng(seed)
    frames = []
    for i in range(n):
        y = y0.copy()
        u = np.full((360, 640), 128, np.uint8)
        v = np.full((360, 640), 128, np.uint8)
        for _ in range(4):
            h, w = int(rng.integers(40, 200)), int(rng.integers(60, 320))
            t, l = int(rng.integers(0, 720 - h)), int(rng.integers(0, 1280 - w))
            y[t : t + h, l : l + w] = rng.integers(200, 256)
            u[t // 2 : (t + h) // 2, l // 2 : (l + w) // 2] = rng.integers(0, 256)
            v[t // 2 : (t + h) // 2, l // 2 : (l + w) // 2] = rng.integers(0, 256)
        frames.append((i / 30.0, y, u, v))
    return frames


def _recs_diff(got, ref, rel: float, abs_: float) -> list:
    """Where two BoxRec lists differ: the same count, and rec by rec the
    same class, timestamp and track, coordinates and confidence within
    rel/abs."""
    import math

    if len(got) != len(ref):
        return [f"{len(got)} recs != {len(ref)}"]
    bad = []
    for i, (g, r) in enumerate(zip(got, ref)):
        if (g.class_id, g.timestamp, g.track_id) != (r.class_id, r.timestamp, r.track_id):
            bad.append(f"rec {i}: class/ts {g.class_id}/{g.timestamp} != "
                       f"{r.class_id}/{r.timestamp}")
            continue
        for key in ("left", "top", "width", "height", "area", "confidence"):
            a, b = getattr(g, key), getattr(r, key)
            if not math.isclose(a, b, rel_tol=rel, abs_tol=abs_):
                bad.append(f"rec {i}: {key} {a!r} != {b!r}")
    return bad


def _stage_ms(det, frame) -> dict:
    """Per-frame times of one detector (CUDA events, median of 5): the
    planes' upload, preprocess (YUV -> 608 RGB), the network, decode +
    NMS, and the whole call including the copy back and the BoxRecs."""
    _, y, u, v = frame
    planes = det.planes(y, u, v)
    x = det.preprocess(*planes)
    outs = det.network(x)
    return {
        "upload": cuda_ms(lambda: det.planes(y, u, v)),
        "preprocess": cuda_ms(lambda: det.preprocess(*planes)),
        "network": cuda_ms(lambda: det.network(x)),
        "decode+nms": cuda_ms(lambda: det.postprocess(outs)),
        "call": cuda_ms(lambda: det([frame])),
    }


def phase7_oracle(tmp: pathlib.Path) -> int:
    """The oracle on the card. Returns the NMS kernel's launches in the
    detector's run over the frames."""
    import numpy as np
    import torch

    from cova_tpu_torch.models.yolov4 import make_yolo_detector
    from cova_tpu_torch.ops.cuda.nms_kernel import nms

    t0 = time.perf_counter()
    weights = tmp / "yolov4_seeded.weights"
    _yolo_weights(weights, SEED)
    frames = _oracle_frames(5, SEED)
    log(f"[7] seeded YOLOv4 weights ({weights.stat().st_size} bytes) and "
        f"{len(frames)} frames 1280x720 made in {time.perf_counter() - t0:.3f} s")
    torch.cuda.reset_peak_memory_stats()
    det = make_yolo_detector(str(weights), device="cuda")
    det0 = make_yolo_detector(str(weights), score_threshold=0.0, device="cuda")
    n_params = sum(p.numel() for p in det.model.parameters())
    det(frames[:1])
    det0(frames[:1])
    torch.cuda.synchronize()

    # The main path: the detector over the frames.
    nms.launches = 0
    t0 = time.perf_counter()
    recs = det(frames)
    dt = time.perf_counter() - t0
    launches = nms.launches
    log(f"[7] make_yolo_detector(device=cuda), {n_params} parameters, score 0.25 "
        f"nms-iou 0.2: {len(frames)} frames in {dt * 1e3:.3f} ms, {len(recs)} "
        f"BoxRecs, nms launches {launches}")
    if launches != len(frames):
        raise AssertionError(f"nms launched {launches} times for {len(frames)} frames")
    for r in recs:
        vals = (r.left, r.top, r.width, r.height, r.confidence)
        if not (all(np.isfinite(vals)) and r.width > 0 and r.height > 0
                and 0 <= r.class_id < 80 and 0.25 < r.confidence <= 1.0):
            raise AssertionError(f"bad BoxRec {r}")
    per_frame = [sum(r.timestamp == f[0] for r in recs) for f in frames]
    recs0 = det0(frames)
    per_frame0 = [sum(r.timestamp == f[0] for r in recs0) for f in frames]
    log(f"[7] BoxRecs per frame: {per_frame} at score 0.25, {per_frame0} at 0.0")
    if not recs:
        raise AssertionError("no detections at the reference thresholds")

    for label, d in (("score 0.25 nms-iou 0.2", det), ("score 0.0 nms-iou 0.2", det0)):
        ms = _stage_ms(d, frames[0])
        log(f"[7] per frame, {label}: " + ", ".join(
            f"{k} {v:.4f} ms" for k, v in ms.items()))
    log(f"[7] peak device memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")

    # One frame against the same detector on the CPU. The network is held
    # within INPUT_TOL and HEAD_TOL. The detections are held on the same heads: the
    # card's heads through the CPU's decode + plain NMS give the card's
    # BoxRecs. (Random weights leave near-ties among the 512 best scores,
    # and a float32 rounding of a head can reorder them, so the CPU's own
    # heads are compared too and the differences printed.)
    failures = []
    ts, y, u, v = frames[0]
    cpu = make_yolo_detector(str(weights), device="cpu")
    x_cpu = cpu.preprocess(*cpu.planes(y, u, v))
    x_gpu = det.preprocess(*det.planes(y, u, v))
    in_err = float((x_gpu.cpu() - x_cpu).abs().max())
    t0 = time.perf_counter()
    h_cpu = cpu.network(x_cpu)
    cpu_net_s = time.perf_counter() - t0
    h_gpu = det.network(x_gpu)
    head_err = max(float((g.cpu() - c).abs().max()) for g, c in zip(h_gpu, h_cpu))
    scale = max(float(c.abs().max()) for c in h_cpu)
    log(f"[7] frame 0, card against CPU: input max err {in_err:.3g}, raw heads max "
        f"err {head_err:.3g} (largest |head| {scale:.3g}; tolerances {INPUT_TOL}, "
        f"{HEAD_TOL}); "
        f"CPU network {cpu_net_s:.3f} s")
    if not (in_err <= INPUT_TOL and head_err <= HEAD_TOL):
        failures.append(f"card against CPU: input err {in_err}, heads err {head_err}")
    recs_gpu = det(frames[:1])
    post = [a[0].numpy() for a in cpu.postprocess([h.cpu() for h in h_gpu])]
    bad = _recs_diff(recs_gpu, cpu.boxrecs(ts, y.shape, *post), 1e-5, 1e-4)
    log(f"[7] frame 0, the card's heads through the card's decode + NMS kernel "
        f"and through the CPU's decode + plain NMS: {len(recs_gpu)} BoxRecs, "
        + ("equal" if not bad else f"{len(bad)} differences: {bad[:6]}"))
    if bad:
        failures.append("BoxRecs differ from the CPU's on the same heads")
    recs_cpu = cpu(frames[:1])
    diff = _recs_diff(recs_gpu, recs_cpu, 1e-4, 1e-3)
    log(f"[7] frame 0, the card's detector against the CPU's (their own heads): "
        f"{len(recs_gpu)} against {len(recs_cpu)} BoxRecs, "
        + ("equal" if not diff else f"{len(diff)} differences: {diff[:6]}"))

    # The network built from the darknet cfg file.
    cfgdet = make_yolo_detector(str(weights), cfg_path=str(YOLO_CFG), device="cuda")
    h_cfg = cfgdet.network(x_gpu)
    cfg_err = max(float((a - b).abs().max()) for a, b in zip(h_cfg, h_gpu))
    exact = all(torch.equal(a, b) for a, b in zip(h_cfg, h_gpu))
    bad = _recs_diff(cfgdet(frames[:1]), recs_gpu, 0.0, 0.0)
    log(f"[7] cfg-built network ({YOLO_CFG.name}) against the hand-written one on "
        f"the card: heads max err {cfg_err:.3g} ({'bit for bit' if exact else 'not exact'}), "
        f"BoxRecs {'equal' if not bad else bad[:6]}")
    # The same convolutions in the same order: equal heads, equal BoxRecs.
    if cfg_err > HEAD_TOL or (exact and bad):
        failures.append(f"cfg-built network differs: heads {cfg_err}, BoxRecs {bad[:3]}")
    if failures:
        raise AssertionError("; ".join(failures))
    return launches


PHASE8_FRAMES = 512
PHASE8_EPOCHS = 2
PHASE8_CPU_STEPS = 4
# Card against CPU, the first PHASE8_CPU_STEPS steps with dropout 0 and
# TF32 off, each step replayed on the CPU from the card's weights and
# Adam state: the loss is on a 0-100 scale, and cuDNN sums the
# convolutions in another order than the CPU, which moves it by about
# 1e-5. (Run apart, the two drift, as phase 8 prints: Adam moves every
# weight whose gradient lies at rounding-noise level by about lr a step,
# either way.)
LOSS_TOL = 1e-3


def _labels_timed(luma, plain: bool):
    """generate_labels' loop on the card, each part timed: the chunk's
    upload, MOG2 (K6, or its plain version) and the morphology (CUDA
    events), the copy to the host and the host's hole filling (host
    clock). Returns (labels, milliseconds a frame of each part)."""
    import numpy as np
    import scipy.ndimage
    import torch

    from cova_tpu_torch.ops.cuda.mog2_kernel import mog2_chunk_plain, mog2_init
    from cova_tpu_torch.utils.mog import _StatefulMog2, morph_close_open

    ms = dict.fromkeys(("upload", "mog2", "morphology", "copy", "fill"), 0.0)
    mog = _StatefulMog2()
    out = []
    for start in range(0, len(luma), MOG2_CHUNK):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        torch.cuda.synchronize()
        ev[0].record()
        part = torch.from_numpy(np.ascontiguousarray(luma[start : start + MOG2_CHUNK])).cuda()
        ev[1].record()
        if plain:
            if mog.state is None:
                mog.state = mog2_init(part[0])
            fg = mog2_chunk_plain(part, *mog.state)
        else:
            fg = mog.run(part)
        ev[2].record()
        fg = morph_close_open(fg)
        ev[3].record()
        ev[3].synchronize()
        t0 = time.perf_counter()
        fg_np = fg.cpu().numpy()
        t1 = time.perf_counter()
        out.extend(scipy.ndimage.binary_fill_holes(m)[::8, ::8] for m in fg_np)
        t2 = time.perf_counter()
        for key, (a, b) in (("upload", (0, 1)), ("mog2", (1, 2)), ("morphology", (2, 3))):
            ms[key] += ev[a].elapsed_time(ev[b])
        ms["copy"] += (t1 - t0) * 1e3
        ms["fill"] += (t2 - t1) * 1e3
    return np.stack(out).astype(np.uint8), {k: v / len(luma) for k, v in ms.items()}


def _paff_windows(mp4, n, timestep=4):
    """The PAFF clip's first n samples in display order, entropy-decoded
    with signed MVs, packed with the nnz channel (the shipped contract)
    and slid as build_training_set slides (stride T, newest first).
    Returns (windows (N, T, H, W, 4) u8, the window starts)."""
    import numpy as np

    from cova_tpu_torch.codec import Mp4Demuxer
    from cova_tpu_torch.utils.dataset import pack_metadata

    demux = Mp4Demuxer(str(mp4))
    order = demux.display_order(0, n)
    meta = demux.entropy_decode_indices(order, threads=8, signed_mv=True)
    frames = pack_metadata(meta, use_nnz=True, signed_mv=True)
    starts = np.arange(0, len(frames) - timestep + 1, timestep)
    idx = starts[:, None] + np.arange(timestep - 1, -1, -1)[None, :]
    return frames[idx], starts


def phase8_training(mp4, tmp: pathlib.Path) -> int:
    """BlobNet training on the card at full width. Returns K6's launches
    in the labels' run."""
    import numpy as np
    import torch

    from cova_tpu_torch.models.blobnet import (
        BlobNet,
        BlobNetConfig,
        load_artifact,
        save_params_npz,
    )
    from cova_tpu_torch.models.train_blobnet import make_adam, make_train_step, train_blobnet
    from cova_tpu_torch.ops.cuda.mog2_kernel import mog2_chunk
    from cova_tpu_torch.pipeline.compressed import compressed_masks_step
    from cova_tpu_torch.utils.dataset import ArrayDataset
    from cova_tpu_torch.utils.mog import generate_labels

    # Labels: MOG2 on the card over 512 frames at 368x640 (the PAFF clip's
    # 46x80 grid at half resolution), against the plain version's.
    t0 = time.perf_counter()
    luma = _luma_frames(PHASE8_FRAMES, 368, 640, SEED + 8)
    log(f"[8] {PHASE8_FRAMES} luma frames 368x640 made in {time.perf_counter() - t0:.3f} s")
    generate_labels(luma[:8], device="cuda")  # warm-up: cuDNN pools, the library
    torch.cuda.synchronize()
    mog2_chunk.launches = 0
    t0 = time.perf_counter()
    labels = generate_labels(luma, device="cuda")
    dt = time.perf_counter() - t0
    launches = mog2_chunk.launches
    if launches != -(-PHASE8_FRAMES // MOG2_CHUNK):
        raise AssertionError(f"mog2 launched {launches} times for {PHASE8_FRAMES} frames")
    if labels.shape != (PHASE8_FRAMES, 46, 80) or not 0 < labels[16:].mean() < 0.5:
        raise AssertionError(f"labels {labels.shape}, foreground {labels.mean()}")
    log(f"[8] generate_labels(device=cuda): {PHASE8_FRAMES} frames in {dt * 1e3:.3f} ms "
        f"({dt * 1e3 / PHASE8_FRAMES:.4f} ms a frame), labels {labels.shape}, "
        f"foreground {labels.mean():.4f}, mog2 launches {launches}")
    plain, _ = _labels_timed(luma, plain=True)
    again, split = _labels_timed(luma, plain=False)
    for name, other in (("the MOG2 plain version's", plain), ("a timed rerun's", again)):
        if not np.array_equal(other, labels):
            raise AssertionError(f"{int((other != labels).sum())} labels differ from {name}")
    log("[8] labels equal to those of the MOG2 plain version on the card")
    log("[8] labels per frame: " + ", ".join(f"{k} {v:.5f} ms" for k, v in split.items())
        + f"; mog2 {split['mog2'] * MOG2_CHUNK:.4f} ms of device time a "
        f"{MOG2_CHUNK}-frame chunk")

    # Windows of the PAFF clip paired with the labels (the content does not
    # correspond: the point is the path).
    x, starts = _paff_windows(mp4, PHASE8_FRAMES)
    y = labels[starts + 3]
    if x.shape[2:] != (46, 80, 4):
        raise AssertionError(f"windows {x.shape} do not lie on the labels' grid")
    log(f"[8] training set: x {x.shape} y {y.shape} (fg rate {y.mean():.4f})")

    # Training at full width from the demo artifact's weights.
    _, sd, meta = load_artifact(REPO / "artifacts" / "blobnet_demo.npz", "cpu")
    cfg = BlobNetConfig(in_channels=int(meta["in_channels"]))
    ds = ArrayDataset(x, y, batch=4, seed=SEED)
    t0 = time.perf_counter()
    model, trained = train_blobnet(
        ds, epochs=PHASE8_EPOCHS, config=cfg,
        generator=torch.Generator("cuda").manual_seed(SEED), log_every=0,
        signed_mv=True, variables=sd, device="cuda",
    )
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n_steps = PHASE8_EPOCHS * ds.steps_per_epoch
    log(f"[8] train_blobnet(device=cuda), {sum(p.numel() for p in model.parameters())} "
        f"parameters, batch 4: {PHASE8_EPOCHS} epochs of {ds.steps_per_epoch} steps in "
        f"{dt:.3f} s ({dt * 1e3 / n_steps:.3f} ms a step, metrics pulled each step)")
    if not all(bool(torch.isfinite(v).all()) for v in trained.values()):
        raise AssertionError("non-finite trained weights")
    if all(torch.equal(trained[k], sd[k]) for k in sd if k.endswith("weight")):
        raise AssertionError("training changed no weight")
    batches = [b for _, b in zip(range(PHASE8_CPU_STEPS), ArrayDataset(x, y, seed=SEED + 1))]
    timing_model = BlobNet(cfg).cuda()
    timing_model.load_state_dict(sd)
    step = make_train_step(timing_model, make_adam(timing_model), True,
                           torch.Generator("cuda").manual_seed(SEED))
    step_ms = cuda_ms(lambda: step(batches[0]), reps=20)
    log(f"[8] one train step (CUDA events, median of 20): {step_ms:.4f} ms")

    # The first steps again on the CPU, dropout 0, TF32 off on the card:
    # each card step replayed on the CPU from the card's weights and Adam
    # state of the moment.
    cfg0 = BlobNetConfig(in_channels=cfg.in_channels, dropout=0.0)
    models = {dev: BlobNet(cfg0).to(dev) for dev in ("cuda", "cpu")}
    opts = {dev: make_adam(m) for dev, m in models.items()}
    steps = {dev: make_train_step(m, opts[dev], True) for dev, m in models.items()}
    models["cuda"].load_state_dict(sd)
    losses = {"cuda": [], "cpu": []}
    moved = []
    for b in batches:
        models["cpu"].load_state_dict(models["cuda"].state_dict())
        opts["cpu"].load_state_dict(opts["cuda"].state_dict())
        for dev in ("cuda", "cpu"):
            losses[dev].append(float(steps[dev](b)["loss"]))
        cpu_sd = models["cpu"].state_dict()
        moved.append(max(float((v.cpu() - cpu_sd[k]).abs().max())
                         for k, v in models["cuda"].state_dict().items()
                         if v.is_floating_point()))
    err = max(abs(a - b) for a, b in zip(losses["cuda"], losses["cpu"]))
    log(f"[8] first {PHASE8_CPU_STEPS} steps, dropout 0, each replayed on the CPU from the "
        f"card's state: card losses {losses['cuda']}, CPU {losses['cpu']}, max err "
        f"{err:.3g} (tolerance {LOSS_TOL}); weights after each step within {moved}")
    if not err <= LOSS_TOL:
        raise AssertionError(f"card losses differ from the CPU's by {err}")
    # The same steps on the CPU run apart from the card's (printed, not
    # held: see LOSS_TOL).
    apart = BlobNet(cfg0)
    apart.load_state_dict(sd)
    apart_step = make_train_step(apart, make_adam(apart), True)
    drift = [abs(float(apart_step(b)["loss"]) - c) for b, c in zip(batches, losses["cuda"])]
    log(f"[8] the same steps run apart on the CPU: losses differ from the card's by {drift}")

    # Round trip: the Flax-layout npz, loaded again on the card, one masks
    # step on the saved weights.
    path = tmp / "trained.npz"
    save_params_npz(path, trained, meta)
    loaded, sd2, meta2 = load_artifact(path, "cuda")
    same = all(torch.equal(sd2[k], v) for k, v in trained.items()
               if not k.endswith("num_batches_tracked"))
    chunk = np.random.default_rng(SEED).integers(0, 256, size=(2, 19, 46, 80, 2), dtype=np.uint8)
    pcfg = _cfg_from_meta(meta2, host_tracking=True)
    md = torch.from_numpy(chunk).cuda()
    a = compressed_masks_step(loaded, pcfg, md)
    b = compressed_masks_step(model, pcfg, md)
    log(f"[8] save_params_npz + load_artifact on the card: weights "
        f"{'equal' if same else 'DIFFERENT'}, masks step {tuple(a.shape)} bytes "
        f"{'equal' if torch.equal(a, b) else 'DIFFERENT'} to the trained model's")
    if not (same and torch.equal(a, b) and meta2 == meta):
        raise AssertionError("the saved weights do not load back")
    return launches


SYNTH_RENDER = REPO / "cova_tpu_torch" / "data" / "synth_1800.mp4"
# The synth report of the float32 path on the committed render, computed
# on the CPU (`reproduce_synth --replay --device cpu`); the JAX package's
# own sweep harness gives the same numbers (tests/test_torch_synth_report.py).
SYNTH_REFERENCE = REPO / "cova_tpu_torch" / "data" / "synth_1800_report_cpu.json"
# The bands tests/test_accuracy_golden.py holds the committed TPU report
# (golden/synth/report.json) to: (key, bound, ">=" or "<=").
TPU_BANDS = (("bp_accuracy", 0.98, ">="), ("gc_error", 1.7, "<="),
             ("decode_filter_rate", 0.65, ">="), ("inference_filter_rate", 0.98, ">="))
QUERY_PREFIX = 300  # frames a range of the card-against-CPU check


def _query_line(rep) -> str:
    return (f"BP {rep['bp_accuracy']:.4f}, GC {rep['gc_error']:.4f}, BPL "
            f"{rep['bp_accuracy_local']:.4f}, GCL {rep['gc_error_local']:.4f}"
            + (f", decode filter {rep['decode_filter_rate']:.4f}, inference filter "
               f"{rep['inference_filter_rate']:.4f}, dead tracks {rep['dead_tracks']}"
               if "dead_tracks" in rep else ""))


def _query_prefix(tmp: pathlib.Path) -> None:
    """The first QUERY_PREFIX frames of each range through the sweep
    harness twice, BlobNet on the card and on the CPU: every mask pixel
    at the threshold equal but where the CPU's probability lies within
    1e-4 of it (phase 5's rule), and run_config's four CSVs byte-identical
    unless such a pixel flipped (then the flip and the first differing
    row are printed)."""
    import numpy as np

    from cova_tpu_torch.examples.reproduce_synth import SYNTH_WEIGHTS, synth_cfg
    from cova_tpu_torch.examples.sweep_accuracy import SYNTH_GT, SweepContext
    from cova_tpu_torch.models.blobnet import load_meta_npz

    cfg = synth_cfg(load_meta_npz(SYNTH_WEIGHTS))
    thr = cfg.compressed.mask_threshold
    reps, probs = {}, {}
    for device in ("cuda", "cpu"):
        ctx = SweepContext(SYNTH_RENDER, gt_csv=SYNTH_GT, dataset="synth",
                           max_frames=QUERY_PREFIX, device=device)
        probs[device] = ctx.probs(SYNTH_WEIGHTS, use_nnz=cfg.compressed.use_nnz_channel,
                                  signed_mv=cfg.compressed.signed_mv, cache=False)
        reps[device] = ctx.run_config(probs[device], cfg, out_dir=str(tmp / f"q9_{device}"))
    err, near, flips = 0.0, 0, []
    for ri, (g, c) in enumerate(zip(probs["cuda"], probs["cpu"])):
        err = max(err, float(np.abs(g - c).max(initial=0.0)))
        close = np.abs(c - thr) <= 1e-4
        near += int(close.sum())
        flipped = (g > thr) != (c > thr)
        if (flipped & ~close).any():
            raise AssertionError(f"range {ri}: {int((flipped & ~close).sum())} mask pixels "
                                 "differ from the CPU away from the threshold")
        flips += [(ri, *map(int, ix), float(c[tuple(ix)]), float(g[tuple(ix)]))
                  for ix in np.argwhere(flipped)]
    log(f"[9] prefix {QUERY_PREFIX} frames a range, card vs CPU: probabilities max abs "
        f"diff {err:.3g}, {near} pixels within 1e-4 of {thr}, {len(flips)} flipped")
    for f in flips:
        log(f"[9] flipped: range {f[0]} window {f[1]} pixel ({f[2]}, {f[3]}): "
            f"CPU {f[4]!r}, card {f[5]!r}")
    for name in CSVS:
        a = (tmp / "q9_cuda" / f"{name}.csv").read_text().splitlines()
        b = (tmp / "q9_cpu" / f"{name}.csv").read_text().splitlines()
        if a == b:
            continue
        if not flips:
            raise AssertionError(f"{name}.csv: card replay differs from the CPU replay")
        row = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))
        log(f"[9] {name}.csv differs after a near-threshold flip, first at row {row}: "
            f"card {a[row] if row < len(a) else None!r}, CPU {b[row] if row < len(b) else None!r}")
    if reps["cuda"] != reps["cpu"] and not flips:
        raise AssertionError(f"prefix report: card {reps['cuda']} != CPU {reps['cpu']}")
    log(f"[9] the four CSVs of the card's replay equal the CPU's byte for byte: "
        f"{all((tmp / 'q9_cuda' / f'{n}.csv').read_bytes() == (tmp / 'q9_cpu' / f'{n}.csv').read_bytes() for n in CSVS)}; "
        f"prefix report {_query_line(reps['cuda'])}")


def phase9_query(tmp: pathlib.Path) -> None:
    """The query layer on the card: the synth scene's report from the
    committed render (cova_tpu_torch/data/synth_1800.mp4) and its
    ground truth (golden/synth/dnn_gt.csv) through the sweep harness:
    entropy decode on the host, BlobNet's probabilities on the card, the
    host replay of CC, SORT, the selector and the aggregator, then the
    BP/GC metrics. In-domain (blobnet_synth.npz) and zero-shot
    (blobnet_demo.npz) rows equal to the float32 reference on this render
    (SYNTH_REFERENCE); each printed beside the committed TPU report and
    its bands; then the prefix check against the CPU."""
    import numpy as np
    import torch

    from cova_tpu_torch.codec import Mp4Demuxer
    from cova_tpu_torch.examples.reproduce_synth import DEMO_WEIGHTS, SYNTH_WEIGHTS, synth_cfg
    from cova_tpu_torch.examples.sweep_accuracy import SYNTH_GT, SweepContext
    from cova_tpu_torch.models.blobnet import load_artifact, load_meta_npz
    from cova_tpu_torch.pipeline.compressed import compressed_probs_step

    t0 = time.perf_counter()
    ctx = SweepContext(SYNTH_RENDER, gt_csv=SYNTH_GT, dataset="synth", device="cuda")
    ctx_s = time.perf_counter() - t0
    demux = Mp4Demuxer(str(SYNTH_RENDER))
    t0 = time.perf_counter()
    ctx._signed_metadata = ctx._decode_metadata(demux, signed_mv=True)
    decode_s = time.perf_counter() - t0
    demux.close()
    frames = sum(c for _, c in ctx.bounds)
    log(f"[9] SweepContext on {SYNTH_RENDER.name}: {frames} frames, {ctx.mb_w}x{ctx.mb_h} "
        f"MBs, ranges {ctx.bounds}, {ctx_s:.3f} s (entropy decode, GT read twice); "
        f"entropy decode of the signed-MV metadata alone {decode_s:.3f} s "
        f"({frames / decode_s:.1f} frames/s)")

    ref = json.loads(SYNTH_REFERENCE.read_text())
    tpu = json.loads((REPO / "golden" / "synth" / "report.json").read_text())
    reps = {}
    for tag, weights, want, tpu_row in (
        ("cova", SYNTH_WEIGHTS, ref, tpu),
        ("cova_zeroshot", DEMO_WEIGHTS, ref["zeroshot_demo_weights"],
         tpu["zeroshot_demo_weights"]),
    ):
        cfg = synth_cfg(load_meta_npz(weights))
        kw = dict(use_nnz=cfg.compressed.use_nnz_channel, signed_mv=cfg.compressed.signed_mv,
                  cache=False)
        ctx.probs(weights, **kw)  # cuDNN's plans
        ctx._probs_cache.clear()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        probs = ctx.probs(weights, **kw)
        b.record()
        b.synchronize()
        probs_ms = a.elapsed_time(b)
        windows = sum(len(p) for p in probs)
        # One production chunk (R=4, F=128, T=4) of the clip on the card.
        nch = 4 if kw["use_nnz"] else 3
        chunk = torch.from_numpy(np.stack(
            [m[:131, ..., :nch] for m in ctx.metadata_for(kw["signed_mv"])])).cuda()
        model, _, _ = load_artifact(weights, "cuda")
        step_ms = cuda_ms(lambda: compressed_probs_step(model, cfg, chunk))
        t0 = time.perf_counter()
        rep = ctx.run_config(probs, cfg, out_dir=str(tmp / f"q9_{tag}"))
        replay_s = time.perf_counter() - t0
        reps[tag] = rep
        log(f"[9] {tag} ({weights.name}): probabilities for {windows} windows in "
            f"{probs_ms:.3f} ms between CUDA events ({windows / probs_ms * 1e3:.1f} frames/s; "
            f"host chunk assembly and copies included); the device step alone "
            f"{step_ms:.3f} ms a chunk of R=4 x F=128 ({512 / step_ms * 1e3:.1f} frames/s); "
            f"host replay {replay_s:.3f} s")
        log(f"[9] {tag} on the card:        {_query_line(rep)}")
        log(f"[9] {tag} float32 reference:  {_query_line(want)}")
        log(f"[9] {tag} TPU golden (full pipeline on a TPU, another render): "
            f"{_query_line(tpu_row)}")
        diff = {k: (rep[k], want[k]) for k in want if k in rep and rep[k] != want[k]}
        if diff:
            raise AssertionError(f"{tag}: the card's report differs from the reference: {diff}")
    r = reps["cova"]
    verdicts = [f"{k} {r[k]} {op} {bound}: "
                + ("held" if (r[k] >= bound if op == ">=" else r[k] <= bound) else "MISSED")
                for k, bound, op in TPU_BANDS]
    z = reps["cova_zeroshot"]
    verdicts.append(f"zero-shot BP {z['bp_accuracy']} <= {r['bp_accuracy']} - 0.15: "
                    + ("held" if z["bp_accuracy"] <= r["bp_accuracy"] - 0.15 else "MISSED"))
    verdicts.append(f"zero-shot GC {z['gc_error']} >= 1.5 x {r['gc_error']}: "
                    + ("held" if z["gc_error"] >= 1.5 * r["gc_error"] else "MISSED"))
    log("[9] the TPU report's bands on this render (the float32 reference misses the "
        "same ones): " + "; ".join(verdicts))
    _query_prefix(tmp)


# Phase 10's cut of the profile's defaults (R=8, F=128, pipelined runs
# of 8 chunks, three times): one pipelined run of 2 chunks. The chunk is
# the CLI's F=128, 5 runs a probe.
PROFILE_F = 128
PROFILE_REPS = 5
PROFILE_PIPELINED_CHUNKS = 2
PROFILE_FRONT_REPS = 20


def phase10_profile() -> int:
    """The all-device split of one chunk of the committed synth render
    (examples/profile_device.py: R=8, F=PROFILE_F, PROFILE_REPS) with K1, then
    the masks, +labels and +stats probes with the plain labelling on the
    card; every probe's scalar equal to the same probe on the CPU on the
    same chunk. Returns the launches of K1 and K7 in the profile's run."""
    import torch

    from cova_tpu_torch.examples.profile_device import (
        DEMO_WEIGHTS,
        PROBES,
        SYNTH_RENDER,
        load_chunk,
        make_probes,
        profile,
        profile_cfg,
    )
    from cova_tpu_torch.models.blobnet import load_artifact
    from cova_tpu_torch.ops.cuda.cc_kernel import connected_components

    def plog(line):
        log(f"[10] {line}")

    _launches(reset=True)
    res = profile(device="cuda", reps=PROFILE_REPS, cc_backend="cuda", batch_frames=PROFILE_F,
                  pipelined_chunks=PROFILE_PIPELINED_CHUNKS, pipelined_runs=1, log=plog)
    torch.cuda.synchronize()
    counts = _launches()
    launches = counts["cc_label"]
    if launches == 0 or counts["sort_scan"] == 0:
        raise AssertionError(f"the profile with --cc-backend cuda launched {counts}: K1 and "
                             "K7 must run")
    # The masks, +labels and +stats probes again, with K1 and with the
    # plain labelling, PROFILE_FRONT_REPS times each: one run's host-clock
    # delta of a labelling that takes well under a millisecond is noise.
    k1 = profile(device="cuda", reps=PROFILE_FRONT_REPS, cc_backend="cuda",
                 batch_frames=PROFILE_F, sort=False, log=plog)
    connected_components.launches = 0
    plain = profile(device="cuda", reps=PROFILE_FRONT_REPS, cc_backend="plain",
                    batch_frames=PROFILE_F, sort=False, log=plog)
    torch.cuda.synchronize()
    if connected_components.launches:
        raise AssertionError(f"the plain labelling launched K1 {connected_components.launches} times")

    model, _, meta = load_artifact(DEMO_WEIGHTS, "cpu")
    cfg = profile_cfg(meta, PROFILE_F)
    probes = make_probes(model, cfg, torch.from_numpy(load_chunk(SYNTH_RENDER, cfg)), "auto")
    from cova_tpu_torch.ops.assignment import solve_assignment_overflow as auction

    t0, rounds0 = time.perf_counter(), auction.rounds
    cpu = {name: probes[name]().item() for name in PROBES}
    rounds = auction.rounds - rounds0
    log(f"[10] the probes on the CPU ({time.perf_counter() - t0:.3f} s): {cpu}; the +sort "
        f"probe's auction {rounds} rounds ({rounds / (8 * PROFILE_F):.2f} a lane and window)")
    log(f"[10] the probes on the card, K1: {res['values']}; plain labelling: {plain['values']}")
    for name in PROBES:
        for label, values in (("K1", res["values"]), ("K1", k1["values"]),
                              ("plain", plain["values"])):
            if name in values and values[name] != cpu[name]:
                raise AssertionError(f"probe {name} ({label}): card {values[name]} != CPU {cpu[name]}")
    s = res["seconds"]
    log(f"[10] all-device split, R=8 F={PROFILE_F} 45x80, medians of {PROFILE_REPS} (seconds): "
        f"{json.dumps(res['report']['deltas'])} (unrounded: {json.dumps(s)}); the SORT scan is "
        f"{(s['+sort'] - s['+stats']) / s['+sort']:.4f} of the chunk's device program (+sort); "
        f"+sort starts from the fresh SORT state each time and full+pull carries its state, as "
        f"in the JAX profile, so their difference is not the transfer's cost alone; pipelined "
        f"{res['pipelined_fps']:.1f} frames/s; K1 launches {launches}, K7 launches "
        f"{counts['sort_scan']}")
    for label, r_ in (("K1", k1), ("plain", plain)):
        s = r_["seconds"]
        log(f"[10] medians of {PROFILE_FRONT_REPS}, {label}: masks {s['masks'] * 1e3:.4f} ms, "
            f"labelling {(s['+labels'] - s['masks']) * 1e3:.4f} ms, stats "
            f"{(s['+stats'] - s['+labels']) * 1e3:.4f} ms inside the program")
    return launches, counts["sort_scan"]


SOAK_REPS = 10


def phase11_soak(tmp: pathlib.Path) -> None:
    """examples/soak.py on the card: the committed synth render looped
    SOAK_REPS times, 8 ranges, last="full" (the selected frames decoded on
    the card by K8-K10, the stand-in oracle); RSS growth within the soak's
    budget."""
    import os

    import torch

    from cova_tpu_torch.codec import Mp4Demuxer
    from cova_tpu_torch.examples.soak import RSS_BUDGET_MB, soak

    budget = float(os.environ.get("SOAK_RSS_BUDGET_MB", RSS_BUDGET_MB))
    torch.cuda.reset_peak_memory_stats()
    _launches(reset=True)
    stage = {}
    report = soak(SOAK_REPS, tmp / "soak", SYNTH_RENDER, "cuda", stage)
    launches = _launches()
    log(f"[11] peak device memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB "
        "(torch.cuda.max_memory_allocated over the soak)")
    log(f"[11] soak report: {json.dumps(report)}; its pixel stage: {json.dumps(stage)}")
    frames = SOAK_REPS * Mp4Demuxer(str(SYNTH_RENDER)).num_samples
    if report["frames"] != frames:
        raise AssertionError(f"soak ran {report['frames']} frames, not {frames}")
    if report["rss_growth_mb"] > budget:
        raise AssertionError(f"soak RSS grew {report['rss_growth_mb']} MB (budget {budget})")
    if not launches["h264_deblock"]:
        raise AssertionError(f"the soak's pixel stage launched no K10 ({launches})")
    log(f"[11] the pixel stage on the card: launches {launches}")


# The data-parallel rehearsal: DP_STEPS Adam steps on global batches of
# DP_BATCH windows, two ranks sharing cuda:0, against the one-device steps
# on the global batch, with tests/test_torch_dp_train.py's tolerances: the
# first step's outputs within 1e-5 and gradients within 2e-6, the
# parameters after it within 1e-5 but where the gradient lies at
# rounding-noise level (at most DP_NOISE_GRAD; Adam turns the noise into a
# step of up to lr either way: within 2 x lr), the statistics within 1e-5,
# its loss within 1e-4, precision and recall within 1e-6; after the last step
# the ranks' parameters equal. At full width a few thousand weights besides
# the ConvTranspose biases have such gradients, and their moves make the
# two runs different models from the second step on (three steps in, their
# parameters differed by up to 1.3e-3 on the card, and precision by 4e-5),
# so the later steps are printed, not held, as phase 8 replays each card
# step on the CPU from the card's state rather than comparing runs.
DP_WORLD = 2
DP_BATCH = 4
DP_STEPS = 3
DP_LR = 1e-3
# Ten times the largest difference of a first-step gradient between two
# ranks and one device on an H100 (1.07e-6 at full width).
DP_NOISE_GRAD = 1e-5


def _dp_batches():
    """DP_STEPS seeded global batches of raw windows (T=4, 45x80, C=4,
    signed MVs offset 128) with labels that follow the newest frame's
    mb_class."""
    import numpy as np

    rng = np.random.default_rng(SEED + 12)
    out = []
    for _ in range(DP_STEPS):
        x = rng.integers(0, 7, size=(DP_BATCH, 4, 45, 80, 4)).astype(np.float32)
        x[..., 1:3] = rng.integers(121, 136, size=(DP_BATCH, 4, 45, 80, 2))
        out.append((x, (x[:, 0, :, :, 0] >= 4).astype(np.float32)))
    return out


def _dp_init():
    """Full-width BlobNet (C=4, dropout 0) from a seeded init:
    (config, state_dict)."""
    import dataclasses as dc

    import torch

    from cova_tpu_torch.models.blobnet import BlobNetConfig, create_blobnet

    config = dc.replace(BlobNetConfig(in_channels=4), dropout=0.0)
    _, sd = create_blobnet(torch.Generator().manual_seed(SEED), config, "cpu")
    return config, sd


def _dp_rehearsal():
    """The data-parallel train steps of two gloo ranks sharing cuda:0
    (gloo all-reduces CUDA tensors through the host). Returns the ranks'
    results; a failure of either rank fails the phase."""
    from cova_tpu_torch.graft_entry import data_parallel_steps
    from cova_tpu_torch.parallel.mesh import run_ranks

    config, sd = _dp_init()
    args = ("cuda:0", config, {k: v.numpy() for k, v in sd.items()}, _dp_batches(), DP_LR, True)
    return run_ranks(data_parallel_steps, DP_WORLD, "gloo", args=args)


def _dp_check(ranks) -> str:
    """The ranks' steps against the one-device steps on the global batch
    on the card (the tolerances above). Returns the log line."""
    import numpy as np

    from cova_tpu_torch.models.blobnet import BlobNet
    from cova_tpu_torch.models.train_blobnet import make_adam, make_train_step

    config, sd = _dp_init()
    single = BlobNet(config)
    single.load_state_dict(sd)
    single.to("cuda")
    outs = []
    single.register_forward_hook(lambda m, i, o: outs.append(o.detach().cpu().numpy()))
    step = make_train_step(single, make_adam(single, DP_LR), True)
    metrics = []
    for i, batch in enumerate(_dp_batches()):
        metrics.append({k: float(v) for k, v in step(batch).items()})
        if i == 0:
            grads = {n: p.grad.cpu().numpy().copy() for n, p in single.named_parameters()}
            first = {k: v.cpu().numpy().copy() for k, v in single.state_dict().items()}
    got = ranks[0]["first"]
    out_err = float(np.abs(np.concatenate([r["first"]["out"] for r in ranks]) - outs[0]).max())
    grad_err = max(float(np.abs(got["grads"][n] - g).max()) for n, g in grads.items())
    if not (out_err <= 1e-5 and grad_err <= 2e-6):
        raise AssertionError(f"DP first step: outputs {out_err}, gradients {grad_err} "
                             "from the one-device step")
    worst, n_noisy = {}, 0
    for name, v in first.items():
        if name.endswith("num_batches_tracked"):
            continue
        diff = np.abs(got["state"][name] - v)
        quiet = np.abs(grads[name]) <= DP_NOISE_GRAD if name in grads else np.zeros_like(diff, bool)
        n_noisy += int(quiet.sum())
        worst[name] = float(diff[~quiet].max(initial=0.0))
        if not (diff <= np.where(quiet, 2 * DP_LR * 1.01, 1e-5)).all():
            raise AssertionError(f"DP first step {name}: {float(diff.max())} from one device")
    got_m, want = ranks[0]["metrics"][0], metrics[0]
    if not (abs(got_m["loss"] - want["loss"]) <= 1e-4
            and all(abs(got_m[k] - want[k]) <= 1e-6 for k in ("precision", "recall"))):
        raise AssertionError(f"DP first step metrics {got_m} != one device's {want}")
    if len(ranks) != DP_WORLD or any(
            not np.array_equal(ranks[0]["state"][k], r["state"][k])
            for r in ranks[1:] for k in ranks[0]["state"]):
        raise AssertionError("the ranks' parameters differ")
    top = max(worst, key=worst.get)
    return (f"(b) data-parallel step, {DP_WORLD} ranks over gloo on cuda:0, full width, "
            f"{DP_STEPS} Adam steps of a global batch of {DP_BATCH}: first step outputs within "
            f"{out_err:.3g}, gradients within {grad_err:.3g}, state after it within "
            f"{worst[top]:.3g} ({top}) off {n_noisy} noise-level weights; the ranks equal "
            f"after the last step; losses "
            f"{[m['loss'] for m in ranks[0]['metrics']]} against one device's "
            f"{[m['loss'] for m in metrics]}; precision and recall "
            f"{[(m['precision'], m['recall']) for m in ranks[0]['metrics']]}, one device's "
            f"{[(m['precision'], m['recall']) for m in metrics]}")


def phase12_multi_device() -> int:
    """Multi-device on the one card: (a) the sharded masks step (R=8,
    F=128) and the sharded all-device stage (F=128) over the mesh
    [cuda:0, cuda:0], bit for bit equal to the one-device stage, with the
    ratio of their times; (b) the data-parallel train step at full width,
    two ranks on cuda:0, against the one-device step on the global batch;
    (c) dryrun_multichip on the card. (b) and (c) run in their own
    processes, side by side, after (a). Returns the launches of K1 and K7
    in the sharded stage's runs."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    from cova_tpu_torch.examples.profile_device import load_chunk, profile_cfg
    from cova_tpu_torch.graft_entry import dryrun_multichip
    from cova_tpu_torch.models.blobnet import load_artifact
    from cova_tpu_torch.parallel.mesh import make_mesh
    from cova_tpu_torch.pipeline.compressed import CompressedStage

    # (a) two shards on one card.
    dev = torch.device("cuda")
    model, _, meta = load_artifact(REPO / "artifacts" / "blobnet_demo.npz", dev)
    mesh = make_mesh(devices=["cuda:0", "cuda:0"])
    cfg = profile_cfg(meta)
    chunk = load_chunk(SYNTH_RENDER, cfg)
    one, two = CompressedStage(model, cfg, 8, dev), CompressedStage(model, cfg, 8, dev, mesh)
    a, b = one.run_chunk_masks(chunk).cpu(), two.run_chunk_masks(chunk).cpu()
    if not torch.equal(a, b):
        raise AssertionError(f"sharded masks step: {int((a != b).sum())} of {a.numel()} "
                             "bytes differ from one device")
    log(f"[12] (a) masks step R=8 F={cfg.compressed.batch_frames} over {len(mesh.devices)} "
        f"shards on cuda:0: {a.numel()} bytes equal to one device's")
    # Two chunks, the second on the carried SORT state; the second
    # round's times are the warm ones. Each run's time to return from
    # run_chunk (the host issuing the work) is read beside its time to the
    # outputs on the host.
    f = cfg.compressed.batch_frames
    counts, times = {}, []
    for k in range(2):
        ts0 = np.full(8, cfg.video.timestep - 1 + k * f * cfg.compressed.gamma, np.int32)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = one.run_chunk(chunk, ts0)
        i_one = time.perf_counter() - t0
        ref = [x.cpu() for x in out[:2]]
        t_one = time.perf_counter() - t0
        _launches(reset=True)
        t0 = time.perf_counter()
        out = two.run_chunk(chunk, ts0)
        i_two = time.perf_counter() - t0
        got = [x.cpu() for x in out[:2]]
        times.append((t_one, time.perf_counter() - t0, i_one, i_two))
        for name, n in _launches().items():
            counts[name] = counts.get(name, 0) + n
        for name, g, r in zip(("packed", "masks"), got, ref):
            if not torch.equal(g, r):
                raise AssertionError(f"sharded stage chunk {k} {name}: "
                                     f"{int((g != r).sum())} elements differ from one device")
    launches = counts["cc_label"]
    if launches != 2 * mesh.size or counts["sort_scan"] != 2 * mesh.size:
        raise AssertionError(f"{counts} launches for 2 chunks of {mesh.size} shards: K1 and K7 "
                             "must run once a shard and chunk")
    t_one, t_two, i_one, i_two = times[1]
    log(f"[12] (a) all-device stage R=8 F={f} over 2 shards on cuda:0, two chunks (the "
        f"second on the carried SORT state): packed {tuple(got[0].shape)} and masks equal to "
        f"one device's, bit for bit; K1 launches {launches}, K7 launches "
        f"{counts['sort_scan']}; seconds a chunk to the outputs on the host, one device then "
        f"two shards: {[[round(x[0], 4), round(x[1], 4)] for x in times]}; warm, two shards "
        f"take {t_two / t_one:.3f} of one device's time; the host returned from run_chunk "
        f"after {i_one:.4f} s (one device) and {i_two:.4f} s (two shards): it issues the "
        f"blocks without waiting on the card")

    # (b) and (c) in their own processes, after (a)'s timed runs.
    with ThreadPoolExecutor(2) as pool:
        dp = pool.submit(_dp_rehearsal)
        dry = pool.submit(dryrun_multichip, torch.cuda.device_count(), "cuda")

        # (b) the data-parallel step against one device on the global batch.
        log(f"[12] {_dp_check(dp.result())}")

        # (c) the dry run.
        log(f"[12] (c) {dry.result()}")
    return launches, counts["sort_scan"]


SYNTH_RENDER_1080P = REPO / "cova_tpu_torch" / "data" / "synth_1800_1080p.mp4"
# The bench's passes over each render and rounds a device-only pass (its
# CLI's defaults).
BENCH_PASSES = 5
BENCH_DEVICE_REPS = 4


def _launches(reset: bool = False) -> dict:
    """The kernels' launch counts; `reset` sets them to 0 after."""
    from cova_tpu_torch.ops.cuda.blob_stage import blob_stage
    from cova_tpu_torch.ops.cuda.blob_up import blob_up
    from cova_tpu_torch.ops.cuda.cc_kernel import connected_components
    from cova_tpu_torch.ops.cuda.mog2_kernel import mog2_chunk
    from cova_tpu_torch.ops.cuda.nms_kernel import nms
    from cova_tpu_torch.ops.cuda.sort_kernel import sort_scan

    from cova_tpu_torch.ops.cuda import h264_kernels as K

    wrappers = {"cc_label": connected_components, "nms": nms, "mog2": mog2_chunk,
                "sort_scan": sort_scan, "h264_inter": K.h264_inter,
                "h264_intra": K.h264_intra, "h264_deblock": K.h264_deblock,
                "blob_stage": blob_stage, "blob_up": blob_up}
    counts = {name: w.launches for name, w in wrappers.items()}
    if reset:
        for w in wrappers.values():
            w.launches = 0
    return counts


def _windows(video, nr: int, t: int) -> int:
    """Windows of `video` split into `nr` GoP-aligned ranges, from the
    demuxer's GoP table: the sum over ranges of max(0, samples - t + 1)."""
    import math

    from cova_tpu_torch.codec import Mp4Demuxer

    d = Mp4Demuxer(str(video))
    sizes = [g.num_samples for g in d.gops()]
    d.close()
    per = max(1, math.ceil(len(sizes) / nr))
    return sum(max(0, sum(sizes[i : i + per]) - t + 1) for i in range(0, len(sizes), per))


def phase13_bench() -> None:
    """cova_tpu_torch.bench on the card on both committed renders: the
    first chunk's packed masks against the port on the CPU, then the
    passes (one JSON line each render); platform cuda, frames a pass
    equal to the demuxer's windows, K4 and K12 the only kernels launched."""
    import os

    import numpy as np

    from cova_tpu_torch import bench
    from cova_tpu_torch.models.blobnet import load_artifact
    from cova_tpu_torch.pipeline.compressed import CompressedStage

    log(f"[13] host: {os.cpu_count()} CPU cores; the bench decodes with "
        f"{min(os.cpu_count() or 8, 16)} threads, and process CPU time sums over them")
    model_cpu = load_artifact(bench.WEIGHTS, "cpu")[0]
    for video in (SYNTH_RENDER, SYNTH_RENDER_1080P):
        t0 = time.perf_counter()
        b = bench.setup(video, "cuda")
        try:
            r, t = b.stage.num_ranges, b.cfg.video.timestep
            chunk = bench.fresh_chunk(b, r)
            bench.fill_chunk(b, chunk.numpy(), [0] * r, 0, b.plan)
            got = b.stage.run_chunk_masks(bench.upload(b, chunk)).cpu().numpy()
            ref = CompressedStage(model_cpu, b.cfg, r, "cpu").run_chunk_masks(
                chunk.clone()).numpy()
            if not np.array_equal(got, ref):
                raise AssertionError(f"{video.name}: the first chunk's packed masks differ "
                                     f"from the CPU's in {int((got != ref).sum())} bytes")
            log(f"[13] {video.name}: first chunk R={r} F={b.cfg.compressed.batch_frames} "
                f"{b.demux.mb_height}x{b.demux.mb_width}, {got.size} packed bytes equal to the "
                f"CPU's; set-up and check {time.perf_counter() - t0:.1f} s")
            _launches(reset=True)
            out = bench.run(b, BENCH_PASSES, BENCH_DEVICE_REPS)
            launches = _launches()
        finally:
            b.demux.close()
        log(f"[13] bench {video.name}: {json.dumps(out)}")
        windows = _windows(video, r, t)
        if out["platform"] != "cuda" or out["frames_per_pass"] != windows:
            raise AssertionError(f"{video.name}: platform {out['platform']}, frames a pass "
                                 f"{out['frames_per_pass']} (the demuxer's windows: {windows})")
        others = {k: n for k, n in launches.items() if k not in ("blob_stage", "blob_up")}
        if any(others.values()) or launches["blob_up"] != launches["blob_stage"] or \
                not launches["blob_stage"]:
            raise AssertionError(f"the bench launched {launches}: its path runs K4 and K12 "
                                 "alone, as often")
        log(f"[13] {video.name}: compressed_domain_fps {out['value']} (CPU time), wall_fps "
            f"{out['wall_fps']}, device_fps {out['device_fps']}, frames a pass {windows} "
            f"(the demuxer's windows), kernel launches {launches}")


def phase14_1080p(tmp: pathlib.Path) -> int:
    """reproduce_1080p's CovaPipeline configuration (4 ranges,
    blobnet_demo1080.npz, cc 7, mask 0.6, the tracker's defaults) with
    last="select" on the whole 1080p render, on the card and on the CPU:
    the four CSVs byte-identical; K4 and K12 the only kernels, four
    launches each a chunk. Returns their launches."""
    from cova_tpu_torch.codec import Mp4Demuxer
    from cova_tpu_torch.examples.reproduce_1080p import WEIGHTS_1080P, operating_point
    from cova_tpu_torch.models.blobnet import load_artifact

    _, sd, meta = load_artifact(WEIGHTS_1080P, "cpu")
    cfg = operating_point(meta, last="select")
    samples = Mp4Demuxer(str(SYNTH_RENDER_1080P)).num_samples
    res, launches, n_chunks = _run_pipeline("14", SYNTH_RENDER_1080P, tmp / "out14", cfg, sd,
                                            "cuda", samples)
    cpu, _, _ = _run_pipeline("14", SYNTH_RENDER_1080P, tmp / "out14cpu", cfg, sd, "cpu",
                              samples)
    _same_csvs("14", tmp / "out14", tmp / "out14cpu", res, cpu)
    others = {k: n for k, n in launches.items() if k not in ("blob_stage", "blob_up")}
    if any(others.values()) or not launches["blob_stage"] == launches["blob_up"] == 4 * n_chunks:
        raise AssertionError(f"the 1080p pipeline launched {launches} for {n_chunks} chunks: "
                             "its path runs K4 and K12 alone, four launches each a chunk")
    log(f"[14] the four CSVs of the card run equal the CPU run's, byte for byte, over all "
        f"{samples} frames; kernel launches {launches}")
    return launches


# --- phase 15: the pixel decoder (K8-K10) ------------------------------------
PIXDEC_STREAMS = REPO / "cova_tpu_torch" / "data" / "h264"
PIXDEC_HASHES = REPO / "cova_tpu_torch" / "data" / "pixdec_hashes.json"
PIXDEC_CSVS = REPO / "cova_tpu_torch" / "data" / "pixdec_full_csvs.json"
H264 = ("h264_inter", "h264_intra", "h264_deblock")
# Pictures of the 720p render's first GoP on which each kernel is timed
# against its plain version (on the host's CPU) and the launch alone.
PIXDEC_TIMED = 4
# examples/reproduce_synth.py's operating point.
SYNTH_CC, SYNTH_MASK, SYNTH_MIN_HITS, SYNTH_MAX_AGE, SYNTH_BUS_AREA = 2, 0.6, 40, 45, 2500


def _h264_plain():
    from cova_tpu_torch.ops.h264 import deblock, inter, intra

    return {"h264_inter": inter.reconstruct_inter, "h264_intra": intra.reconstruct_intra,
            "h264_deblock": deblock.deblock}


def _pic_to(pic, device):
    import dataclasses

    import torch

    return dataclasses.replace(pic, **{
        f.name: getattr(pic, f.name).to(device) for f in dataclasses.fields(pic)
        if isinstance(getattr(pic, f.name), torch.Tensor)})


def _union_bytes(shape, x0, x1, y0, y1) -> int:
    """Samples of a (H, W) plane inside the union of the rectangles
    [y0, y1) x [x0, x1) (clamped to the plane), by a difference array."""
    import numpy as np

    h, w = shape
    x0, x1 = np.clip(x0, 0, w), np.clip(x1, 0, w)
    y0, y1 = np.clip(y0, 0, h), np.clip(y1, 0, h)
    diff = np.zeros((h + 1, w + 1), np.int32)
    for ys, xs, v in ((y0, x0, 1), (y0, x1, -1), (y1, x0, -1), (y1, x1, 1)):
        np.add.at(diff, (ys, xs), v)
    return int((diff.cumsum(0).cumsum(1)[:h, :w] > 0).sum())


def _ref_bytes(pic, sel) -> int:
    """Reference samples the inter macroblocks `sel` read: in each
    reference picture, the union of their cells' windows (4x4 luma, two
    2x2 chroma; the 6-tap margins, -2/+3, only along a fractional MV
    component, one more chroma sample for a fractional one), clamped to
    the picture as prediction clamps them."""
    import numpy as np

    from cova_tpu_torch.ops.h264 import deblock

    pics, mvs = (t.cpu().numpy() for t in deblock._cell_motion(pic))
    idx = np.nonzero(sel)[0]
    k = np.arange(16)
    x = (idx[:, None] % pic.mb_w) * 16 + (k % 4) * 4
    y = (idx[:, None] // pic.mb_w) * 16 + (k // 4) * 4
    luma, chroma = (pic.height, pic.width), (pic.height // 2, pic.width // 2)
    total = 0
    for lx in range(2):
        slot, mvx, mvy = pics[idx][..., lx], mvs[idx][..., lx, 0], mvs[idx][..., lx, 1]
        for s in np.unique(slot[slot >= 0]):
            m = slot == s
            fx, fy = (mvx[m] & 3) != 0, (mvy[m] & 3) != 0
            lx0, ly0 = x[m] + (mvx[m] >> 2), y[m] + (mvy[m] >> 2)
            total += _union_bytes(luma, lx0 - 2 * fx, lx0 + 4 + 3 * fx,
                                  ly0 - 2 * fy, ly0 + 4 + 3 * fy)
            cx0, cy0 = x[m] // 2 + (mvx[m] >> 3), y[m] // 2 + (mvy[m] >> 3)
            total += 2 * _union_bytes(chroma, cx0, cx0 + 2 + ((mvx[m] & 7) != 0),
                                      cy0, cy0 + 2 + ((mvy[m] & 7) != 0))
    return total


def _neighbour_bytes(pic, intra) -> int:
    """Samples the intra macroblocks read from inter ones (K8's output,
    K9's input): the left column and top row (16 luma, 8 + 8 chroma), the
    corner (1 + 2) and, for Intra4x4/8x8, the 8 luma samples above and
    to the right, where that neighbour lies in the same slice."""
    import numpy as np

    from cova_tpu_torch.ops.h264 import transform as tf

    mb = pic.mb.cpu().numpy()
    mw = pic.mb_w
    sl = mb[:, 1]
    nxn = intra & ((mb[:, 0] & (tf.F_I16 | tf.F_PCM)) == 0)
    total = 0
    idx = np.nonzero(intra & ((mb[:, 0] & tf.F_PCM) == 0))[0]
    mx, my = idx % mw, idx // mw
    for dx, dy, nbytes, need in ((-1, 0, 32, None), (0, -1, 32, None), (-1, -1, 3, None),
                                 (1, -1, 8, nxn)):
        ok = (mx + dx >= 0) & (mx + dx < mw) & (my + dy >= 0)
        nb = np.where(ok, idx + dx + dy * mw, 0)
        ok &= (sl[nb] == sl[idx]) & ~intra[nb]
        if need is not None:
            ok &= need[idx]
        total += nbytes * int(ok.sum())
    return total


def _edge_bytes(pic) -> int:
    """Samples within the support of the edges K10 filters (bS > 0): p2..q2
    across a luma edge (p3..q3 at bS 4), p1..q1 across a chroma edge, along
    each 4-sample segment (2 in chroma)."""
    import numpy as np

    from cova_tpu_torch.ops.h264 import deblock

    bs = deblock.boundary_strength(pic).cpu().numpy()
    m, d, e, k = np.nonzero(bs)
    b = bs[m, d, e, k]
    X, Y = (m % pic.mb_w) * 16, (m // pic.mb_w) * 16
    t = np.where(b == 4, 4, 3)
    v = d == 0
    ex, ey = np.where(v, X + 4 * e, X + 4 * k), np.where(v, Y + 4 * k, Y + 4 * e)
    total = _union_bytes((pic.height, pic.width),
                         np.where(v, ex - t, ex), np.where(v, ex + t, ex + 4),
                         np.where(v, ey, ey - t), np.where(v, ey + 4, ey + t))
    c = e % 2 == 0
    cv, cb, ce, ck = v[c], d[c], e[c] // 2, k[c]
    cX, cY = X[c] // 2, Y[c] // 2
    cx = np.where(cv, cX + 4 * ce, cX + 2 * ck)
    cy = np.where(cv, cY + 2 * ck, cY + 4 * ce)
    total += 2 * _union_bytes((pic.height // 2, pic.width // 2),
                              np.where(cv, cx - 2, cx), np.where(cv, cx + 2, cx + 2),
                              np.where(cv, cy, cy - 2), np.where(cv, cy + 2, cy + 2))
    return total


def _h264_bytes(name, pic, before, after) -> int:
    """Bytes kernel `name` must move for `pic`, each input read once and
    each output written once, counted from this picture's data. Syntax as
    the host decoder hands it over, for the macroblocks the kernel covers:
    8 int32 a macroblock, 16 cells of 6 int16 (K8, K10), 16 int8 intra
    modes (K9), each nonzero level as an int32 slot and an int16 value,
    the I_PCM samples (K9) and the slice records. Samples: K8 writes its
    macroblocks and reads the reference windows (_ref_bytes); K9 writes
    its macroblocks and reads the inter neighbours (_neighbour_bytes);
    K10 reads the support of the edges it filters (_edge_bytes) and
    writes the samples it changes (`before` against `after`)."""
    from cova_tpu_torch.ops.h264 import transform as tf

    intra = ((pic.mb[:, 0] & tf.F_INTRA) != 0).cpu().numpy()
    nz = (pic.coef != 0).sum(1).cpu().numpy()
    slices = pic.slices.numel() * 4
    if name == "h264_inter":
        sel = ~intra
        n = int(sel.sum())
        return n * (32 + 192 + 384) + 6 * int(nz[sel].sum()) + slices + _ref_bytes(pic, sel)
    if name == "h264_intra":
        n = int(intra.sum())
        return (n * (32 + 16 + 384) + 6 * int(nz[intra].sum()) + slices
                + pic.pcm.numel() + 4 * pic.pcm_mb.numel() + _neighbour_bytes(pic, intra))
    return (intra.size * (32 + 192) + slices + _edge_bytes(pic)
            + int((before != after).sum()))


def _h264_state(name, pool, slot, pic):
    """What a raw launch of kernel `name` needs (RecArgs and the tensors
    behind them), a function that resets its flags, and the macroblocks
    it covers."""
    import torch

    from cova_tpu_torch.ops.cuda import h264_kernels as K

    inter, intra = K._flags(pic)
    if name == "h264_inter":
        lst, done, ticket = inter.nonzero().flatten().to(torch.int32), None, None
        init, n = None, int(inter.sum())
    elif name == "h264_intra":
        lst = K.wave_order(intra.nonzero().flatten(), pic.mb_w).to(torch.int32)
        init, n = (~intra).to(torch.int32), int(intra.sum())
        done, ticket = init.clone(), torch.zeros(1, dtype=torch.int32, device="cuda")
    else:
        # K10: a progress counter a macroblock row, and the row ticket.
        lst, n = None, pic.mb.shape[0]
        init = torch.zeros(pic.mb_h, dtype=torch.int32, device="cuda")
        done, ticket = init.clone(), torch.zeros(1, dtype=torch.int32, device="cuda")
    args, keep = K.launch_args(pool, slot, pic, lst, done, ticket)

    def reset():
        if init is not None:
            done.copy_(init)
            ticket.zero_()

    return args, (keep, lst, done, ticket), reset, n


def _h264_check(pool, slot, pic, stats, time_it):
    """K8, K9 and K10 on pool[slot] in turn, each REPEATS times from the
    same state, against its plain version on the CPU from that state:
    raises unless all are equal. With `time_it`, also the launch alone
    (device ms, CUDA events), the wrapper's call and the plain version."""
    import ctypes

    import torch

    from cova_tpu_torch.ops.cuda import h264_kernels as K

    plain = _h264_plain()
    cpu_pic = _pic_to(pic, "cpu")
    wrappers = {"h264_inter": K.h264_inter, "h264_intra": K.h264_intra,
                "h264_deblock": K.h264_deblock}
    for name in H264:
        start = pool[slot].clone()
        ref = pool.cpu()
        t0 = time.perf_counter()
        plain[name](ref, slot, cpu_pic)
        plain_ms = (time.perf_counter() - t0) * 1e3
        outs = []
        for _ in range(REPEATS):
            pool[slot].copy_(start)
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            wrappers[name](pool, slot, pic)
            b.record()
            b.synchronize()
            outs.append((pool[slot].clone(), a.elapsed_time(b)))
        want = ref[slot].to("cuda")
        for k, (got, _) in enumerate(outs):
            if not torch.equal(got, want):
                diff = (got.int() - want.int()).abs()
                raise AssertionError(
                    f"{name}: run {k} differs from the plain version in {int((diff > 0).sum())} "
                    f"samples (max {int(diff.max())}), picture POC {pic.poc}")
        st = stats[name]
        st["checked"] += 1
        if time_it:
            args, keep, reset, n = _h264_state(name, pool, slot, pic)
            if n:
                fn = K._lib(name)
                stream = torch.cuda.current_stream().cuda_stream
                dev = []
                for _ in range(REPEATS):
                    pool[slot].copy_(start)
                    reset()
                    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                    a.record()
                    rc = fn(ctypes.byref(args), stream)
                    b.record()
                    b.synchronize()
                    if rc != 0:
                        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
                    dev.append(a.elapsed_time(b))
                st["device_ms"].append(statistics.median(dev))
                st["ms"].append(statistics.median(ms for _, ms in outs))
                st["plain_ms"].append(plain_ms)
                st["bytes"].append(_h264_bytes(name, pic, start, outs[0][0]))
                if name == "h264_intra":
                    st["wave_ms"].append(_wave_variant(name, pool, slot, pic, start, outs[0][0]))
                    st["waves"].append(_wave_count(pic))
        pool[slot].copy_(outs[0][0])


def _wave_count(pic) -> int:
    """Waves x + 2y K9's macroblocks span: its chain of dependent steps."""
    import torch

    from cova_tpu_torch.ops.cuda import h264_kernels as K

    mbs = K._flags(pic)[1].nonzero().flatten()
    return int(torch.unique(mbs % pic.mb_w + 2 * (mbs // pic.mb_w)).numel())


def _k10_steps(mb_w, mb_h) -> tuple:
    """K10's chain where every top edge is filtered: the macroblock steps
    from the first row's first to the last row's last (a row's H of
    macroblock x waits for the row above's V of x + 1, so each row runs
    one step behind the row above), and how many of them hand over from
    one row to the next."""
    return mb_w + mb_h - 1, mb_h - 1


def _wave_variant(name, pool, slot, pic, start, want) -> float:
    """K9's alternative to one launch a picture: one launch a wave (the
    same kernel on the wave's macroblocks; every earlier wave is done, so
    no block waits). Device ms of the whole picture (CUDA events around
    the launches), REPEATS runs, each held to the one-launch result."""
    import ctypes

    import torch

    from cova_tpu_torch.ops.cuda import h264_kernels as K

    args, keep, reset, n = _h264_state(name, pool, slot, pic)
    lst, done, ticket = keep[1], keep[2], keep[3]
    wave = (lst % pic.mb_w + 2 * (lst // pic.mb_w)).cpu()
    bounds = torch.unique_consecutive(wave, return_counts=True)[1].cumsum(0).tolist()
    tickets = torch.zeros(len(bounds), dtype=torch.int32, device="cuda")
    launches, lo = [], 0
    for k, hi in enumerate(bounds):
        a, kp = K.launch_args(pool, slot, pic, lst[lo:hi], done, tickets[k:k + 1])
        launches.append((a, kp))
        lo = hi
    fn = K._lib(name)
    stream = torch.cuda.current_stream().cuda_stream
    times = []
    for _ in range(REPEATS):
        pool[slot].copy_(start)
        reset()
        tickets.zero_()
        a0, b0 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a0.record()
        for a, _ in launches:
            rc = fn(ctypes.byref(a), stream)
            if rc != 0:
                raise RuntimeError(f"{name} (a launch a wave) failed: cudaError {rc}")
        b0.record()
        b0.synchronize()
        if not torch.equal(pool[slot], want):
            raise AssertionError(f"{name}: a launch a wave differs from one launch a picture")
        times.append(a0.elapsed_time(b0))
    return statistics.median(times)


def _decode_all(path, on_picture=None, hashes=False, device="cuda"):
    """Decode every sample of `path` with the port's PixelDecoder, then
    flush, with the port's tracer on; returns (frames popped: [pts, sha Y,
    U, V] or (pts, y, u, v)), the split from the decoder's spans and
    counters: pictures, syntax_s, upload_s, pop_s (the copy out), seconds)."""
    import hashlib

    import torch

    from cova_tpu_torch import trace
    from cova_tpu_torch.codec import Mp4Demuxer, pixrec

    d = Mp4Demuxer(str(path))
    dec = pixrec.PixelDecoder(d.extradata(), device=device)
    out = []

    def drain():
        while (f := dec.pop(d.width, d.height)) is not None:
            out.append([int(f[0])] + [hashlib.sha256(p.tobytes()).hexdigest() for p in f[1:]]
                       if hashes else f)

    orig = pixrec.reconstruct
    if on_picture is not None:
        pixrec.reconstruct = on_picture
    trace.take()
    trace.enable()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(d.num_samples):
            dec.send(d.read_sample(i), d.sample(i).pts)
            drain()
        dec.flush()
        drain()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        trace.disable()
        rec = trace.take()
        pixrec.reconstruct = orig
        dec.close()
        d.close()
    stats = {"pictures": sum(c.get("pixdec.pictures", 0) for c in rec["counters"].values())}
    for key, name in (("syntax_s", "cova.pixdec.syntax"), ("upload_s", "cova.pixdec.upload"),
                      ("pop_s", "cova.pixdec.copy_out")):
        stats[key] = sum(x["end"] - x["start"] for x in rec["spans"] if x["name"] == name) / 1e9
    return out, stats, secs


def phase15a_kernels(stats) -> None:
    """Every picture of every committed small stream through K8, K9 and
    K10, each against its plain version (three runs each, bit-equal), and
    the popped frames against the same stream on the CPU decoder."""
    import numpy as np

    streams = sorted(PIXDEC_STREAMS.glob("*.mp4"))

    def checked(pool, slot, pic):
        _h264_check(pool, slot, pic, stats, False)

    for path in streams:
        t0 = time.perf_counter()
        got, _, _ = _decode_all(path, checked)
        log(f"[15a] {path.name}: {len(got)} frames, K8/K9/K10 equal to their plain versions "
            f"on every picture ({REPEATS} runs each) in {time.perf_counter() - t0:.1f} s")
    log(f"[15a] pictures checked: {json.dumps({k: v['checked'] for k, v in stats.items()})}")


def phase15b_renders(stats) -> None:
    """The card's decoder over both committed renders: every popped (pts,
    sha256 of Y, U, V) equal to the libavcodec fixture; frames/s and the
    split a picture; then the kernels timed on PIXDEC_TIMED pictures of
    each render against their plain versions."""
    import torch

    from cova_tpu_torch.codec import pixrec
    from cova_tpu_torch.ops.cuda import h264_kernels as K

    fixture = json.loads(PIXDEC_HASHES.read_text())["frames"]
    for name in ("synth_1800.mp4", "synth_1800_1080p.mp4"):
        path = REPO / "cova_tpu_torch" / "data" / name
        ev = {k: [] for k in H264}

        def timed(pool, slot, pic):
            for k, fn in (("h264_inter", K.h264_inter), ("h264_intra", K.h264_intra),
                          ("h264_deblock", K.h264_deblock)):
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                fn(pool, slot, pic)
                b.record()
                ev[k].append((a, b))

        got, st, secs = _decode_all(path, timed, hashes=True)
        want = fixture[name]
        if got != want:
            k = next((i for i, (g, w) in enumerate(zip(got, want)) if g != w), min(len(got), len(want)))
            raise AssertionError(f"{name}: frame {k} of {len(got)} differs from libavcodec's "
                                 f"({len(want)} frames in the fixture)")
        n = st["pictures"]
        split = {k: statistics.mean(a.elapsed_time(b) for a, b in v) for k, v in ev.items()}
        rec = {"frames": len(got), "seconds": secs, "fps": len(got) / secs,
               "syntax_ms": st["syntax_s"] / n * 1e3, "upload_ms": st["upload_s"] / n * 1e3,
               "pop_ms": st["pop_s"] / n * 1e3, **{f"{k}_event_ms": v for k, v in split.items()}}
        log(f"[15b] {name}: {len(got)} frames equal to libavcodec's (pts and sha256 of Y, U, V) "
            f"in {secs:.2f} s, {rec['fps']:.1f} frames/s; a picture: host syntax "
            f"{rec['syntax_ms']:.3f} ms, upload {rec['upload_ms']:.3f} ms, K8 "
            f"{split['h264_inter']:.4f} ms, K9 {split['h264_intra']:.4f} ms, K10 "
            f"{split['h264_deblock']:.4f} ms (CUDA events around each wrapper call), pop "
            f"{rec['pop_ms']:.3f} ms")
    # The kernels timed against their plain versions on the first
    # PIXDEC_TIMED pictures (decode order) of each render; the 720p
    # render's go to `stats`, the kernel table's.
    from cova_tpu_torch.codec import Mp4Demuxer

    for video, what in ((SYNTH_RENDER, "720p"), (SYNTH_RENDER_1080P, "1088-row")):
        st = stats if video == SYNTH_RENDER else _h264_stats()
        d = Mp4Demuxer(str(video))
        steps, across = _k10_steps((d.width + 15) // 16, (d.height + 15) // 16)
        dec = pixrec.PixelDecoder(d.extradata(), device="cuda")
        orig = pixrec.reconstruct
        pixrec.reconstruct = lambda pool, slot, pic: _h264_check(pool, slot, pic, st, True)
        try:
            for i in range(PIXDEC_TIMED):
                dec.send(d.read_sample(i), d.sample(i).pts)
        finally:
            pixrec.reconstruct = orig
            dec.close()
            d.close()
        for k in H264:
            s = st[k]
            log(f"[15b] {k} on {len(s['device_ms'])} pictures of the {what} render: launch "
                f"{statistics.median(s['device_ms']):.4f} ms (median; CUDA events around the "
                f"launch alone; per picture {[round(x, 4) for x in s['device_ms']]}), wrapper "
                f"call {statistics.median(s['ms']):.4f} ms, plain version on the CPU "
                f"{statistics.median(s['plain_ms']):.1f} ms, {statistics.median(s['bytes'])} bytes")
            if s["wave_ms"]:
                log(f"[15b] {k} as one launch a wave instead: "
                    f"{[round(x, 4) for x in s['wave_ms']]} ms per picture over {s['waves']} "
                    f"waves (one launch a picture: {[round(x, 4) for x in s['device_ms']]} ms), "
                    f"results equal")
        log(f"[15b] h264_deblock's chain on the {what} render: {steps} macroblock steps, "
            f"{across} of them across rows")


def _synth_cfg(meta):
    from cova_tpu_torch.config import CompressedStageConfig, CovaConfig, ParallelConfig, SortConfig

    return CovaConfig(
        parallel=ParallelConfig(num_ranges=4),
        sort=SortConfig(min_hits=SYNTH_MIN_HITS, max_age=SYNTH_MAX_AGE),
        compressed=CompressedStageConfig(
            cc_threshold=SYNTH_CC, mask_threshold=SYNTH_MASK,
            use_nnz_channel=bool(meta.get("use_nnz_channel", False)),
            signed_mv=bool(meta.get("signed_mv", False))),
        last="full")


def phase15c_full_pipeline(tmp: pathlib.Path) -> dict:
    """CovaPipeline to the end (last="full") on the card on the committed
    720p render at reproduce_synth's operating point, its
    StaticBackgroundDetector built on the card through decode_luma_halfres:
    the background and the four CSVs equal to the JAX package's run with
    libavcodec (the committed fixture). Counts K8-K10's launches over the
    run alone (the main path's) and, apart, over the background."""
    import hashlib

    import numpy as np
    import torch

    from cova_tpu_torch.models import bgdet
    from cova_tpu_torch.models.blobnet import load_artifact
    from cova_tpu_torch.pipeline.cova import CovaPipeline

    fixture = json.loads(PIXDEC_CSVS.read_text())
    _, sd, meta = load_artifact(REPO / "artifacts" / "blobnet_synth.npz", "cpu")
    _launches(reset=True)
    t0 = time.perf_counter()
    bg = bgdet.build_background(str(SYNTH_RENDER), log=lambda *_: None)
    torch.cuda.synchronize()
    t_bg = time.perf_counter() - t0
    bg_launches = _launches()
    pipe = CovaPipeline(str(SYNTH_RENDER), str(tmp / "out15c"), _synth_cfg(meta), sd,
                        detector=bgdet.StaticBackgroundDetector(bg, bus_area=SYNTH_BUS_AREA),
                        device="cuda", log=lambda *_: None)
    pipe.warmup()
    torch.cuda.synchronize()
    _launches(reset=True)
    res = pipe.run()
    torch.cuda.synchronize()
    launches = _launches()
    if hashlib.sha256(np.ascontiguousarray(bg).tobytes()).hexdigest() != fixture["background_sha256"]:
        raise AssertionError("the background built on the card differs from libavcodec's")
    got = {n: hashlib.sha256((tmp / "out15c" / f"{n}.csv").read_bytes()).hexdigest()
           for n in CSVS}
    bad = [n for n in CSVS if got[n] != fixture[n]]
    if bad or res.pixel_frames != fixture["pixel_frames"]:
        raise AssertionError(f"last=full on the card: {bad} differ from the JAX run's "
                             f"(pixel frames {res.pixel_frames}, fixture "
                             f"{fixture['pixel_frames']})")
    tm = res.timers
    log(f"[15c] background through decode_luma_halfres on the card in {t_bg:.2f} s "
        f"(1800 frames, launches {bg_launches}), equal to libavcodec's; CovaPipeline last=full {res.num_frames} frames "
        f"in {res.elapsed_seconds:.2f} s, {res.pixel_frames} frames to the oracle, the four "
        f"CSVs equal to the JAX run's; timers: entropy_decode {tm.entropy_decode:.3f} s, "
        f"device_dispatch {tm.device_dispatch:.3f} s, host_mirror {tm.host_mirror:.3f} s, "
        f"pixel_decode {tm.pixel_decode:.3f} s, oracle {tm.oracle:.3f} s; launches {launches}")
    for k in H264:
        if not launches[k]:
            raise AssertionError(f"{k} was not launched on the main path")
    return launches


def phase15d_oracle(tmp: pathlib.Path) -> int:
    """The same run with the full-width YOLOv4 oracle (seeded darknet
    weights, make_yolo_detector on the card): K5's launches and the run's
    split."""
    import torch

    from cova_tpu_torch.models.blobnet import load_artifact
    from cova_tpu_torch.models.yolov4 import make_yolo_detector
    from cova_tpu_torch.pipeline.cova import CovaPipeline

    weights = tmp / "yolov4_15d.weights"
    _yolo_weights(weights, SEED)
    _, sd, meta = load_artifact(REPO / "artifacts" / "blobnet_synth.npz", "cpu")
    det = make_yolo_detector(str(weights), device="cuda")
    pipe = CovaPipeline(str(SYNTH_RENDER), str(tmp / "out15d"), _synth_cfg(meta), sd,
                        detector=det, device="cuda", log=lambda *_: None)
    pipe.warmup()
    torch.cuda.synchronize()
    _launches(reset=True)
    res = pipe.run()
    torch.cuda.synchronize()
    launches = _launches()
    tm = res.timers
    dnn = (tmp / "out15d" / "dnn.csv").read_text().strip().splitlines()
    log(f"[15d] CovaPipeline last=full with YOLOv4-608 (80 classes, seeded weights): "
        f"{res.num_frames} frames in {res.elapsed_seconds:.2f} s, {res.pixel_frames} frames "
        f"through the oracle, {len(dnn) - 1} detections; split: entropy_decode "
        f"{tm.entropy_decode:.3f} s, masks (device_dispatch) {tm.device_dispatch:.3f} s, host "
        f"tracking (host_mirror) {tm.host_mirror:.3f} s, pixel decode {tm.pixel_decode:.3f} s, "
        f"oracle {tm.oracle:.3f} s; launches {launches}")
    if not launches["nms"]:
        raise AssertionError("the oracle's NMS kernel (K5) was not launched")
    return launches["nms"]


def _h264_stats() -> dict:
    return {k: {"checked": 0, "device_ms": [], "ms": [], "plain_ms": [], "bytes": [],
                "wave_ms": [], "waves": []} for k in H264}


def phase15_pixdec(tmp: pathlib.Path, floor) -> dict:
    """Phase 15: the pixel decoder. Returns the kernel records of K8-K10."""
    stats = _h264_stats()
    t0 = time.perf_counter()
    phase15a_kernels(stats)
    log(f"[15a] took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase15b_renders(stats)
    log(f"[15b] took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches = phase15c_full_pipeline(tmp)
    log(f"[15c] took {time.perf_counter() - t0:.1f} s")
    records = {}
    for k in H264:
        s = stats[k]
        nbytes = int(statistics.median(s["bytes"]))
        bound, by = bound_ms(nbytes, 0)
        records[k] = {
            "name": k, "route": "cuda", "source": f"cova_tpu_torch/csrc/{k}.cu",
            "replaces": "cova_tpu/csrc/pixdec.cc", "launches": launches[k],
            "max_abs_err": 0, "ms": statistics.median(s["ms"]),
            "device_ms": statistics.median(s["device_ms"]),
            "launch_floor_ms": floor, "plain_ms": statistics.median(s["plain_ms"]),
            "bound_ms": bound, "bound_by": by, "library_ms": None}
    return records


# Phase 2's check and times of each kernel, by its KERNELS name, in the
# order the whole smoke runs them.
PHASE2 = {"cc_label": phase2_cc, "nms": phase2_nms, "mog2": phase2_mog2,
          "sort_scan": phase2_sort, "blob_stage": phase2_blob_stage, "blob_up": phase2_blob_up,
          "ms_deform_attn": phase2_msda}


def _kernel_lines(records) -> list:
    return [{k: rec[k] for k in (
        "name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
        "device_ms", "launch_floor_ms", "plain_ms", "bound_ms", "bound_by",
        "library_ms")} for rec in records.values()]


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Smoke test of the port on one GPU.")
    ap.add_argument("--kernels-only", action="store_true",
                    help="phases 0-2 only: build, check and time the kernels, print "
                         "their JSON line (launches null) and stop, with no ok line")
    ap.add_argument("--pixdec-only", action="store_true",
                    help="phases 0-1 and 15 (the pixel decoder's kernels against their "
                         "plain versions, the renders against libavcodec's hashes, the "
                         "last=full run), and stop, with no ok line")
    ap.add_argument("--only", choices=sorted(PHASE2), metavar="NAME",
                    help="phases 0-1, then phase 2's check and times of the one kernel NAME "
                         f"({', '.join(PHASE2)}), and stop, with no ok line")
    ap.add_argument("--k7-split", action="store_true",
                    help="phases 0-1, then K7 alone on its four timed inputs (no "
                         "check against the plain version), and stop, with no ok line: "
                         "for timing two checkouts in turns in one call")
    args = ap.parse_args(argv)
    if not (REPO / "cova_tpu_torch").is_dir() or not (REPO / "cova_tpu").is_dir():
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs only on a GPU",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    marks = [t_start]

    def lap(phase):
        marks.append(time.perf_counter())
        log(f"[{phase}] phase took {marks[-1] - marks[-2]:.1f} s")

    smi = phase0_environment()
    phase1_build()
    lap(1)
    if args.k7_split:
        from cova_tpu_torch.ops.cc import mask_to_boxes
        from cova_tpu_torch.tracker.sort import sort_init

        cfg, masks = _production_masks()
        boxes = mask_to_boxes(masks, cfg.compressed.cc_threshold)
        r, f = boxes.valid.shape[:2]
        ts0 = torch.full((r,), cfg.video.timestep - 1, dtype=torch.int32, device="cuda")
        nwin = torch.full((r,), f, dtype=torch.int32, device="cuda")
        _k7_split(cfg, boxes, sort_init(cfg.sort.max_tracks, r, "cuda"), ts0, nwin)
        print(smi, flush=True)
        return 0
    floor = launch_floor_ms()
    if args.only:
        rec = PHASE2[args.only](floor)
        rec.setdefault("launches", None)
        lap(2)
        print(json.dumps({"kernels": _kernel_lines({args.only: rec})}))
        print(smi, flush=True)
        return 0
    if args.pixdec_only:
        with tempfile.TemporaryDirectory() as td:
            recs = phase15_pixdec(pathlib.Path(td), floor)
        lap(15)
        print(json.dumps({"kernels": _kernel_lines(recs)}))
        print(smi, flush=True)
        return 0
    records = {name: check(floor) for name, check in PHASE2.items()}
    lap(2)
    if args.kernels_only:
        for rec in records.values():
            rec["launches"] = None
        print(json.dumps({"kernels": _kernel_lines(records)}))
        print(smi, flush=True)
        return 0
    phase3_compressed_stage()
    lap(3)
    from cova_tpu_torch.codec import Mp4Demuxer

    with tempfile.TemporaryDirectory() as td:
        tmp = pathlib.Path(td)
        t0 = time.perf_counter()
        mp4 = _paff_clip(tmp, 1200)
        samples = Mp4Demuxer(str(mp4)).num_samples
        log(f"[4] PAFF clip 1280x736, {samples} field samples, made in "
            f"{time.perf_counter() - t0:.3f} s")
        res4, launches = phase4_pipeline(mp4, samples, tmp)
        lap(4)
        phase5_masks_step()
        lap(5)
        phase6_default_pipeline(mp4, samples, tmp, res4)
        lap(6)
        records["cc_label"]["launches"] = launches["cc_label"]
        records["sort_scan"]["launches"] = launches["sort_scan"]
        records["nms"]["launches"] = phase7_oracle(tmp)
        lap(7)
        records["mog2"]["launches"] = phase8_training(mp4, tmp)
        lap(8)
        phase9_query(tmp)
        lap(9)
        k1_profile, k7_profile = phase10_profile()
        lap(10)
        phase11_soak(tmp)
        lap(11)
        k1_sharded, k7_sharded = phase12_multi_device()
        lap(12)
        phase13_bench()
        lap(13)
        launches14 = phase14_1080p(tmp)
        for name in ("blob_stage", "blob_up"):
            records[name]["launches"] = launches14[name]
        lap(14)
        records.update(phase15_pixdec(tmp, floor))
        records["nms"]["launches_15d"] = phase15d_oracle(tmp)
        lap(15)
        log(f"K1 launches: phase 4 (the main path) {launches['cc_label']}, phase 10 (profile) "
            f"{k1_profile}, phase 12 (sharded stage) {k1_sharded}; K7 launches: phase 4 "
            f"{launches['sort_scan']}, phase 10 {k7_profile}, phase 12 {k7_sharded}")
    log(f"smoke total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": _kernel_lines(records)}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

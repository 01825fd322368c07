"""The compressed-domain stage (PyTorch port of
cova_tpu/pipeline/compressed.py).

One chunk of F windows per range goes through, in the all-device
variant (`compressed_stage_step`, host_tracking=False):

  metadata (R, F+T-1, H, W, C) u8
    -> temporal stack + clip normalize          (gather)
    -> BlobNet                                   (batched over R*F)
    -> threshold -> connected components -> boxes (CUDA kernel + torch stats)
    -> SORT                                      (CUDA kernel: the F windows, all R)
    -> packed per-slot outputs (R, F, MT, 30) u8 for the host mirror

and in the default host-tracking variant (`compressed_masks_step`)
through BlobNet and the threshold only, the masks leaving the device
bit-packed for connected components + SORT in native host code
(tracker/host.py).

R is the number of independent GoP ranges ("virtual streams"), the
batch-parallel counterpart of the reference's gopsplit fan-out; with a
mesh, `CompressedStage` splits R over several devices (parallel/mesh.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cova_tpu_torch.config import CovaConfig, SortConfig
from cova_tpu_torch.models.blobnet import BlobNet
from cova_tpu_torch.ops.cc import mask_to_boxes
from cova_tpu_torch.ops.cuda.sort_kernel import sort_scan
from cova_tpu_torch.ops.preprocess import metapreprocess, unpack_wire16
from cova_tpu_torch.parallel.mesh import Mesh, replicate, shard_batch
from cova_tpu_torch.tracker.sort import SortOutputs, SortState, sort_init
from cova_tpu_torch.types import MAX_BOXES_PER_FRAME, Boxes


def exact_float32(device) -> None:
    """On CUDA, turn off TF32 for cuDNN convolutions and matmuls (process
    wide): cuDNN runs float32 convolutions in TF32 by default, which
    keeps about three decimal digits and moves BlobNet's probabilities
    far beyond the JAX reference's float32."""
    if torch.device(device).type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False


def compressed_probs(
    model: BlobNet, cfg: CovaConfig, metadata: torch.Tensor
) -> torch.Tensor:
    """metapreprocess + BlobNet: (R, F+T-1, H, W, C) u8 metadata (C = 2
    is the codec's wire16 format) -> (R, F, H, W) float32 probabilities,
    F = (F+T-1 - T) // gamma + 1."""
    if metadata.shape[-1] == 2:
        metadata = unpack_wire16(
            metadata, cfg.compressed.use_nnz_channel, cfg.compressed.signed_mv
        )
    r, _, h, w, c = metadata.shape
    t = cfg.video.timestep
    x = metapreprocess(metadata, t, cfg.compressed.gamma, cfg.compressed.signed_mv)
    f = x.shape[1]
    with torch.no_grad():
        probs = model(x.reshape(r * f, t, h, w, c))
    return probs.reshape(r, f, h, w)


def track_chunk(
    sort_state: SortState,
    boxes: Boxes,  # leading dims (R, F)
    ts0: torch.Tensor,  # (R,) int32 frame index of window 0 per range
    nwin: torch.Tensor,  # (R,) int32 real windows per range
    gamma: int,
    cfg: SortConfig,
) -> tuple[SortState, SortOutputs]:
    """SORT over the F windows of a chunk, every range at once. Window i
    carries frame index ts0 + i*gamma; windows at or past a range's nwin
    (a short range's zero-padding tail) leave its state untouched.
    Returns the new state and the outputs stacked to (R, F, ...).

    On the card this is one launch of the SORT kernel (K7,
    ops/cuda/sort_kernel.py); on the CPU its plain version, a loop of
    `sort_step`s."""
    return sort_scan(sort_state, boxes, ts0, nwin, gamma, cfg)


def compressed_stage_step(
    model: BlobNet,
    cfg: CovaConfig,
    metadata: torch.Tensor,  # (R, F + T - 1, H, W, C) u8
    sort_state: SortState,  # lanes = R
    ts0: torch.Tensor,  # (R,) int32 frame index of window 0 per range
    max_boxes: int = MAX_BOXES_PER_FRAME,
    nwin: torch.Tensor | None = None,  # (R,) int32 real windows per range
):
    """Run one chunk. Returns (new_sort_state, packed, masks, boxes):
    packed is the (R, F, MT, 30) u8 outputs buffer (layout below),
    masks (R, F, H, W) bool, boxes with leading dims (R, F).

    With gamma > 1 only every gamma-th temporal window is emitted, so F =
    (F+T-1 - T)//gamma + 1 and SORT steps carry frame indices spaced
    gamma apart; ts0 is the frame index of window 0's newest frame.
    Windows >= nwin leave the tracker state untouched."""
    probs = compressed_probs(model, cfg, metadata)
    r, f, h, w = probs.shape
    if nwin is None:
        nwin = torch.full((r,), f, dtype=torch.int32, device=probs.device)
    masks = probs > cfg.compressed.mask_threshold
    boxes = mask_to_boxes(masks, cfg.compressed.cc_threshold, max_boxes)
    new_state, outputs = track_chunk(
        sort_state, boxes, ts0, nwin, cfg.compressed.gamma, cfg.sort
    )
    return new_state, pack_outputs(outputs), masks, boxes


def pack_masks(masks: torch.Tensor) -> torch.Tensor:
    """(..., W) bool masks -> flat u8, 8 pixels a byte along W, MSB first
    (np.packbits / np.unpackbits order). A byte's terms sum to at most
    255, so the uint8 sum is exact."""
    w = masks.shape[-1]
    if w % 8:
        raise ValueError(f"mask width {w} is not a multiple of 8")
    pow2 = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.uint8,
                        device=masks.device)
    bits = masks.to(torch.uint8).reshape(masks.shape[:-1] + (w // 8, 8))
    return (bits * pow2).sum(dim=-1, dtype=torch.uint8).reshape(-1)


def compressed_masks_step(
    model: BlobNet, cfg: CovaConfig, metadata: torch.Tensor
) -> torch.Tensor:
    """metapreprocess + BlobNet + threshold only (host_tracking mode):
    (R, F+T-1, H, W, C) u8 metadata -> the masks `probs > mask_threshold`
    bit-packed by `pack_masks` into a flat u8 tensor of R*F*H*(W/8)
    bytes on the metadata's device. The host runs connected components
    + SORT on them natively (tracker/host.py)."""
    probs = compressed_probs(model, cfg, metadata)
    return pack_masks(probs > cfg.compressed.mask_threshold)


def compressed_probs_step(
    model: BlobNet, cfg: CovaConfig, metadata: torch.Tensor
) -> torch.Tensor:
    """metapreprocess + BlobNet without the threshold: the raw per-window
    probabilities as a flat float32 tensor of R*F*H*W, for sweeping
    mask_threshold and the tracker's knobs over one forward pass."""
    return compressed_probs(model, cfg, metadata).reshape(-1)


def unpack_masks(packed_flat, shape):
    """Host-side inverse of compressed_masks_step's bit-packing:
    (R, F, H, W) bool masks from the pulled flat buffer."""
    import numpy as _np

    r, f, h, w = shape
    buf = _np.asarray(packed_flat).reshape(r * f, h, w // 8)
    return _np.unpackbits(buf, axis=-1).reshape(r, f, h, w)


# Byte layout of one packed track slot (little-endian, 30 bytes):
#   [0:8)   track_ltwh  4 x f16
#   [8:12)  track_id    i32 (pre-birth id, for history pushes)
#   [12:16) track_id_post i32 (post-birth id, for liveness)
#   [16:20) death_id    i32
#   [20:24) death_start i32
#   [24:28) death_last_match i32
#   [28]    flags u8: exists | active<<1 | predicted<<2 | death<<3
#                     | death_active<<4
#   [29]    death_tsu u8 (clipped at 255)
PACKED_SLOT_BYTES = 30


def _to_u8(x: torch.Tensor) -> torch.Tensor:
    """Reinterpret a fixed-width tensor as u8 with the byte axis appended."""
    if x.dtype == torch.uint8:
        return x[..., None]
    size = x.element_size()
    return x.contiguous().view(torch.uint8).reshape(x.shape + (size,))


def pack_outputs(o: SortOutputs) -> torch.Tensor:
    """The per-frame SortOutputs as ONE contiguous u8 tensor, so a chunk
    crosses to the host in one copy: boxes as f16, ids as i32, the five
    booleans as one bitmask byte (layout above)."""
    u8 = torch.uint8
    flags = (
        o.exists.to(u8)
        | (o.active.to(u8) << 1)
        | (o.predicted.to(u8) << 2)
        | (o.death.to(u8) << 3)
        | (o.death_active.to(u8) << 4)
    )
    parts = [
        _to_u8(o.track_ltwh.to(torch.float16)).reshape(o.track_id.shape + (8,)),
        _to_u8(o.track_id),
        _to_u8(o.track_id_post),
        _to_u8(o.death_id),
        _to_u8(o.death_start),
        _to_u8(o.death_last_match),
        _to_u8(flags),
        _to_u8(o.death_tsu.clamp(0, 255).to(u8)),
    ]
    return torch.cat(parts, dim=-1)  # (..., slots, 30) u8


def unpack_outputs_np(packed, shape=None):
    """Host-side view over the pulled packed buffer (numpy), exposing
    the SortOutputs field names HostTracker consumes.

    `shape`: the logical (..., slots, PACKED_SLOT_BYTES) shape when
    `packed` arrives flattened from the device (see
    compressed_stage_step's flat-transfer note); CompressedStage exposes
    it as `packed_shape`."""
    import types as _types

    import numpy as _np

    buf = _np.ascontiguousarray(_np.asarray(packed))  # one transfer
    if shape is not None:
        buf = buf.reshape(shape)
    elif buf.ndim == 1:
        raise ValueError("flat packed buffer needs an explicit shape")

    def _f(lo, hi, dt):
        return _np.ascontiguousarray(buf[..., lo:hi]).view(dt)[..., 0]

    flags = buf[..., 28]
    ns = _types.SimpleNamespace(
        track_ltwh=_np.ascontiguousarray(buf[..., 0:8])
        .view(_np.float16)
        .astype(_np.float32),
        track_id=_f(8, 12, _np.int32),
        track_id_post=_f(12, 16, _np.int32),
        exists=(flags & 1) != 0,
        active=(flags & 2) != 0,
        predicted=(flags & 4) != 0,
        death=(flags & 8) != 0,
        death_active=(flags & 16) != 0,
        death_id=_f(16, 20, _np.int32),
        death_start=_f(20, 24, _np.int32),
        death_last_match=_f(24, 28, _np.int32),
        death_tsu=buf[..., 29].astype(_np.int32),
    )
    return ns


class CompressedStage:
    """Holds the model, the device and the per-range SORT state across
    chunks.

    With a mesh (parallel.mesh.Mesh; CovaPipeline builds one from
    ParallelConfig.num_devices) the range axis R is split into mesh.size
    equal contiguous blocks, block i on mesh.devices[i] with its own
    replica of the model and its own block of SORT lanes, and the outputs
    are joined in range order on `device`, equal to the one-device
    stage's. num_ranges must divide by the mesh's size.

    The blocks are uploaded first, then their steps issued one after
    another from this thread, each on its device's current stream. No
    step waits for the device: BlobNet, the labelling, the box stats and
    the tracker (one launch of the SORT kernel K7 a block, no host
    synchronisation inside it) are all queued, so blocks on different
    cards run at the same time. `run_chunk` returns device tensors; the
    caller's copy to the host is the first wait."""

    def __init__(
        self,
        model: BlobNet,
        cfg: CovaConfig,
        num_ranges: int,
        device,
        mesh=None,
    ):
        self.device = torch.device(device)
        self.cfg = cfg
        self.num_ranges = num_ranges
        if mesh is None:
            mesh = Mesh((self.device,))
        if num_ranges % mesh.size:
            raise ValueError(
                f"num_ranges {num_ranges} not divisible by mesh size {mesh.size}"
            )
        if any(d.type != self.device.type for d in mesh.devices):
            raise ValueError(f"mesh devices {mesh.devices} are not all {self.device.type}")
        self.mesh = mesh
        for d in mesh.devices:
            exact_float32(d)
        model = model.eval()
        self.models = [model.to(self.device)] if mesh.size == 1 else replicate(mesh, model)
        self.sort_states = shard_batch(
            mesh, sort_init(cfg.sort.max_tracks, num_ranges, "cpu")
        )

    def _join(self, parts):
        """Per-block outputs (trees of tensors) joined along the range
        axis on self.device."""
        if len(parts) == 1:
            return parts[0]
        first = parts[0]
        if isinstance(first, torch.Tensor):
            return torch.cat([p.to(self.device) for p in parts])
        return type(first)(**{
            f.name: torch.cat([getattr(p, f.name).to(self.device) for p in parts])
            for f in dataclasses.fields(first)
        })

    def run_chunk(self, metadata, ts0, nwin=None):
        """metadata: (R, F+T-1, H, W, C) u8 (numpy or tensor); ts0: (R,)
        int32; nwin: optional (R,) int32 real-window bound (see
        compressed_stage_step).

        Returns (packed, masks, boxes) on `device`; packed has shape
        `self.packed_shape` = (R, F, max_tracks, PACKED_SLOT_BYTES)."""
        r, ft = metadata.shape[:2]
        t = self.cfg.video.timestep
        f = (ft - t) // self.cfg.compressed.gamma + 1
        self.packed_shape = (r, f, self.cfg.sort.max_tracks, PACKED_SLOT_BYTES)
        if nwin is None:
            nwin = np.full((r,), f, np.int32)
        blocks = zip(
            shard_batch(self.mesh, metadata),
            shard_batch(self.mesh, np.asarray(ts0, np.int32)),
            shard_batch(self.mesh, np.asarray(nwin, np.int32)),
        )
        outs = []
        for i, (md, ts, nw) in enumerate(blocks):
            self.sort_states[i], packed, masks, boxes = compressed_stage_step(
                self.models[i], self.cfg, md, self.sort_states[i], ts, nwin=nw
            )
            outs.append((packed, masks, boxes))
        return tuple(self._join(list(part)) for part in zip(*outs))

    def run_chunk_masks(self, metadata):
        """Masks-only device step (host_tracking mode): metadata
        (R, F+T-1, H, W, C) u8 (numpy or tensor) -> flat bit-packed u8
        masks on `device`; recover (R, F, H, W) with
        unpack_masks(pulled, self.masks_shape)."""
        r, ft, h, w = metadata.shape[:4]
        f = (ft - self.cfg.video.timestep) // self.cfg.compressed.gamma + 1
        self.masks_shape = (r, f, h, w)
        outs = [compressed_masks_step(model, self.cfg, md)
                for model, md in zip(self.models, shard_batch(self.mesh, metadata))]
        return self._join(outs)

"""Typed configuration for the whole framework.

Replaces the reference's three-tier config mix — YAML with `{}` template
holes, YAML->GObject property mapping, and clap/argparse CLIs
(reference: experiment/cova/launch.py:27-30, pipeline/common/pipeline.py:27-33,
analysis-aggregator/src/main.rs:22-42) — with plain dataclasses that can be
loaded from YAML/JSON and overridden programmatically.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Optional


@dataclasses.dataclass(frozen=True)
class VideoConfig:
    """Input stream geometry (reference: experiment/cova/config.yaml:5-7)."""

    width: int = 1280
    height: int = 720
    fps: float = 30.0
    timestep: int = 4  # temporal stack depth T

    @property
    def mb_width(self) -> int:
        return (self.width + 15) // 16

    @property
    def mb_height(self) -> int:
        return (self.height + 15) // 16


@dataclasses.dataclass(frozen=True)
class SortConfig:
    """SORT tracker knobs (reference: cova element properties,
    cova-rs/gst-plugins/src/cova/imp.rs:537-639; values from
    experiment/cova/config.yaml)."""

    iou_threshold: float = 0.1  # cova_sort_iou (config.yaml:67)
    # Reference launch defaults: --maxage 60 --minhit 30
    # (experiment/cova/launch.py:43-44).
    max_age: int = 60
    min_hits: int = 30
    # Reference quirk: `from_x` reuses width/2 for the y offset when
    # converting the Kalman state back to a bbox
    # (cova-rs/sort/src/state.rs:9-28). True reproduces it bit-for-bit.
    reproduce_from_x_quirk: bool = True
    max_tracks: int = 64  # fixed capacity of the batched tracker


@dataclasses.dataclass(frozen=True)
class CompressedStageConfig:
    """Compressed-domain stage (reference: metapreprocess + blobnet +
    bboxcc element configuration)."""

    gamma: int = 1  # emit 1 of every gamma temporal stacks
    cc_threshold: int = 1  # CC area threshold in MB units (config.yaml:62)
    mask_threshold: float = 0.5  # segmentation threshold (nvinfer blobnet cfg)
    batch_frames: int = 128  # frames per device step (chunk length F)
    # Feed the residual-coefficient density (per-MB nonzero count, the
    # byte the reference leaves unused in its metadata contract,
    # gsth264parse metadata layout) as a 4th BlobNet input channel.
    # Requires a BlobNet trained with in_channels=4.
    use_nnz_channel: bool = False
    # Feed mean SIGNED per-MB motion vectors (offset-128 u8, normalized
    # clip(x-128,-6,6)/6) instead of mean |mv| — the reference's
    # metadata contract (utils/data/parse.py:5-31). Requires a BlobNet
    # trained on signed-mv metadata; see the ablation in ACCURACY.md.
    signed_mv: bool = False
    # True (default): the device program runs metapreprocess + BlobNet
    # (the dense FLOPs) and emits thresholded masks; connected
    # components + SORT run in native host code (csrc/cctrack.cc) —
    # where the reference also runs them (OpenCV bboxcc, cova-rs/sort).
    # False: the all-device program (CC + SORT inside the jit), the
    # variant the sharded multi-chip path uses.
    host_tracking: bool = True


@dataclasses.dataclass(frozen=True)
class SelectorConfig:
    """cova frame-selection element knobs (reference:
    cova-rs/gst-plugins/src/cova/imp.rs:537-639 +
    experiment/cova/config.yaml:64-74)."""

    alpha: int = 0  # extra decoded frames per GoP
    beta: int = 0  # inference frames spaced among alpha extras
    infer_i: bool = True  # always infer the I-frame of flushed GoPs
    # Scheduling window trailing margin: pts - (max_age + 10) frames
    # (imp.rs:125-132); GoP flush horizon: 250 frames (imp.rs:258-267).
    window_margin_frames: int = 10
    flush_horizon_frames: int = 250


@dataclasses.dataclass(frozen=True)
class OracleConfig:
    """Pixel-domain detector (reference: config/dnn/yolov4_b2.txt)."""

    input_size: int = 608
    num_classes: int = 80
    score_threshold: float = 0.25
    nms_iou_threshold: float = 0.2
    max_detections: int = 64
    batch_size: int = 8


@dataclasses.dataclass(frozen=True)
class AggregatorConfig:
    """Associator knobs; defaults from the reference CLI
    (analysis-aggregator/src/main.rs:22-42)."""

    moving_iou: float = 0.15
    stationary_iou: float = 0.3
    scale_factor: float = 1.3  # track bbox inflation before matching
    # Seconds without refresh -> finalize (reference launch default:
    # --stationary-maxage 60, experiment/cova/launch.py:49).
    stationary_maxage: float = 60.0


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """Scale-out knobs. The reference's GoP fan-out (32 entropy decoder
    branches, experiment/cova/config.yaml:15) becomes a batch axis over
    GoP ranges; multi-chip sharding happens over a jax Mesh."""

    num_ranges: int = 8  # independent GoP-range "virtual streams" per chip
    decode_threads: int = 16  # C++ entropy/pixel decoder thread pool
    mesh_axis: str = "stream"
    # Shard the range axis over this many devices (1 = single chip).
    # num_ranges must be a multiple of num_devices.
    num_devices: int = 1


@dataclasses.dataclass(frozen=True)
class CovaConfig:
    video: VideoConfig = dataclasses.field(default_factory=VideoConfig)
    sort: SortConfig = dataclasses.field(default_factory=SortConfig)
    compressed: CompressedStageConfig = dataclasses.field(
        default_factory=CompressedStageConfig
    )
    selector: SelectorConfig = dataclasses.field(default_factory=SelectorConfig)
    oracle: OracleConfig = dataclasses.field(default_factory=OracleConfig)
    aggregator: AggregatorConfig = dataclasses.field(
        default_factory=AggregatorConfig
    )
    parallel: ParallelConfig = dataclasses.field(default_factory=ParallelConfig)
    # Build the pipeline only up to this stage then stop — the reference's
    # `last:` debugging convention (pipeline/cova/pipeline.py:36-405).
    last: Optional[str] = None

    @staticmethod
    def from_dict(d: dict) -> "CovaConfig":
        def build(cls, sub: dict):
            fields = {f.name: f for f in dataclasses.fields(cls)}
            kwargs = {}
            for k, v in sub.items():
                if k not in fields:
                    raise KeyError(f"unknown config key {k!r} for {cls.__name__}")
                if isinstance(v, dict):
                    inner = fields[k].default_factory()  # type: ignore[misc]
                    kwargs[k] = build(type(inner), v)
                else:
                    kwargs[k] = v
            return cls(**kwargs)

        return build(CovaConfig, d)

    @staticmethod
    def load(path: str | pathlib.Path) -> "CovaConfig":
        text = pathlib.Path(path).read_text()
        if str(path).endswith((".yaml", ".yml")):
            import yaml

            return CovaConfig.from_dict(yaml.safe_load(text))
        return CovaConfig.from_dict(json.loads(text))

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

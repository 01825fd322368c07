"""Per-dataset query configuration.

Mirror of the reference's parse/config.yaml: each dataset names its
exclusion rectangles (noise suppression for small unstable detections),
target classes, and local-query quadrant.

The demo dataset is the reference's 1-minute amsterdam clip (1m.mp4,
not in this repository). It reuses the amsterdam exclusions
(reference: parse/config.yaml `amsterdam.exclude` — the parked-car and
"bump" boxes on the roundabout island) plus one rectangle over the
burned-in timestamp overlay at the top-left, which flickers every
second and is not an object.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

Rect = Tuple[Tuple[float, float], Tuple[float, float]]


@dataclasses.dataclass(frozen=True)
class DatasetQueryConfig:
    exclude: Sequence[Rect]
    targets: Sequence[int]
    region: str
    frame_size: Tuple[int, int] = (1280, 640)


# reference parse/config.yaml amsterdam
AMSTERDAM_EXCLUDE: Sequence[Rect] = (
    ((390, 130), (785, 310)),
    ((770, 305), (855, 360)),
    ((900, 315), (1045, 400)),
)

AMSTERDAM = DatasetQueryConfig(
    exclude=AMSTERDAM_EXCLUDE,
    targets=(2,),  # car
    region="lower right",
)

DEMO = DatasetQueryConfig(
    exclude=tuple(AMSTERDAM_EXCLUDE) + (((0, 0), (350, 24)),),
    targets=(2,),
    region="lower right",
)

# reference parse/config.yaml archie ("tiny parked truck in the
# middle"); frame size unverifiable offline (the reference reads it
# from the video at parse time) — 720p assumed, override per run.
ARCHIE = DatasetQueryConfig(
    exclude=(((-20, -20), (830, 140)),),
    targets=(5,),  # bus
    region="upper left",
    frame_size=(1280, 720),
)

# Second offline dataset: the demo clip re-encoded with a different
# bitstream structure (CAVLC, keyint=100, bframes=2 — see
# examples/make_dataset2.py) and evaluated with the ARCHIE-style query
# (targets = bus, class 5) against the 3-class stand-in oracle
# (bgdet bus_area=2500) — exercises the multi-class voting path and the
# bus-target machinery the reference's archie dataset uses
# (parse/config.yaml archie). Same camera, so same exclusions as demo.
DEMO2 = DatasetQueryConfig(
    exclude=DEMO.exclude,
    targets=(5,),  # bus
    region="lower right",
)

# The 1080p evaluation stream (examples/make_dataset2.py build_1080p):
# the demo clip upscaled 1.5x, so the SAME query semantics scale every
# pixel-space quantity by 1.5 — exclusion rectangles and the local-
# region frame size ((1280, 640) -> (1920, 960); the reference reads
# frame size from the video per dataset, parse/config.yaml).
DEMO1080 = DatasetQueryConfig(
    exclude=tuple(
        ((x0 * 1.5, y0 * 1.5), (x1 * 1.5, y1 * 1.5))
        for (x0, y0), (x1, y1) in DEMO.exclude
    ),
    targets=(2,),
    region="lower right",
    frame_size=(1920, 960),
)

# The synthetic third scene (examples/make_synth.py): a procedural
# fixed-camera intersection — different layout, background, object
# sizes/speeds/trajectories from the amsterdam roundabout — rendered
# and encoded offline through the first-party libx264 path. The
# cross-scene generalization corpus (reference analog: the multi-scene
# configs in parse/config.yaml). Cars are the targets; the single
# bus-sized vehicle is split off by bus_area=2500 like demo2. The
# camera has no burned-in overlays or permanent parked objects, so no
# exclusions. The busy quadrant for the local query is the lower right
# (main-street traffic both directions plus the cross street's lower
# leg).
SYNTH = DatasetQueryConfig(
    exclude=(),
    targets=(2,),  # car
    region="lower right",
    frame_size=(1280, 720),
)

DATASETS = {
    "amsterdam": AMSTERDAM,
    "archie": ARCHIE,
    "demo": DEMO,
    "demo2": DEMO2,
    "demo1080": DEMO1080,
    "synth": SYNTH,
}

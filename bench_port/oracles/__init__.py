"""The oracles the harness knows, one module an architecture, found by
the configuration's `oracle.arch`: `oracles/<arch>.py`.

A module holds everything the harness knows of its oracle:

  LIMITS     the limits of the oracle's numbers in the comparison, each
             with its reason
  FOLD       how each number folds over a window's frames (max, sum)
  flops()    a frame's operations, counted from the published shapes
  Program    Program(conf, seed, device): the port's detector on weights
             made from the seed, a callable frames -> BoxRecs as
             CovaPipeline takes it; `weights`, those weights; `take()`,
             what the network produced for the last frame, on the host
  Reference  Reference(conf, weights, device): the plain reference on the
             same weights; `outputs(y, u, v)`, its outputs for a picture;
             `numbers(ref_outputs, outputs, boxes, frame_hw)`, one frame's
             numbers; `control(y, u, v)`, the same numbers with the
             reference in the precision below the configuration's in the
             program's place

A new oracle is a new module and a configuration that names it.
"""

from __future__ import annotations

import importlib

CONTRACT = ("LIMITS", "FOLD", "flops", "Program", "Reference")


def load(conf: dict):
    """The oracle module that the configuration `conf` names; raises
    ValueError, naming the arch, where it names none or one with no
    module."""
    arch = conf.get("oracle", {}).get("arch")
    if not arch:
        raise ValueError(f"configuration {conf.get('name')!r} names no oracle arch "
                         "(its oracle's \"arch\")")
    name = f"{__name__}.{arch}"
    if not arch.isidentifier():
        raise ValueError(f"oracle arch {arch!r} is not a module name")
    try:
        mod = importlib.import_module(name)
    except ModuleNotFoundError as e:
        if e.name != name:
            raise
        raise ValueError(f"oracle arch {arch!r} has no module bench_port/oracles/{arch}.py") \
            from None
    missing = [n for n in CONTRACT if not hasattr(mod, n)]
    if missing:
        raise ValueError(f"oracle arch {arch!r}: its module lacks {missing}")
    return mod

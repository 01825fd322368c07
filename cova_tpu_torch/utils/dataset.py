"""Per-macroblock metadata packing (the one function of
cova_tpu/utils/dataset.py the port's pipelines need; the rest of that
module builds BlobNet training sets).

`pack_metadata` is a function-level copy of the original, held equal to
it by tests/test_torch_port.py.
"""

from __future__ import annotations

import numpy as np


def pack_metadata(
    meta: dict, use_nnz: bool = False, signed_mv: bool = False
) -> np.ndarray:
    """Per-MB metadata dict -> (F, H, W, C) u8 [mb_class, |mv_x|, |mv_y|]
    with quarter-pel MVs scaled to full-pel (the BlobNet normalization
    clips at 6, so full-pel units keep small motions resolvable).

    use_nnz adds the residual nonzero-coefficient count as a 4th channel,
    scaled by 1/4 so the clip(0,6)/6 normalization resolves 0-24
    coefficients/MB before saturating (texture change density).

    signed_mv packs mean SIGNED full-pel MVs offset-128 (the
    reference's contract feeds signed mv, utils/data/parse.py:5-31);
    normalize with clip6_normalize(x, signed_mv=True). Matches the
    codec's fused packed layout (csrc/api.cc) byte-for-byte."""
    if signed_mv:
        # arithmetic >> 2 (floor) to match the C packing exactly
        mv = [
            np.clip(128 + (meta["mv_sx"] >> 2), 0, 255).astype(np.uint8),
            np.clip(128 + (meta["mv_sy"] >> 2), 0, 255).astype(np.uint8),
        ]
    else:
        mv = [
            np.clip(np.abs(meta["mv_x"]) // 4, 0, 255).astype(np.uint8),
            np.clip(np.abs(meta["mv_y"]) // 4, 0, 255).astype(np.uint8),
        ]
    chans = [meta["mb_class"].astype(np.uint8)] + mv
    if use_nnz:
        chans.append(np.clip(meta["nnz"] // 4, 0, 255).astype(np.uint8))
    return np.stack(chans, axis=-1)

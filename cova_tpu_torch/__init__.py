"""cova_tpu_torch — the compressed-domain video-analytics pipeline on
PyTorch and CUDA (NVIDIA Hopper).

A port of the JAX package `cova_tpu`, which stays the reference: module
paths and names follow it so that each module's counterpart is easy to
find. This package imports `torch` and never `jax`.

Slice covered: `CovaPipeline` with `host_tracking=False` — entropy
decode (shared C++ codec) -> metapreprocess -> BlobNet -> threshold ->
connected components (hand-written CUDA kernel, csrc/cc_kernel.cu) ->
region stats -> SORT (Kalman filter + auction assignment) -> host
mirror -> frame selector -> aggregator CSVs.
"""

__version__ = "0.1.0"

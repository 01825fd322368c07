"""cova_tpu_torch — the compressed-domain video-analytics pipeline on
PyTorch and CUDA (NVIDIA Hopper).

A port of the JAX package `cova_tpu`, which stays the reference: module
paths and names follow it so that each module's counterpart is easy to
find. This package imports `torch` and never `jax`.

Covered: `CovaPipeline` in the default host-tracking mode — entropy
decode (shared C++ codec) -> metapreprocess -> BlobNet -> threshold ->
bit-packed masks -> native CC + SORT on the host -> frame selector ->
aggregator CSVs — and with `host_tracking=False`, where connected
components (hand-written CUDA kernel, csrc/cc_kernel.cu), region stats
and SORT (Kalman filter + auction assignment) run on the device;
multi-stream ingest on one device; `SortPipeline`.
"""

__version__ = "0.1.0"

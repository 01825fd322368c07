"""Hand-written CUDA kernels: build helpers and the wrappers that launch them."""

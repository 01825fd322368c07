"""Tensor ops of the compressed stage (PyTorch port of cova_tpu.ops)."""

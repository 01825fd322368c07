"""Models of the compressed stage (PyTorch port of cova_tpu.models)."""

"""Pipeline orchestration (PyTorch port of cova_tpu.pipeline)."""

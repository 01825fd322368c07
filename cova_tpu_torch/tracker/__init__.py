"""SORT tracking (PyTorch port of cova_tpu.tracker)."""

"""Command-line examples of the PyTorch port (counterparts of examples/)."""

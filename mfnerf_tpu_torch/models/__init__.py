"""Models of the PyTorch port (mirrors mfnerf_tpu.models)."""

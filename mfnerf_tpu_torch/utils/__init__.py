"""Utils of the PyTorch port (mirrors mfnerf_tpu.utils)."""

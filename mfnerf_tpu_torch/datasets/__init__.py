"""Datasets of the PyTorch port (mirrors mfnerf_tpu.datasets)."""

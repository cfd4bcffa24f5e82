"""Ops of the PyTorch port (mirrors mfnerf_tpu.ops)."""

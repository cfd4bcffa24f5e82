"""Data parallelism: the port of ``mfnerf_tpu/parallel/`` (``dist.py``)."""

"""mfnerf_tpu_torch — the PyTorch/CUDA port of ``mfnerf_tpu`` for Hopper.

The JAX package ``mfnerf_tpu`` stays the reference; this package computes the
same functions with PyTorch tensors, and replaces the JAX package's Pallas
kernels with kernels written by hand for ``sm_90a`` (``csrc/``). Module paths
mirror the JAX package (``ops/``, ``models/``, ``utils/``, ``datasets/``).

The port imports neither ``jax`` nor ``mfnerf_tpu``: the machine that runs it
has PyTorch, CUDA and numpy only.

It trains a LowRank field (``train.NeRFSystem``) and serves it through the
alive-ray test renderer (``models.rendering.render_test``). Its entry points
run on the CUDA device unless the caller passes ``device="cpu"``
(:func:`device.resolve_device`); they never fall back to the CPU.
"""

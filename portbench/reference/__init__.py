"""The benchmark's plain reference of a training step and a served frame.

Plain PyTorch, float32 with TF32 off (``tf32`` in :mod:`.train_step` and
:mod:`.render` is the control's switch), no hand kernel, no capacity
buffer, no CUDA graph. Every file here is a frozen copy of the port's plain
versions as they stood when the benchmark was written, and says what it
was copied from; none of them imports anything of the port, of the JAX
package or of JAX, so a later change to the port cannot move the
yardstick.

* :mod:`.march`: the closed-form t-ladder, Morton codes and the bitfield,
  the scene box, the training march with the two-level strata budget and
  the flat budget's cut, and the test march in rank windows.
* :mod:`.field`: the fused LowRank encoder (bf16 hat product with fp32
  sums, its dense-basis backward), the hash grids' plain encoder, spherical
  harmonics, ``trunc_exp`` and the bias-free MLPs.
* :mod:`.composite`: the training composite (autograd through cumprod)
  and the serving round.
* :mod:`.train_step`: the trainer's step from a snapshot of its state, and
  the loss.
* :mod:`.render`: the dense frame on chosen pixels.
* :mod:`.compare`: the numbers that decide ``correct``.
"""

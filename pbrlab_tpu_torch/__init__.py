"""pbrlab_tpu_torch: the PyTorch/CUDA port of pbrlab_tpu.

The forward render of `pbrlab_tpu` (persistent-lane wavefront path tracer
with principled BSDF, random-walk SSS and deferred NEE) on PyTorch tensors,
with the triangle-trace kernels written by hand in CUDA for Hopper
(`csrc/dense_v4.cu`, `csrc/dense_v5.cu`). The subpackage layout and
function names follow `pbrlab_tpu`, which stays the reference the port is
tested against.
This package imports torch and numpy, never jax.
"""

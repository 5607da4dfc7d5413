"""pbrlab_tpu_torch: the PyTorch/CUDA port of pbrlab_tpu.

The forward render of `pbrlab_tpu` (persistent-lane wavefront path tracer
with principled BSDF, random-walk SSS and deferred NEE) on PyTorch tensors,
with the triangle-trace kernels written by hand in CUDA for Hopper
(`csrc/*.cu`). The subpackage layout and function names follow
`pbrlab_tpu`, which stays the reference the port is tested against.
This package imports torch and numpy, never jax.
"""
import torch

# On the CPU, torch computes log, exp and the other transcendental
# functions through MKL's vector math, one call per 2048-element chunk on
# its OpenMP threads. When the first such call of a process runs on
# several threads at once, MKL's one-time set-up races, and about one
# process in twenty gets one chunk back with a relative error near 1e-4
# (measured on log and exp of 12288 float32 values). One small call on a
# single thread does that set-up first.
torch.log(torch.ones(8))

"""Per-lane counter-seeded PCG, bit-exact to pbrlab_tpu.core.rng.

The state is a uint32 per lane. PyTorch on the CPU has no right shift for
uint32 tensors, so the state rides as int64 holding the uint32 value
(always masked with `& 0xFFFFFFFF`). Products of two 32-bit values may
wrap in int64; the low 32 bits, which are all that is kept, stay exact.
A draw is `((word >> 9) | 0x3F800000)` reinterpreted as float32, minus 1,
the reference Draw() bit trick (rng.h:52-65) -> uniform [0, 1).
"""
from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
_MULT = 747796405
_INC = 2891336453
_OUT_MULT = 277803737
_GOLDEN = 0x9E3779B9


def _u32(x):
    return x & _MASK


def _pcg_out(state):
    """PCG output permutation on a uint32 state (int64 carrier)."""
    word = _u32(((state >> ((state >> 28) + 4)) ^ state) * _OUT_MULT)
    return (word >> 22) ^ word


def hash_u32(x):
    """One full PCG round used as an integer hash (advance + permute)."""
    return _pcg_out(_u32(x * _MULT + _INC))


def seed_state(pixel_id, sample_id, seed=0):
    """Decorrelated per-lane states from (pixel, sample, seed) keys.
    Arguments are int tensors (or Python ints) holding uint32 values; a
    seed tensor (0-dim, on the lanes' device) is read on the device."""
    pixel_id = torch.as_tensor(pixel_id).to(torch.int64) & _MASK
    sample_id = torch.as_tensor(sample_id).to(torch.int64) & _MASK
    seed = (seed.to(torch.int64) if torch.is_tensor(seed)
            else int(seed)) & _MASK
    h = hash_u32(pixel_id ^ ((seed * _GOLDEN) & _MASK))
    return hash_u32(h ^ _u32(sample_id * 0x85EBCA6B))


def next_state(state):
    return _u32(state * _MULT + _INC)


def draw(state):
    """Advance each lane and return (new_state, uniform in [0, 1))."""
    state = next_state(state)
    bits = (_pcg_out(state) >> 9) | 0x3F800000
    return state, bits.to(torch.int32).view(torch.float32) - 1.0


def draw_n(state, n):
    """Draw n uniforms per lane; returns (state, [n] list of tensors)."""
    us = []
    for _ in range(n):
        state, u = draw(state)
        us.append(u)
    return state, us


def state_to_f32(state):
    """uint32 state (int64 carrier) -> float32 carrying the same 32 bits."""
    return state.to(torch.int32).view(torch.float32)


def state_from_f32(bits):
    """Inverse of state_to_f32."""
    return bits.view(torch.int32).to(torch.int64) & _MASK

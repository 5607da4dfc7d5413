"""The no-grad wavefront step as two CUDA kernels around its trace.

`render/integrator.py wavefront_step` is a chain of plain torch
operations: ~3,600 kernels a step, each a pass over every lane. On a
baked, untextured, hair-free scene, with grad mode off, the step runs
instead as two kernels written by hand for Hopper (`csrc/step.cu`, the
per-lane code in `csrc/step.cuh`), one thread a lane:

* `pre` -> `step_pre`: the pre-trace draws, the volume lanes' direction
  and scatter distance, the rays' min and max t, and on a resolving step
  the pending shadow queries' rays, as the arrays the trace launch reads;
* `shade` -> `step_shade`: from the trace's hit to the new packed state
  rows [n, 39] (`integrator.pack_state`).

The trace between them is the chain's own launch (`trace_scene_dual` or
`trace_scene`). The kernels give the chain's bits on the card: they
compute each operation of the chain in its order and its rounding (the
library is built with --fmad=false, no fast math). The chain stays the
kernels' plain twin, the autograd path and the path of every scene they
do not cover; the integrator chooses (`integrator.fused_step`).

`LAUNCHES`, registered in `render.graphs.COUNTERS`, counts each kernel's
launches where it launches: `pre` (`step_pre`) and `fused` (`step_shade`,
one a fused step); and `chain`, the steps that ran as the torch chain on
a CUDA device, which `integrator._wavefront_step_chain` counts as it
starts.
"""
from __future__ import annotations

import ctypes

import torch

from ..scene.materials import fat_layout
from . import cuda_lib

LAUNCHES = {"pre": 0, "fused": 0, "chain": 0}

COLS = 39  # the packed state (integrator._PACK_COLS)
FACE_COLS = 26  # face_fat (scene.build_fat_tables)
LIGHT_COLS = 16  # light_fat
# the material columns the kernel reads, at the offsets csrc/step.cuh
# names (MatCol)
MAT_COLS = {"base_color": 3, "subsurface": 6, "subsurface_radius": 7,
            "subsurface_color": 10, "metallic": 13, "specular": 14,
            "specular_tint": 15, "roughness": 16, "anisotropic": 17,
            "clearcoat": 21, "clearcoat_roughness": 22, "transmission": 24}

_P, _I = ctypes.c_void_p, ctypes.c_int
# rows, ld, n, freeze, resolving, org, dir, min_t, max_t, sdir, smin, smax
_PRE_ARGS = [_P, _I, _I, _I, _I] + [_P] * 7 + [_P]
# rows, ld, n, freeze, resolving, t, u, v, prim, occ, face_fat, faces,
# mat_fat, mat_cols, mats, light_fat, light_cdf, lights, out, stream
_SHADE_ARGS = ([_P, _I, _I, _I, _I] + [_P] * 6
               + [_I, _P, _I, _I, _P, _P, _I, _P, _P])


def _check_layout():
    """Raise unless the material matrix has the columns the kernel reads
    where `MAT_COLS` says."""
    layout, _ = fat_layout()
    wrong = {k: layout[k][0] for k, off in MAT_COLS.items()
             if layout[k][0] != off}
    if wrong:
        raise ValueError(f"step kernel: material columns moved: {wrong}")


_check_layout()


def _rows_arg(rows):
    """(pointer, row stride) of the packed rows [n, >= 39] the kernels
    read: float32 on the card, unit column stride."""
    n, cols = rows.shape
    if rows.dtype != torch.float32 or cols < COLS or rows.stride(1) != 1 \
            or (n > 1 and rows.stride(0) < COLS):
        raise ValueError(f"step kernels want float32 rows [n, >= {COLS}] "
                         f"with unit column stride; got {rows.dtype} "
                         f"{tuple(rows.shape)} strides {rows.stride()}")
    return rows.data_ptr(), max(rows.stride(0), COLS)


def pre(rows, freeze: bool, resolving: bool):
    """The step's rays from the packed rows: (org [n, 3], direction
    [n, 3], min_t [n], max_t [n]) and, resolving, the pending shadow
    queries' (direction [n, 3], min_t [n], max_t [n]), else None."""
    dev = rows.device
    n = rows.shape[0]
    ptr, ld = _rows_arg(rows)
    f32 = dict(dtype=torch.float32, device=dev)
    org, direction = torch.empty((n, 3), **f32), torch.empty((n, 3), **f32)
    min_t, max_t = torch.empty((n,), **f32), torch.empty((n,), **f32)
    shadow = None
    ptrs = [None] * 3
    if resolving:
        shadow = (torch.empty((n, 3), **f32), torch.empty((n,), **f32),
                  torch.empty((n,), **f32))
        ptrs = [x.data_ptr() for x in shadow]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = cuda_lib.function("step_pre", _PRE_ARGS)(
            ptr, ld, n, int(freeze), int(resolving), org.data_ptr(),
            direction.data_ptr(), min_t.data_ptr(), max_t.data_ptr(), *ptrs,
            stream)
    cuda_lib.launched("step_pre", rc)
    LAUNCHES["pre"] += 1
    return (org, direction, min_t, max_t), shadow


def shade(scene, rows, hit, occ, freeze: bool, resolving: bool):
    """The new packed rows [n, 39] from the rows the step began with,
    the trace's hit (dict t, u, v, prim) and, resolving, the pending
    shadow queries' answer `occ` (bool [n])."""
    dev = rows.device
    n = rows.shape[0]
    ptr, ld = _rows_arg(rows)
    face, mat = scene["face_fat"], scene["mat_fat"]
    light, cdf = scene["light_fat"], scene["light_cdf"]
    f32, i32 = torch.float32, torch.int32
    checks = [(face, f32, (face.shape[0], FACE_COLS)),
              (mat, f32, tuple(mat.shape)),
              (light, f32, (cdf.shape[0], LIGHT_COLS)),
              (cdf, f32, (cdf.shape[0],))]
    t, u, v = (hit[k].contiguous() for k in ("t", "u", "v"))
    prim = hit["prim"].to(i32).contiguous()
    checks += [(x, f32, (n,)) for x in (t, u, v)] + [(prim, i32, (n,))]
    occ_ptr = None
    if resolving:
        occ = occ.contiguous()
        checks.append((occ, torch.bool, (n,)))
        occ_ptr = occ.data_ptr()
    for x, dtype, shape in checks:
        cuda_lib.check_tensor("step", x, dtype, shape, dev)
    out = torch.empty((n, COLS), dtype=f32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = cuda_lib.function("step_shade", _SHADE_ARGS)(
            ptr, ld, n, int(freeze), int(resolving), t.data_ptr(),
            u.data_ptr(), v.data_ptr(), prim.data_ptr(), occ_ptr,
            face.data_ptr(), face.shape[0], mat.data_ptr(), mat.shape[1],
            mat.shape[0], light.data_ptr() if cdf.shape[0] else None,
            cdf.data_ptr() if cdf.shape[0] else None, cdf.shape[0],
            out.data_ptr(), stream)
    cuda_lib.launched("step_shade", rc)
    LAUNCHES["fused"] += 1
    return out

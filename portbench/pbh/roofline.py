"""Bytes a trace kernel's launch needs, counted from shapes, and the
card's peak against which its roofline share is stated.

Each ray is read once (origin, direction, min t, max t: 32 bytes) and its
answer written once (t, u, v, prim: 16 bytes); a dual launch also reads
the ray's shadow query (direction, min t, max t: 20 bytes) and writes its
occlusion byte. The backend's tables are read once per launch. Rays per
launch come from the launch's grid at 128 threads a block. The kernel's
operations are not counted (their count depends on each ray's walk), so
the bound is the bytes' alone and the share is one of bandwidth.
"""
from __future__ import annotations

import re

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet, at 700 W
THREADS = 128

# kernel symbol -> the committed tables its launch reads
TABLES = {
    "v4_kernel": ("dense_tris_v4", "dense_cluster_aabb_v4"),
    "v5_kernel": ("dense_tris_v4", "v5_node_aabb", "v5_node_meta"),
    "v5l_kernel": ("dense_tris_v5l", "v5_node_aabb", "v5_node_meta"),
}
RAY_BYTES = 32 + 16
SHADOW_BYTES = 20 + 1


def kernel_kind(name):
    """(symbol, dual) of a trace kernel's demangled name, or None."""
    for sym in ("v5l_kernel", "v5_kernel", "v4_kernel"):
        m = re.search(sym + r"<([^>]*)>", name)
        if m:
            flags = [a.strip() for a in m.group(1).split(",")]
            dual = sym != "v5l_kernel" and len(flags) > 1 and \
                flags[1] in ("true", "1")
            return sym, dual
    return None


def launch_bytes(name, grid, table_bytes):
    """Bytes of one launch of kernel `name` with grid `grid` ([x, y, z]),
    the scene's table sizes `table_bytes` {table: bytes}; None for a
    kernel that is not a trace kernel."""
    kind = kernel_kind(name)
    if kind is None or not grid:
        return None
    sym, dual = kind
    rays = int(grid[0]) * int(grid[1]) * int(grid[2]) * THREADS
    per_ray = RAY_BYTES + (SHADOW_BYTES if dual else 0)
    return rays * per_ray + sum(table_bytes.get(t, 0) for t in TABLES[sym])


def bound_share(kernels, table_bytes):
    """(bytes-bound seconds, device seconds) summed over the trace kernels
    among `kernels` (dicts with name, dur in microseconds, grid)."""
    bound, spent = 0.0, 0.0
    for k in kernels:
        b = launch_bytes(k["name"], k.get("grid"), table_bytes)
        if b is None:
            continue
        bound += b / HBM_BYTES_PER_S
        spent += k["dur"] * 1e-6
    return bound, spent

"""Host-side binned-SAH BVH builder producing flat, threaded node arrays
(numpy; port of pbrlab_tpu.geometry.bvh).

Nodes are emitted depth-first and threaded: every node stores `skip`, the
next depth-first node whose subtree is disjoint. Leaves hold a fixed-size
window [prim_offset, prim_offset + leaf_size) into a reordered primitive
array padded with -1; children are ordered along the split axis.

Builds of >= 4096 primitives go through the native C++ builder
(`geometry.native`, `csrc/bvh_builder.cpp`) unless the caller passes
use_native=False, as in the JAX package: its tree differs from this numpy
build's, so the routing must be the same for the slot ids to be.
"""
from __future__ import annotations

import dataclasses

import numpy as np

LEAF_SIZE = 4
N_BINS = 16
NATIVE_MIN_PRIMS = 4096  # builds this large go through the native builder


@dataclasses.dataclass
class BVH:
    """Flat threaded BVH.

    aabb_min/aabb_max: [Nn, 3] float32 node bounds
    skip:              [Nn] int32 next node on AABB miss (== Nn on exit path)
    prim_offset:       [Nn] int32 first slot in prim_ids for leaves, -1 internal
    prim_ids:          [Np] int32 reordered primitive ids, padded with -1
    """

    aabb_min: np.ndarray
    aabb_max: np.ndarray
    skip: np.ndarray
    prim_offset: np.ndarray
    prim_ids: np.ndarray

    @property
    def num_nodes(self) -> int:
        return int(self.skip.shape[0])


def build_bvh(prim_bmin: np.ndarray, prim_bmax: np.ndarray,
              leaf_size: int = LEAF_SIZE, use_native: bool = True) -> BVH:
    """Build from per-primitive AABBs [P, 3]. use_native=False keeps a
    large build on numpy (the instanced TLAS, as in the JAX package)."""
    P = prim_bmin.shape[0]
    if use_native and P >= NATIVE_MIN_PRIMS:
        from .native import build_bvh_native

        return build_bvh_native(prim_bmin, prim_bmax, leaf_size)
    if P == 0:
        return BVH(
            aabb_min=np.zeros((1, 3), np.float32),
            aabb_max=np.zeros((1, 3), np.float32),
            skip=np.asarray([1], np.int32),
            prim_offset=np.asarray([0], np.int32),
            prim_ids=np.full((leaf_size,), -1, np.int32),
        )
    prim_bmin = np.asarray(prim_bmin, np.float32)
    prim_bmax = np.asarray(prim_bmax, np.float32)
    centers = 0.5 * (prim_bmin + prim_bmax)

    node_bmin, node_bmax, node_skip, node_prim = [], [], [], []
    prim_ids_out = []

    def emit(ids: np.ndarray) -> int:
        """Emit subtree for primitive ids; returns node index."""
        my = len(node_skip)
        node_bmin.append(prim_bmin[ids].min(axis=0))
        node_bmax.append(prim_bmax[ids].max(axis=0))
        node_skip.append(-1)  # patched after subtree emitted
        node_prim.append(-1)

        if len(ids) <= leaf_size:
            node_prim[my] = len(prim_ids_out) * leaf_size
            slot = np.full((leaf_size,), -1, np.int64)
            slot[: len(ids)] = ids
            prim_ids_out.append(slot)
            node_skip[my] = len(node_skip)
            return my

        # binned SAH over the widest axis; fall back to median split
        c = centers[ids]
        ext = c.max(axis=0) - c.min(axis=0)
        axis = int(np.argmax(ext))
        left_ids = right_ids = None
        if ext[axis] > 1e-12:
            lo = c[:, axis].min()
            scale = N_BINS * (1.0 - 1e-6) / ext[axis]
            bins = np.minimum(((c[:, axis] - lo) * scale).astype(np.int64),
                              N_BINS - 1)
            counts = np.bincount(bins, minlength=N_BINS)
            binf = np.full((N_BINS, 3), np.inf, np.float32)
            bing = np.full((N_BINS, 3), -np.inf, np.float32)
            for b in range(N_BINS):
                sel = bins == b
                if counts[b]:
                    binf[b] = prim_bmin[ids[sel]].min(axis=0)
                    bing[b] = prim_bmax[ids[sel]].max(axis=0)
            lcnt = np.cumsum(counts)[:-1]
            rcnt = len(ids) - lcnt
            lmin = np.minimum.accumulate(binf, axis=0)[:-1]
            lmax = np.maximum.accumulate(bing, axis=0)[:-1]
            rmin = np.minimum.accumulate(binf[::-1], axis=0)[::-1][1:]
            rmax = np.maximum.accumulate(bing[::-1], axis=0)[::-1][1:]

            def area(mn, mx):
                d = np.maximum(mx - mn, 0.0)
                return d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]

            cost = lcnt * area(lmin, lmax) + rcnt * area(rmin, rmax)
            cost = np.where((lcnt == 0) | (rcnt == 0), np.inf, cost)
            best = int(np.argmin(cost))
            if np.isfinite(cost[best]):
                sel = bins <= best
                left_ids, right_ids = ids[sel], ids[~sel]
        if left_ids is None or len(left_ids) == 0 or len(right_ids) == 0:
            order = np.argsort(c[:, axis], kind="stable")
            half = len(ids) // 2
            left_ids, right_ids = ids[order[:half]], ids[order[half:]]

        emit(left_ids)
        emit(right_ids)
        node_skip[my] = len(node_skip)
        return my

    emit(np.arange(P, dtype=np.int64))
    return BVH(
        aabb_min=np.stack(node_bmin).astype(np.float32),
        aabb_max=np.stack(node_bmax).astype(np.float32),
        skip=np.asarray(node_skip, np.int32),
        prim_offset=np.asarray(node_prim, np.int32),
        prim_ids=np.concatenate(prim_ids_out).astype(np.int32),
    )


def triangle_bounds(v0, e1, e2):
    """Per-triangle AABBs (bmin, bmax) [F, 3] from the scene's v0 / e1 / e2
    columns."""
    v1 = v0 + e1
    v2 = v0 + e2
    bmin = np.minimum(np.minimum(v0, v1), v2)
    bmax = np.maximum(np.maximum(v0, v1), v2)
    return bmin, bmax

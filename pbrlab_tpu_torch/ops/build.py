"""Trace-table builds (numpy): the port's copies of the host-side builds in
pbrlab_tpu/ops/pallas/dense_v4.py (`pack_triangles_sah`) and
pbrlab_tpu/ops/pallas/dense_v5.py (`build_v5`, `leaf_major`,
`subtree_cut`), whose modules import jax.

One leaf-32 binned-SAH build gives the dense_v4 triangle table and its
cluster AABBs, the slot order that `scene.commit` reorders faces into,
and the BVH node arrays of the dense_v5 packet traversal; `leaf_major` and
`subtree_cut` add the large-scene (dense_v5l / v5s) tables.

Packed triangle rows [12, S] (S = M * CLUSTER slots) are the linear forms
0:3 n, 3 k0 = n.v0, 4:7 b1, 7 c1 = b1.v0, 8:11 b2, 11 c2 = b2.v0, with
t = (k0 - n.o) / (n.d); padding slots are all-zero rows (den = 0 -> miss).
"""
from __future__ import annotations

import numpy as np

from ..geometry.bvh import build_bvh

CLUSTER = 32  # triangles per cluster (BVH leaf slot window)
STACK = 128  # dense_v5 traversal stack entries (checked at build)


def build_v5(tri_v0: np.ndarray, tri_e1: np.ndarray, tri_e2: np.ndarray,
             cluster: int = CLUSTER):
    """Returns (packed [12, S], leaf_aabb [8, M], order [S] source face ids
    with -1 padding, node_aabb [6, Nn], node_meta [2, Nn]): node_meta[0] is
    the right-child index of an internal node (-1 for leaves), node_meta[1]
    the leaf slot base (-1 for internal nodes)."""
    if tri_v0.shape[0] == 0:
        packed = np.zeros((12, cluster), np.float32)
        leaf_aabb = np.zeros((8, 1), np.float32)
        leaf_aabb[0:3] = 1e30
        leaf_aabb[3:6] = -1e30
        node_aabb = np.zeros((6, 1), np.float32)
        node_aabb[0:3] = 1e30
        node_aabb[3:6] = -1e30
        node_meta = np.asarray([[-1], [0]], np.int32)
        return (packed, leaf_aabb, np.full((cluster,), -1, np.int32),
                node_aabb, node_meta)

    bmin = np.minimum(np.minimum(tri_v0, tri_v0 + tri_e1), tri_v0 + tri_e2)
    bmax = np.maximum(np.maximum(tri_v0, tri_v0 + tri_e1), tri_v0 + tri_e2)
    bvh = build_bvh(bmin, bmax, leaf_size=cluster)

    nn = bvh.num_nodes
    is_leaf = bvh.prim_offset >= 0
    right = np.full((nn,), -1, np.int32)
    internal = np.nonzero(~is_leaf)[0]
    if internal.size:
        # left child = n + 1; right child = skip[n + 1] (the next disjoint
        # subtree after the left child)
        right[internal] = bvh.skip[internal + 1]
        if not ((right[internal] > internal + 1).all()
                and (bvh.skip[right[internal]] == bvh.skip[internal]).all()):
            raise RuntimeError("BVH skip links do not give left/right children")
    depth = np.zeros((nn,), np.int32)
    for n in internal:
        depth[n + 1] = depth[n] + 1
        depth[right[n]] = depth[n] + 1
    if depth.max() + 2 >= STACK:
        raise RuntimeError(f"BVH depth {depth.max()} overflows the stack")

    node_meta = np.stack([right, bvh.prim_offset]).astype(np.int32)
    node_aabb = np.concatenate([bvh.aabb_min.T, bvh.aabb_max.T]).astype(
        np.float32)

    order = bvh.prim_ids.astype(np.int32)
    src = np.maximum(order, 0)
    v0 = tri_v0[src]
    e1 = tri_e1[src]
    e2 = tri_e2[src]
    n = np.cross(e1, e2)
    nrm2 = np.maximum((n * n).sum(-1, keepdims=True), 1e-30)
    b1 = np.cross(e2, n) / nrm2
    b2 = np.cross(n, e1) / nrm2
    packed = np.zeros((12, order.shape[0]), np.float32)
    packed[0:3] = n.T
    packed[3] = (n * v0).sum(-1)
    packed[4:7] = b1.T
    packed[7] = (b1 * v0).sum(-1)
    packed[8:11] = b2.T
    packed[11] = (b2 * v0).sum(-1)
    packed[:, order < 0] = 0.0  # padding: den = 0 -> miss

    # leaf k covers slots [k*cluster, (k+1)*cluster): prim windows are
    # emitted in depth-first order
    leaves = np.nonzero(is_leaf)[0]
    if not (bvh.prim_offset[leaves]
            == np.arange(leaves.shape[0]) * cluster).all():
        raise RuntimeError("BVH leaves are not in slot order")
    leaf_aabb = np.zeros((8, leaves.shape[0]), np.float32)
    leaf_aabb[0:3] = bvh.aabb_min[leaves].T
    leaf_aabb[3:6] = bvh.aabb_max[leaves].T
    return packed, leaf_aabb, order, node_aabb, node_meta


def pack_triangles_sah(tri_v0: np.ndarray, tri_e1: np.ndarray,
                       tri_e2: np.ndarray, cluster: int = CLUSTER):
    """dense_v4 tables alone: (packed [12, S], cluster_aabb [8, M],
    order [S]) — the same arrays as the first three of `build_v5`."""
    return build_v5(tri_v0, tri_e1, tri_e2, cluster)[:3]


def leaf_major(packed: np.ndarray, cluster: int = CLUSTER) -> np.ndarray:
    """[12, S] attr-major -> [M, 3, 128] leaf-major (the dense_v5l table):
    leaf m's 12 * 32 floats are contiguous, element (attr a, triangle k)
    at flat index a * cluster + k. The [3, 128] view is the JAX package's
    (its TPU DMA wanted 128-lane rows); the CUDA kernel reads it flat."""
    assert 12 * cluster % 128 == 0
    m = packed.shape[1] // cluster
    return np.ascontiguousarray(
        packed.reshape(12, m, cluster).transpose(1, 0, 2)).reshape(
            m, 12 * cluster // 128, 128)


def subtree_cut(node_aabb: np.ndarray, node_meta: np.ndarray,
                max_nodes: int = 64):
    """BFS cut of the BVH into <= max_nodes subtree roots, expanding the
    largest-surface node first. Returns (roots [C] int32 node ids in
    ascending order, aabb [6, C] float32): the dense_v5s schedule's
    subtrees, and the boxes of the integrator's compaction signature."""
    right = node_meta[0]
    cut = [0]
    while True:
        areas = []
        for n in cut:
            if right[n] < 0:
                areas.append(-1.0)  # leaf: cannot expand
            else:
                d = np.maximum(node_aabb[3:6, n] - node_aabb[0:3, n], 0.0)
                areas.append(float(d[0] * d[1] + d[1] * d[2] + d[2] * d[0]))
        j = int(np.argmax(areas))
        if areas[j] < 0.0 or len(cut) + 1 > max_nodes:
            break
        n = cut.pop(j)
        cut = [n + 1, int(right[n])] + cut
    roots = np.asarray(sorted(cut), np.int32)
    return roots, node_aabb[:, roots].astype(np.float32)

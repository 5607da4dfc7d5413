"""dense_v5i instanced triangle trace: two-level (TLAS/BLAS) packet walk of
1024-ray groups.

Port of pbrlab_tpu/ops/pallas/dense_v5i.py. One CUDA kernel, written by
hand for Hopper (`csrc/dense_v5i.cu`, `dense_v5i_trace`), replaces the
Pallas `_trace_kernel`: the closest hit (or any hit) per lane over a scene
of shared local triangle scenes (reference instancing,
raytracer_impl.cc:49-84). Each local scene is one BLAS built in local
space; the TLAS leaves are instances, each with its world-to-local affine
transform. `build_tlas` builds the TLAS on the host.

Node encoding (one array, TLAS nodes first, then every BLAS block):
node_meta[0] is the right child (-1 on a leaf); on a leaf node_meta[1] is
the packed slot base of a BLAS leaf (>= 0) or -(instance + 1) of a TLAS
leaf. inst_inv [12, K] holds each instance's world-to-local rows
(r00 r01 r02 t0 r10 ...), inst_meta [2, K] its BLAS root node and the
delta that turns a packed slot into its global instance-face id.

The walk is dense_v5's: a group of 1024 rays shares one stack of 160
(node, entry t) entries; a child is entered if any ray of the group can
enter it before its best t, near child first, and a popped node is
skipped once its entry t is beyond `gmax`, the group's largest best t. At
a TLAS leaf every ray goes into the instance's space (the direction is not
renormalised, so t stays comparable across instances) and the group walks
the BLAS on the same stack above the current pointer; `gmax` changes only
at BLAS leaves. `_walk_ref` is the plain torch version: every group walks
as the Pallas body does, all groups in lock-step, one popped node per
step. `dense_trace_v5i` takes the kernel for CUDA tensors and `_walk_ref`
for CPU tensors; `dense_trace_v5i_ref` runs `_walk_ref` on any device,
which is what the kernel is compared with on the card. `LAUNCHES` counts
kernel launches per mode.

Contract (as the JAX package): rays (org, direction, min_t, max_t) are
float32, max_t < min_t marks a dead lane; results are t, u, v (float32)
and prim (int32 global instance-face id, -1 and t = INF on a miss). The
JAX kernel carries prim as float32, exact below 2^24 (ROADMAP C8); here it
is int32 throughout. With any_hit only `prim >= 0` is meaningful.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core.math import INF
from ..geometry.bvh import build_bvh
from . import cuda_lib
from .dense_v4 import _pad
from .dense_v5 import _inv

GROUP = 1024  # rays per group: one packet walk per group
CLUSTER = 32  # triangles per BLAS leaf
STACK = 160  # stack entries shared by both levels (the build checks)
_BIG = 1e30

LAUNCHES = {"closest": 0, "any_hit": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P, _I, _P, _P, _I, _P, _P, _I, _P, _P, _P, _P, _I, _I, _P, _P, _P,
         _P, _P]


def build_tlas(inst_aabb_min: np.ndarray, inst_aabb_max: np.ndarray):
    """TLAS over instance world AABBs [K, 3]: leaf i holds one instance.

    Returns (node_aabb [6, Nt], node_right [Nt], node_inst [Nt]) with
    node_inst >= 0 on leaves. The numpy binned-SAH build with leaf_size=1,
    never the native builder, as in the JAX package."""
    bvh = build_bvh(inst_aabb_min, inst_aabb_max, leaf_size=1,
                    use_native=False)
    nn = bvh.num_nodes
    is_leaf = bvh.prim_offset >= 0
    right = np.full((nn,), -1, np.int32)
    internal = np.nonzero(~is_leaf)[0]
    if internal.size:
        right[internal] = bvh.skip[internal + 1]
        if not (bvh.skip[right[internal]] == bvh.skip[internal]).all():
            raise RuntimeError("TLAS skip links do not give right children")
    inst = np.full((nn,), -1, np.int32)
    leaves = np.nonzero(is_leaf)[0]
    inst[leaves] = bvh.prim_ids[bvh.prim_offset[leaves]]
    aabb = np.concatenate([bvh.aabb_min.T, bvh.aabb_max.T]).astype(np.float32)
    return aabb, right, inst


def _affine(a, x, y, z, w):
    """Rows r of the [12, G] affine a applied to lanes [G, 1024]:
    a0 x + a1 y + a2 z (+ a3), summed left to right as the Pallas body."""
    out = []
    for r in range(3):
        s = (a[4 * r][:, None] * x + a[4 * r + 1][:, None] * y
             + a[4 * r + 2][:, None] * z)
        out.append(s + a[4 * r + 3][:, None] if w else s)
    return out


class _Frame:
    """Per-lane slab terms [G, 1024] of the rays in one space."""

    def __init__(self, o, d):
        self.o, self.d = o, d
        self.inv = [_inv(c) for c in d]
        self.oi = [a * b for a, b in zip(o, self.inv)]

    def select(self, mask, other):
        """This frame where mask [G], else `other`'s terms."""
        m = mask[:, None]
        out = _Frame.__new__(_Frame)
        for key in ("o", "d", "inv", "oi"):
            setattr(out, key, [torch.where(m, a, b) for a, b in
                               zip(getattr(self, key), getattr(other, key))])
        return out

    def entry(self, node_aabb, node, mint, cap):
        """Group-wide entry t into box `node` [G]: the least slab entry t
        of the lanes that enter it before `cap`, else 1e30."""
        box = node_aabb[:, node]
        near, far = [], []
        for a in range(3):
            t0 = box[a][:, None] * self.inv[a] - self.oi[a]
            t1 = box[a + 3][:, None] * self.inv[a] - self.oi[a]
            near.append(torch.minimum(t0, t1))
            far.append(torch.maximum(t0, t1))
        tnear = torch.maximum(torch.maximum(near[0], near[1]),
                              torch.maximum(near[2], mint))
        tfar = torch.minimum(torch.minimum(far[0], far[1]),
                             torch.minimum(far[2], cap))
        return torch.where(tnear <= tfar * 1.00000024, tnear,
                           _BIG).amin(dim=1)


def _walk_ref(tris, node_aabb, node_meta, inst_inv, inst_meta, org,
              direction, min_t, max_t, any_hit=False):
    """Plain torch version of the kernel: each group walks its stack as the
    Pallas body does (the BLAS descent of an instance above the pointer
    `sp_base` where it entered), all groups in lock-step, one popped node
    per step; a group whose BLAS stack part is empty leaves the instance in
    a step of its own. Rays are whole groups. Returns (t, u, v, prim);
    t = max_t where nothing was hit."""
    g = org.shape[0] // GROUP
    dev = org.device
    i64 = torch.int64
    world = _Frame([c.reshape(g, GROUP) for c in org.unbind(1)],
                   [c.reshape(g, GROUP) for c in direction.unbind(1)])
    cur = world  # the frame of each group's current level
    mint = min_t.reshape(g, GROUP)
    maxt = max_t.reshape(g, GROUP)
    dead = maxt < mint
    best_t = maxt.clone()
    best_u = torch.zeros_like(best_t)
    best_v = torch.zeros_like(best_t)
    best_p = torch.full_like(best_t, -1, dtype=torch.int32)
    gmax = best_t.amax(dim=1)
    rows = torch.arange(g, device=dev)
    stk_id = torch.zeros((g, STACK), dtype=i64, device=dev)
    stk_tn = torch.zeros((g, STACK), dtype=torch.float32, device=dev)
    stk_tn[:, 0] = -1e30
    sp = (gmax >= 0.0).to(i64)
    in_blas = torch.zeros((g,), dtype=torch.bool, device=dev)
    sp_base = torch.zeros((g,), dtype=i64, device=dev)
    fid_delta = torch.zeros((g,), dtype=i64, device=dev)

    def push(mask, nid, ntn):
        nonlocal sp
        at = sp.clamp(max=STACK - 1)
        stk_id[rows, at] = torch.where(mask, nid, stk_id[rows, at])
        stk_tn[rows, at] = torch.where(mask, ntn, stk_tn[rows, at])
        sp = sp + mask.to(i64)

    while bool(((sp > 0) | in_blas).any()):
        # a group whose BLAS part of the stack is empty leaves the instance;
        # any-hit: when every live lane has a hit the whole walk ends
        leave = in_blas & (sp <= sp_base)
        if bool(leave.any()):
            back = sp_base
            if any_hit:
                done = ((best_p >= 0) | dead).all(dim=1)
                back = torch.where(done, 0, sp_base)
            sp = torch.where(leave, back, sp)
            in_blas = in_blas & ~leave
            cur = world.select(~in_blas, cur)
        act = sp > 0
        sp = sp - act.to(i64)
        top = sp.clamp(min=0)
        node = stk_id[rows, top]
        live = act & (stk_tn[rows, top] * (1.0 - 1e-6) - 1e-6 <= gmax)
        right = node_meta[0][node].to(i64)
        inner = live & (right >= 0)
        tlas_leaf = live & (right < 0) & ~in_blas
        blas_leaf = live & (right < 0) & in_blas
        if bool(blas_leaf.any()):
            base = node_meta[1][node].clamp(min=0).to(i64)
            slot = base[:, None] + torch.arange(CLUSTER, device=dev)
            (nx, ny, nz, k0, b1x, b1y, b1z, c1,
             b2x, b2y, b2z, c2) = tris[:, slot][:, :, None, :].unbind(0)
            ox, oy, oz = (x[..., None] for x in cur.o)
            dx, dy, dz = (x[..., None] for x in cur.d)
            num = k0 - (ox * nx + oy * ny + oz * nz)  # [G, 1024, 32]
            t = num / (dx * nx + dy * ny + dz * nz)
            u = (ox * b1x + oy * b1y + oz * b1z - c1) \
                + t * (dx * b1x + dy * b1y + dz * b1z)
            v = (ox * b2x + oy * b2y + oz * b2z - c2) \
                + t * (dx * b2x + dy * b2y + dz * b2z)
            ok = ((u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
                  & (t >= mint[..., None]))
            # the first k of least t, then the kernel's strict t < best_t:
            # what the in-order loop over k with a strict test keeps
            tk, k = torch.where(ok, t, float("inf")).min(dim=2)
            better = blas_leaf[:, None] & (tk < best_t)
            kk = k[..., None]
            best_u = torch.where(better, torch.gather(u, 2, kk)[..., 0],
                                 best_u)
            best_v = torch.where(better, torch.gather(v, 2, kk)[..., 0],
                                 best_v)
            best_p = torch.where(
                better, (base + fid_delta)[:, None].to(torch.int32)
                + k.to(torch.int32), best_p)
            best_t = torch.where(better, tk, best_t)
            gmax = torch.where(blas_leaf, best_t.amax(dim=1), gmax)
            if any_hit:
                done = ((best_p >= 0) | dead).all(dim=1)
                sp = torch.where(blas_leaf & done, sp_base, sp)
        if bool(inner.any()):
            left = node + 1
            rnode = right.clamp(min=0)
            tn_l = cur.entry(node_aabb,
                             left.clamp(max=node_aabb.shape[1] - 1), mint,
                             best_t)
            tn_r = cur.entry(node_aabb, rnode, mint, best_t)
            l_far = tn_l > tn_r
            far_tn = torch.maximum(tn_l, tn_r)
            near_tn = torch.minimum(tn_l, tn_r)
            # far child first, near child second (popped first)
            push(inner & (far_tn < _BIG), torch.where(l_far, left, rnode),
                 far_tn)
            push(inner & (near_tn < _BIG), torch.where(l_far, rnode, left),
                 near_tn)
        if bool(tlas_leaf.any()):
            # rays into the instance's space, then its BLAS root on the
            # stack above sp_base
            inst = (-node_meta[1][node] - 1).clamp(min=0).to(i64)
            a = inst_inv[:, inst]  # [12, G]
            local = _Frame(_affine(a, *world.o, True),
                           _affine(a, *world.d, False))
            cur = local.select(tlas_leaf, cur)
            root = inst_meta[0][inst].to(i64)
            fid_delta = torch.where(tlas_leaf, inst_meta[1][inst].to(i64),
                                    fid_delta)
            sp_base = torch.where(tlas_leaf, sp, sp_base)
            in_blas = in_blas | tlas_leaf
            tn0 = cur.entry(node_aabb, root, mint, best_t)
            push(tlas_leaf & (tn0 < _BIG), root, tn0)
    return tuple(x.reshape(-1) for x in (best_t, best_u, best_v, best_p))


def _walk_cuda(tris, node_aabb, node_meta, inst_inv, inst_meta, org,
               direction, min_t, max_t, any_hit=False):
    """Launch the dense_v5i kernel on the current stream; same returns as
    `_walk_ref` (any_hit may stop a group at its first hits)."""
    dev = org.device
    n = org.shape[0]
    g = n // GROUP
    nn = node_aabb.shape[1]
    k = inst_inv.shape[1]
    f32, i32 = torch.float32, torch.int32
    for x, dtype, shape in (
            (tris, f32, (12, tris.shape[1])), (node_aabb, f32, (6, nn)),
            (node_meta, i32, (2, nn)), (inst_inv, f32, (12, k)),
            (inst_meta, i32, (2, k)), (org, f32, (n, 3)),
            (direction, f32, (n, 3)), (min_t, f32, (n,)),
            (max_t, f32, (n,))):
        cuda_lib.check_tensor("dense_v5i", x, dtype, shape, dev)
    if n != g * GROUP:
        raise ValueError(f"dense_v5i wants whole groups of {GROUP} rays; "
                         f"got {n}")
    t = torch.empty((n,), dtype=f32, device=dev)
    u = torch.empty_like(t)
    v = torch.empty_like(t)
    prim = torch.empty((n,), dtype=i32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = cuda_lib.function("dense_v5i_trace", _ARGS)(
            tris.data_ptr(), tris.shape[1], node_aabb.data_ptr(),
            node_meta.data_ptr(), nn, inst_inv.data_ptr(),
            inst_meta.data_ptr(), k, org.data_ptr(), direction.data_ptr(),
            min_t.data_ptr(), max_t.data_ptr(), int(any_hit), g,
            t.data_ptr(), u.data_ptr(), v.data_ptr(), prim.data_ptr(),
            stream)
    kind = "any_hit" if any_hit else "closest"
    cuda_lib.launched(f"dense_v5i {kind}", rc)
    LAUNCHES[kind] += 1
    return t, u, v, prim


def _trace(tables, org, direction, min_t, max_t, any_hit, plain):
    """Pad to whole groups, walk (the kernel on CUDA tensors unless plain),
    unpad."""
    n = org.shape[0]
    n_pad = (n + GROUP - 1) // GROUP * GROUP
    rays = [_pad(org, n_pad, 0.0), _pad(direction, n_pad, 1.0),
            _pad(min_t, n_pad, 0.0),
            torch.clamp(_pad(max_t, n_pad, -1.0), max=INF)]
    walk = _walk_cuda if org.is_cuda and not plain else _walk_ref
    t, u, v, prim = walk(*(x.contiguous() for x in tables), *rays,
                         any_hit=any_hit)
    hit = prim[:n] >= 0
    return {"t": torch.where(hit, t[:n], INF), "u": u[:n], "v": v[:n],
            "prim": prim[:n]}


def dense_trace_v5i(packed_tris, node_aabb, node_meta, inst_inv, inst_meta,
                    org, direction, min_t, max_t, any_hit=False):
    """Closest (or any) hit per lane over an instanced scene's i5_* tables
    -> dict(t, u, v, prim); prim is the global instance-face id."""
    return _trace((packed_tris, node_aabb, node_meta, inst_inv, inst_meta),
                  org, direction, min_t, max_t, any_hit, plain=False)


def dense_trace_v5i_ref(packed_tris, node_aabb, node_meta, inst_inv,
                        inst_meta, org, direction, min_t, max_t,
                        any_hit=False):
    """Plain torch version of `dense_trace_v5i` on any device."""
    return _trace((packed_tris, node_aabb, node_meta, inst_inv, inst_meta),
                  org, direction, min_t, max_t, any_hit, plain=True)

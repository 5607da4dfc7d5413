"""Plain torch twins of the per-ray walks of `csrc/per_ray.cuh`: the BVH
walk, which the dense_v5, dense_v5l and dense_v5i kernels run
(`walk_ref`), and the cluster walk (`cluster_walk`) of the dense_v4
kernels (`cluster_walk_ref`), the dense_curve kernel and the legacy dense
v1, v2 and v3 kernels (their modules hold the cluster tests; `diff_enter`
and `beats_ref` are the legacy slab test and tie rules they share).

Every lane walks alone: it has its own stack of (node, entry t) entries
(`[N, stack]` ids and entry t) and its own pointer. Each step pops one
entry for every lane whose stack is not empty; inner-node lanes, TLAS-leaf
lanes and BLAS-leaf lanes of the step are handled as index subsets, each
lane as the kernel's thread handles it:

* a popped node is skipped once `tn (1 - 1e-6) - 1e-6 > best t`, the
  lane's own best t;
* an inner node: both children's slab tests against the lane's best t,
  the far child pushed first, the near one second (popped first);
* a TLAS leaf (node_meta[1] = -(instance + 1), instanced tables only):
  the ray mapped into the instance's space (rows r00 r01 r02 t0 ... of
  inst_inv, summed left to right; the direction not renormalised, the
  slab reciprocals recomputed), the BLAS root pushed above the lane's
  pointer `sp_base`; the lane goes back to world space when its pointer
  drops to sp_base again;
* a BLAS leaf (node_meta[1] = slot base >= 0): its 32 triangles as one
  [n, 32] block, keeping the smallest valid t below the lane's best t,
  the lowest k on ties, which is what the kernel's in-order loop with a
  strict `<` keeps. Any-hit ends the lane's walk after the first leaf that
  gives it a hit.

The cluster walk has no tree: in chunks of LIST clusters in cluster
order, each lane slab-tests its ray against the chunk's boxes, sorts the
clusters it enters by entry t (stable: ties by the lower cluster id) and
walks them front to back with the same cull; step j tests the j-th
cluster of every lane still walking.

The float operations are the kernels', in their order, so on the card a
kernel and its twin agree to the bit. The twins optionally count, per
lane, the primitive tests, ray-box tests and instance transforms they
did.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

CLUSTER = 32  # triangles per leaf
LIST = 256  # clusters in a lane's list (per_ray.cuh kList): one chunk
_BIG = 1e30


def _inv(d):
    """Safe reciprocal of a direction component (|d| < 1e-12 -> +-1e-12)."""
    return 1.0 / torch.where(torch.abs(d) < 1e-12,
                             torch.where(d < 0.0, -1e-12, 1e-12), d)


def _frame(o, d):
    """[n, 12] per lane: origin, direction, 1 / direction, origin /
    direction (the slab-test terms)."""
    inv = _inv(d)
    return torch.cat([o, d, inv, o * inv], dim=1)


def _slab(node_aabb, node, f, mint, cap):
    """Entry t of each lane's ray (frame rows f) into box node [n] if it
    enters before cap, else 1e30."""
    return _enter(node_aabb[:, node], f.T, mint, cap)


def _enter(box, fr, mint, cap):
    """The slab test of `per_ray::slab`: entry t of rays (frame columns
    fr [12, ...]) into boxes (box [6, ...]; both broadcast against mint
    and cap) if they enter before cap, else 1e30."""
    near, far = [], []
    for a in range(3):
        t0 = box[a] * fr[6 + a] - fr[9 + a]
        t1 = box[a + 3] * fr[6 + a] - fr[9 + a]
        near.append(torch.minimum(t0, t1))
        far.append(torch.maximum(t0, t1))
    tnear = torch.maximum(torch.maximum(near[0], near[1]),
                          torch.maximum(near[2], mint))
    tfar = torch.minimum(torch.minimum(far[0], far[1]),
                         torch.minimum(far[2], cap))
    return torch.where(tnear <= tfar * 1.00000024, tnear, _BIG)


def to_instance(inst_inv, k, o, d):
    """Rays o, d [n, 3] in the space of instances k [n]: the rows
    r00 r01 r02 t0 r10 ... of inst_inv [12, K], summed left to right as
    the Pallas body; the direction is not renormalised."""
    a = inst_inv[:, k]
    o, d = o.unbind(1), d.unbind(1)
    lo = [((a[4 * r] * o[0] + a[4 * r + 1] * o[1]) + a[4 * r + 2] * o[2])
          + a[4 * r + 3] for r in range(3)]
    ld = [(a[4 * r] * d[0] + a[4 * r + 1] * d[1]) + a[4 * r + 2] * d[2]
          for r in range(3)]
    return torch.stack(lo, 1), torch.stack(ld, 1)


def attr_major_rows(tris):
    """Leaf rows of an attr-major [12, S] table: slot bases [n] -> 12
    tensors [n, 32]."""
    def rows(base):
        slot = base[:, None] + torch.arange(CLUSTER, device=tris.device)
        return tris[:, slot].unbind(0)
    return rows


def leaf_major_rows(tris):
    """Leaf rows of a leaf-major [M, 3, 128] table (leaf m's attribute a
    of triangle k at m * 384 + a * 32 + k)."""
    table = tris.reshape(-1, 12, CLUSTER)

    def rows(base):
        return table[base // CLUSTER].unbind(1)
    return rows


def leaf_ref(rows, ln, base, id0, f, mint, best):
    """The 32 triangles of the leaves at slot bases base [k] for lanes ln
    [k] (frame rows f [k, 12], min t mint [k]) as one [k, 32] block: each
    lane keeps the smallest valid t below its best t, the lowest k on
    ties, which is what the kernel's in-order loop with a strict `<`
    keeps. best = (t, u, v, prim) [N], updated in place; a hit's prim is
    id0 + k."""
    best_t, best_u, best_v, best_p = best
    (nx, ny, nz, k0, b1x, b1y, b1z, c1, b2x, b2y, b2z, c2) = rows(base)
    ox, oy, oz, dx, dy, dz = (f[:, c:c + 1] for c in range(6))
    t = (k0 - (ox * nx + oy * ny + oz * nz)) \
        / (dx * nx + dy * ny + dz * nz)  # [k, 32]
    u = (ox * b1x + oy * b1y + oz * b1z - c1) \
        + t * (dx * b1x + dy * b1y + dz * b1z)
    v = (ox * b2x + oy * b2y + oz * b2z - c2) \
        + t * (dx * b2x + dy * b2y + dz * b2z)
    ok = (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t >= mint[:, None])
    tk, kk = torch.where(ok, t, float("inf")).min(dim=1)
    better = tk < best_t[ln]
    w, kw = ln[better], kk[better][:, None]
    best_t[w] = tk[better]
    best_u[w] = torch.gather(u[better], 1, kw)[:, 0]
    best_v[w] = torch.gather(v[better], 1, kw)[:, 0]
    best_p[w] = (id0 + kk)[better].to(torch.int32)


def walk_ref(rows, node_aabb, node_meta, org, direction, min_t, max_t,
             root, stack, any_hit=False, inst_inv=None, inst_meta=None,
             counts=False):
    """Each lane's walk from node root [N] (or an int). `rows(base)` gives
    a leaf's 12 attribute rows; inst_inv / inst_meta are the instance
    tables of a two-level walk (None: every leaf is a triangle leaf).
    Returns (t, u, v, prim) and, with counts, [N, 3] int64 per lane:
    ray-triangle tests, ray-box tests, transforms. t = max_t where nothing
    was hit; a lane with max_t < min_t walks nothing."""
    n = org.shape[0]
    dev = org.device
    i64 = torch.int64
    world = _frame(org, direction)
    cur = world.clone()  # the frame of each lane's current level
    best_t = max_t.clone()
    best_u = torch.zeros_like(best_t)
    best_v = torch.zeros_like(best_t)
    best_p = torch.full((n,), -1, dtype=torch.int32, device=dev)
    stk_id = torch.zeros((n, stack), dtype=i64, device=dev)
    stk_tn = torch.zeros((n, stack), dtype=torch.float32, device=dev)
    stk_id[:, 0] = root
    stk_tn[:, 0] = -1e30
    sp = (max_t >= min_t).to(i64)
    sp_base = torch.full((n,), -1, dtype=i64, device=dev)
    fid = torch.zeros((n,), dtype=i64, device=dev)
    work = torch.zeros((n, 3), dtype=i64, device=dev)
    overflow = torch.zeros((), dtype=torch.bool, device=dev)

    def push(ln, nid, ntn):
        nonlocal overflow
        at = sp[ln]
        overflow = overflow | (at >= stack).any()
        at = at.clamp(max=stack - 1)
        stk_id[ln, at] = nid
        stk_tn[ln, at] = ntn
        sp[ln] = at + 1

    while True:
        lane = torch.nonzero(sp > 0).squeeze(1)
        if lane.numel() == 0:
            break
        top = sp[lane]
        if inst_inv is not None:  # an instance's BLAS is done
            back = lane[top == sp_base[lane]]
            cur[back] = world[back]
            sp_base[back] = -1
        top = top - 1
        sp[lane] = top
        node = stk_id[lane, top]
        # relative + absolute pad: as tolerant as the slab test
        live = stk_tn[lane, top] * (1.0 - 1e-6) - 1e-6 <= best_t[lane]
        right = node_meta[0][node].to(i64)
        base = node_meta[1][node].to(i64)

        sel = live & (right >= 0)
        if bool(sel.any()):  # inner nodes
            ln, nd, rt = lane[sel], node[sel], right[sel]
            f, mint, cap = cur[ln], min_t[ln], best_t[ln]
            left = nd + 1
            tn_l = _slab(node_aabb, left, f, mint, cap)
            tn_r = _slab(node_aabb, rt, f, mint, cap)
            l_far = tn_l > tn_r
            far_tn = torch.maximum(tn_l, tn_r)
            near_tn = torch.minimum(tn_l, tn_r)
            # far child first, near child second (popped first)
            for nid, ntn in ((torch.where(l_far, left, rt), far_tn),
                             (torch.where(l_far, rt, left), near_tn)):
                ok = ntn < _BIG
                push(ln[ok], nid[ok], ntn[ok])
            if counts:
                work[ln, 1] += 2

        if inst_inv is not None:
            sel = live & (right < 0) & (base < 0)
            if bool(sel.any()):  # TLAS leaves: into the instance's space
                ln = lane[sel]
                k = -base[sel] - 1
                f = _frame(*to_instance(inst_inv, k, org[ln], direction[ln]))
                cur[ln] = f
                blas = inst_meta[0][k].to(i64)
                fid[ln] = inst_meta[1][k].to(i64)
                sp_base[ln] = sp[ln]
                tn0 = _slab(node_aabb, blas, f, min_t[ln], best_t[ln])
                ok = tn0 < _BIG
                push(ln[ok], blas[ok], tn0[ok])
                if counts:
                    work[ln, 1] += 1
                    work[ln, 2] += 1

        sel = live & (right < 0) & (base >= 0)
        if bool(sel.any()):  # triangle leaves
            ln, b = lane[sel], base[sel]
            leaf_ref(rows, ln, b, b + fid[ln], cur[ln], min_t[ln],
                     (best_t, best_u, best_v, best_p))
            if any_hit:  # the walk ends after the first leaf with a hit
                sp[ln[best_p[ln] >= 0]] = 0
            if counts:
                work[ln, 0] += CLUSTER
    if bool(overflow):
        raise RuntimeError(f"per-ray walk: a lane's stack passed {stack} "
                           "entries")
    out = (best_t, best_u, best_v, best_p)
    return (*out, work) if counts else out


def cluster_walk(m, size, enter, visit, min_t, max_t, any_hit=False,
                 counts=False):
    """Each lane's walk of m clusters, `per_ray::cluster_walk`: in chunks of
    LIST clusters in cluster order, the lane's entry t into each box of the
    chunk, `enter(c0, c1, cap)` -> [N, c1 - c0] (1e30 where the ray does
    not enter before cap [N], the lane's best t so far), sorted (stable:
    ties by the lower cluster id); then front to back `visit(ln, c, best)`
    tests cluster c [k] for lanes ln [k] (`size` primitives, updating best
    = (t, u, v, prim) [N] in place) until `tn (1 - 1e-6) - 1e-6 > best
    t`; then the next chunk. With any_hit a lane's walk ends after the
    first cluster that gives it a hit. Step j of a chunk tests the j-th
    cluster of every lane still walking. Returns (t, u, v, prim) and, with
    counts, [N, 3] int64 per lane: primitive tests, box tests, 0. t =
    max_t where nothing was hit; a lane with max_t < min_t tests nothing."""
    n = max_t.shape[0]
    dev = max_t.device
    best = (max_t.clone(), torch.zeros_like(max_t), torch.zeros_like(max_t),
            torch.full((n,), -1, dtype=torch.int32, device=dev))
    done = ~(max_t >= min_t)  # a dead lane tests nothing
    work = torch.zeros((n, 3), dtype=torch.int64, device=dev)
    for c0 in range(0, m, LIST):
        if bool(done.all()):
            break
        c1 = min(c0 + LIST, m)
        key, order = torch.sort(torch.where(done[:, None], _BIG,
                                            enter(c0, c1, best[0])),
                                dim=1, stable=True)
        cnt = (key < _BIG).sum(dim=1)
        if counts:
            work[:, 1] += (~done) * (c1 - c0)
        for j in range(int(cnt.max())):
            # the lane's own cull: later clusters enter no earlier
            ln = torch.nonzero((j < cnt) & ~done & (
                key[:, j] * (1.0 - 1e-6) - 1e-6 <= best[0])).squeeze(1)
            if ln.numel() == 0:
                break
            visit(ln, order[ln, j] + c0, best)
            if counts:
                work[ln, 0] += size
            if any_hit:  # the walk ends after the first cluster with a hit
                done = done | (best[3] >= 0)
    return (*best, work) if counts else best


def cluster_walk_ref(tris, cluster_aabb, org, direction, min_t, max_t,
                     any_hit=False, counts=False):
    """The dense_v4 kernels' walk (`cluster_walk` with M <= LIST: one
    chunk): the slab test of `per_ray::slab` against every box (rows 0:6 of
    cluster_aabb [>= 6, M]) capped at max_t, then the 32 triangles of
    cluster c (slots 32 c + k of the attr-major table tris [12, 32 M])
    with `leaf_ref`. Returns as `cluster_walk` (ray-triangle tests, M
    ray-box tests per live lane)."""
    f = _frame(org, direction)
    rows = attr_major_rows(tris)

    def enter(c0, c1, cap):
        return _enter(cluster_aabb[:6, None, c0:c1], f.T[:, :, None],
                      min_t[:, None], cap[:, None])

    def visit(ln, c, best):
        base = c * CLUSTER
        leaf_ref(rows, ln, base, base, f[ln], min_t[ln], best)

    return cluster_walk(cluster_aabb.shape[1], CLUSTER, enter, visit, min_t,
                        max_t, any_hit=any_hit, counts=counts)


def diff_enter(aabb, org, inv, min_t):
    """`enter` of `cluster_walk` for the legacy dense kernels' slab test
    (`per_ray::slab_diff`: dense_curve, dense v1-v3): the entry t of each
    lane's ray (org [N, 3], inv the Pallas bodies' 1 / direction [N, 3])
    into boxes c0..c1 - 1 of aabb [>= 6, M] in the `(box - o) * inv` form,
    where `tnear <= tfar (1 + 2.4e-7)`, `tfar >= min_t` and `tnear <=
    cap`; else 1e30."""
    o = [org[:, k:k + 1] for k in range(3)]
    iv = [inv[:, k:k + 1] for k in range(3)]
    mint = min_t[:, None]

    def enter(c0, c1, cap):
        box = aabb[:6, c0:c1]
        t0 = [(box[k] - o[k]) * iv[k] for k in range(3)]
        t1 = [(box[k + 3] - o[k]) * iv[k] for k in range(3)]
        tnear = torch.maximum(torch.maximum(torch.minimum(t0[0], t1[0]),
                                            torch.minimum(t0[1], t1[1])),
                              torch.minimum(t0[2], t1[2]))
        tfar = torch.minimum(torch.minimum(torch.maximum(t0[0], t1[0]),
                                           torch.maximum(t0[1], t1[1])),
                             torch.maximum(t0[2], t1[2]))
        ok = ((tnear <= tfar * 1.00000024) & (tfar >= mint)
              & (tnear <= cap[:, None]))
        return torch.where(ok, tnear, _BIG)
    return enter


class TieRule(NamedTuple):
    """A legacy cluster kernel's tie rule (`per_ray::TieRule`): a valid
    candidate beats the lane's best when its t is smaller, or equal with
    a lower slot (id mod `slots`), or with `by_id` an equal slot and a
    lower id; with `up_to` a candidate at the lane's initial best (max t,
    while it has no hit) counts, so the bound on t is inclusive."""
    slots: int = 8
    by_id: bool = False
    up_to: bool = False


SLOT_RULE = TieRule()  # dense_curve and dense_v3: (t, id mod 8), first seen


def beats_ref(ln, ids, t, ok, u, v, best, rule=SLOT_RULE):
    """Lanes ln [k] against a block of candidates [k, B] (prim ids,
    increasing along the block, t, validity up to the bound on t, u, v)
    in order, with `rule` (a TieRule). So each lane keeps the
    lexicographic minimum of (t, id mod slots), then the lowest id
    (by_id) or the first visited. best = (t, u, v, prim) [N], updated in
    place."""
    best_t, best_u, best_v, best_p = best
    bt, bp = best_t[ln], best_p[ln]
    tie = (bp >= 0) | rule.up_to
    ok = ok & ((t < bt[:, None]) | ((t == bt[:, None]) & tie[:, None]))
    tk = torch.where(ok, t, float("inf")).amin(dim=1)
    width, mask = t.shape[1], rule.slots - 1
    # among the least t: the lowest slot, then the first in the block (its
    # lowest id)
    rank = (ids & mask) * width + torch.arange(width, device=t.device)
    none = rule.slots * width
    key = torch.where(ok & (t == tk[:, None]), rank, none).amin(dim=1)
    slot, kw = key // width, (key % width)[:, None]
    pid = torch.gather(ids, 1, kw)[:, 0]
    bslot = bp & mask
    better = (tk < bt) | (bp < 0) | (slot < bslot)
    if rule.by_id:
        better |= (slot == bslot) & (pid < bp)
    better &= key < none
    w = ln[better]
    best_t[w] = tk[better]
    best_u[w] = torch.gather(u[better], 1, kw[better])[:, 0]
    best_v[w] = torch.gather(v[better], 1, kw[better])[:, 0]
    best_p[w] = pid[better].to(torch.int32)

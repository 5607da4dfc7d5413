"""The per-ray walk of dense_v5i and dense_v5l against an independent
per-lane walk in numpy.

`pbrlab_tpu_torch/ops/per_ray.py` is the plain torch twin of the per-ray
kernels: every lane pops its own stack, all lanes advanced together one
entry per step. Here each lane is walked on its own by a recursion in
numpy float32 (`NumpyWalk`), written from the walk's rules and not from
the twin's code: visit the near child's subtree, then the far child if its
entry t still passes the lane's cull; at a TLAS leaf go into the
instance's space and walk its BLAS; test a leaf's 32 triangles in order
with a strict `t < best t`; any-hit stops after the first leaf with a hit.
Both use the kernels' float32 operations in their order, so the closest t
must be equal (u and v too), prim equal wherever no other triangle gives
the lane the same t, and the per-lane counts of ray-triangle tests,
ray-box tests and transforms equal.

Cases: the textured 9-instance scene of test_torch_instancing.py
(closest and any-hit), the subdiv=1 scene of test_torch_dense_v5.py
through the leaf-major table from the root and from per-group roots (ray
i from roots[i // 1024]), any-hit masks against the closest hit's with
dead and padded lanes, and a synthetic two-level scene at the stack bound
that `build_instanced` checks (TLAS depth + deepest BLAS + 4 < STACK):
each level a chain whose near child is the next inner node and whose far
child is a leaf, so a lane's stack reaches TLAS depth + BLAS depth + 1
entries.

Against JAX's interpret-mode kernels the twins are held in
test_torch_instancing.py and test_torch_dense_v5.py. The requires_cuda
test holds the kernel bit-equal to the twin on the stack-bound scene; it
imports no JAX, so it runs on the card with `python -m pytest
tests/test_torch_per_ray.py --noconftest -o addopts="" -m requires_cuda`.
"""
import numpy as np
import pytest
import torch

from pbrlab_tpu_torch.core.math import INF
from pbrlab_tpu_torch.ops import dense_v5, dense_v5i, per_ray
from pbrlab_tpu_torch.ops.build import build_v5, leaf_major
from pbrlab_tpu_torch.scene.demo import build_demo_scene
from pbrlab_tpu_torch.scene.instanced import _depth
from test_torch_dense_v5 import _rays as _v5_rays
from test_torch_instancing import I5_KEYS, _builder, _port
from test_torch_instancing import _rays as _inst_rays

F = np.float32
BIG = F(1e30)


class NumpyWalk:
    """Per-lane recursive walk of a (two-level) BVH in numpy float32.

    rows(base) -> [12, 32] leaf rows; aabb [6, Nn], meta [2, Nn] as the
    kernels read them; inst_inv [12, K] / inst_meta [2, K] for a two-level
    table (TLAS leaves have meta[1] = -(instance + 1))."""

    def __init__(self, rows, aabb, meta, inst_inv=None, inst_meta=None):
        self.rows = rows
        self.lo = np.ascontiguousarray(aabb[0:3].T, F)
        self.hi = np.ascontiguousarray(aabb[3:6].T, F)
        self.right, self.base = (np.asarray(m) for m in meta)
        self.inst_inv, self.inst_meta = inst_inv, inst_meta

    @staticmethod
    def frame(o, d):
        e = np.where(np.abs(d) < F(1e-12),
                     np.where(d < 0, F(-1e-12), F(1e-12)), d).astype(F)
        inv = F(1) / e
        return o, d, inv, o * inv

    def slab(self, node, fr, mint, cap):
        _, _, inv, oi = fr
        t0 = self.lo[node] * inv - oi
        t1 = self.hi[node] * inv - oi
        near, far = np.minimum(t0, t1), np.maximum(t0, t1)
        tnear = np.maximum(np.maximum(near[0], near[1]),
                           np.maximum(near[2], mint))
        tfar = np.minimum(np.minimum(far[0], far[1]), np.minimum(far[2], cap))
        return tnear if tnear <= tfar * F(1.00000024) else BIG

    def leaf(self, base, fid, fr, s):
        o, d = fr[0], fr[1]
        nx, ny, nz, k0, b1x, b1y, b1z, c1, b2x, b2y, b2z, c2 = self.rows(base)
        with np.errstate(all="ignore"):
            t = (k0 - (o[0] * nx + o[1] * ny + o[2] * nz)) \
                / (d[0] * nx + d[1] * ny + d[2] * nz)
            u = (o[0] * b1x + o[1] * b1y + o[2] * b1z - c1) \
                + t * (d[0] * b1x + d[1] * b1y + d[2] * b1z)
            v = (o[0] * b2x + o[1] * b2y + o[2] * b2z - c2) \
                + t * (d[0] * b2x + d[1] * b2y + d[2] * b2z)
        s["tri"] += 32
        for k in range(32):
            if u[k] >= 0 and v[k] >= 0 and u[k] + v[k] <= 1 \
                    and t[k] >= s["mint"]:
                if t[k] < s["t"]:
                    s.update(t=t[k], u=u[k], v=v[k], prim=base + k + fid)
                elif t[k] == s["t"]:
                    s["tie"] = True

    def visit(self, node, tn, fr, fid, s):
        if s["done"] or not tn * F(0.999999) - F(1e-6) <= s["t"]:
            return
        right, base = int(self.right[node]), int(self.base[node])
        if right >= 0:
            s["box"] += 2
            tl = self.slab(node + 1, fr, s["mint"], s["t"])
            tr = self.slab(right, fr, s["mint"], s["t"])
            near, far = ((right, tr), (node + 1, tl)) if tl > tr \
                else ((node + 1, tl), (right, tr))
            for child, tc in (near, far):
                if tc < BIG:
                    self.visit(child, tc, fr, fid, s)
        elif base < 0:  # a TLAS leaf: the BLAS in the instance's space
            k = -base - 1
            a = self.inst_inv[:, k]
            o, d = s["world"][0], s["world"][1]
            lo = np.array([((a[4 * r] * o[0] + a[4 * r + 1] * o[1])
                            + a[4 * r + 2] * o[2]) + a[4 * r + 3]
                           for r in range(3)], F)
            ld = np.array([(a[4 * r] * d[0] + a[4 * r + 1] * d[1])
                           + a[4 * r + 2] * d[2] for r in range(3)], F)
            local = self.frame(lo, ld)
            s["box"] += 1
            s["xform"] += 1
            root = int(self.inst_meta[0][k])
            t0 = self.slab(root, local, s["mint"], s["t"])
            if t0 < BIG:
                self.visit(root, t0, local, int(self.inst_meta[1][k]), s)
        else:
            self.leaf(base, fid, fr, s)
            s["done"] = s["any_hit"] and s["prim"] >= 0

    def trace(self, org, direction, min_t, max_t, roots, any_hit=False):
        """Per lane: t, u, v, prim, tie (another triangle gave the same
        t), and the counts [n, 3] (triangle tests, box tests,
        transforms)."""
        n = org.shape[0]
        out = {k: [] for k in ("t", "u", "v", "prim", "tie", "work")}
        for i in range(n):
            fr = self.frame(org[i], direction[i])
            s = dict(t=max_t[i], u=F(0), v=F(0), prim=-1, tie=False,
                     mint=min_t[i], tri=0, box=0, xform=0, done=False,
                     any_hit=any_hit, world=fr)
            if max_t[i] >= min_t[i]:
                self.visit(int(roots[i]), F(-1e30), fr, 0, s)
            for k in ("t", "u", "v", "prim", "tie"):
                out[k].append(s[k])
            out["work"].append((s["tri"], s["box"], s["xform"]))
        return {k: np.asarray(v) for k, v in out.items()}


def _check(twin, want):
    """Twin (t, u, v, prim, counts) against the numpy walk."""
    t, u, v, prim, work = (x.numpy() for x in twin)
    np.testing.assert_array_equal(t, want["t"].astype(F))
    unique = ~want["tie"]
    assert unique.mean() > 0.9
    np.testing.assert_array_equal(prim[unique], want["prim"][unique])
    same = prim == want["prim"]
    np.testing.assert_array_equal(u[same], want["u"][same].astype(F))
    np.testing.assert_array_equal(v[same], want["v"][same].astype(F))
    np.testing.assert_array_equal(work, want["work"])


@pytest.fixture(scope="module")
def textured_np():
    return _port().instanced.build_instanced(_builder(_port(), 9, "textured"))


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_v5i_twin_matches_numpy_walk(textured_np, any_hit):
    rays = _inst_rays(textured_np, 300, 11)
    tables = [np.asarray(textured_np[k]) for k in I5_KEYS]
    # every BLAS leaf's 32 slots start at a multiple of 32: the kernel
    # reads each attribute of 4 triangles as one float4
    blas = tables[2][1][(tables[2][0] < 0) & (tables[2][1] >= 0)]
    assert (blas % 32 == 0).all() and tables[0].shape[1] % 32 == 0
    walk = NumpyWalk(lambda b: tables[0][:, b:b + 32], *tables[1:])
    want = walk.trace(*rays, np.zeros(300, np.int64), any_hit)
    got = dense_v5i._walk_ref(*(torch.from_numpy(x) for x in tables),
                              *(torch.from_numpy(r) for r in rays),
                              any_hit=any_hit, counts=True)
    _check(got, want)
    hit = want["prim"] >= 0
    assert hit.mean() > 0.15 and not hit[::7].any()  # dead lanes
    assert want["work"][:, 2].sum() > 0  # lanes enter instances


@pytest.fixture(scope="module")
def v5l_np():
    scene = build_demo_scene(subdiv=1)[0]
    return (leaf_major(scene["dense_tris_v4"]), scene["v5_node_aabb"],
            scene["v5_node_meta"], scene)


def _v5l_rays(scene, n, seed):
    """test_torch_dense_v5.py's rays without the shadow query: dead and
    clipped lanes among them."""
    return _v5_rays(scene, n, seed)[:4]


@pytest.mark.parametrize("rooted", [False, True], ids=["root0", "roots"])
def test_v5l_twin_matches_numpy_walk(v5l_np, rooted):
    """From node 0, or each 1024-ray group from its own root (three groups
    here: the root's left child, the whole tree, its right child)."""
    table, aabb, meta, scene = v5l_np
    n = 2500
    rays = _v5l_rays(scene, n, 12)
    roots = None
    lane_root = np.zeros(n, np.int64)
    if rooted:
        roots = np.array([1, 0, meta[0][0]], np.int32)
        lane_root = roots[np.arange(n) // 1024]
    flat = table.reshape(-1, 12, 32)
    walk = NumpyWalk(lambda b: flat[b // 32], aabb, meta)
    want = walk.trace(*rays, lane_root)
    pad = 3072 - n  # the wrappers pad to whole groups: so does this call
    padded = [np.concatenate([r, np.full((pad,) + r.shape[1:], f, F)])
              for r, f in zip(rays, (0.0, 1.0, 0.0, -1.0))]
    got = dense_v5._v5l_ref(
        *(torch.from_numpy(x) for x in (table, aabb, meta)),
        None if roots is None else torch.from_numpy(roots),
        *(torch.from_numpy(r) for r in padded), counts=True)
    _check([x[:n] for x in got], want)
    assert (got[3][n:] < 0).all() and (got[4][n:] == 0).all()  # padding
    if rooted:  # group 0 walks node 1's subtree: preorder [1, right(0))
        nodes = np.arange(1, meta[0][0])
        leaves = meta[1][nodes[meta[0][nodes] < 0]]
        prim = want["prim"][:1024]
        assert (prim >= 0).sum() > 50
        assert np.isin(prim[prim >= 0] // 32, leaves // 32).all()


def test_any_hit_masks_equal_closest(textured_np, v5l_np):
    """Any-hit answers whether the closest hit exists, with dead lanes
    (every 7th) and padded lanes (1500 rays in two groups)."""
    n = 1500
    rays = [torch.from_numpy(r) for r in _inst_rays(textured_np, n, 13)]
    tables = [torch.from_numpy(np.asarray(textured_np[k])) for k in I5_KEYS]
    closest = dense_v5i.dense_trace_v5i(*tables, *rays)
    anyh = dense_v5i.dense_trace_v5i(*tables, *rays, any_hit=True)
    assert torch.equal(anyh["prim"] >= 0, closest["prim"] >= 0)
    assert not (anyh["prim"][::7] >= 0).any()
    table, aabb, meta, scene = v5l_np
    rays = [torch.from_numpy(r) for r in _v5l_rays(scene, n, 14)]
    args = [torch.from_numpy(x) for x in (table, aabb, meta)] + rays
    closest = dense_v5.dense_trace_v5l(*args)
    anyh = dense_v5.dense_trace_v5l(*args, any_hit=True)
    assert torch.equal(anyh["prim"] >= 0, closest["prim"] >= 0)
    assert not (anyh["prim"][::7] >= 0).any()
    assert (closest["prim"] >= 0).float().mean() > 0.2


def _chain(depth, leaf_x, inner_x, base_node, leaf_meta):
    """A chain of `depth` inner nodes in preorder (inner j at base_node +
    2 j, its left child a leaf at + 2 j + 1, its right child the next inner
    node; the last inner node's right child the deepest leaf at + 2
    depth): node boxes [6, 2 depth + 1] and meta [2, 2 depth + 1]. Along
    +x a leaf j enters at leaf_x(j) and inner node j at inner_x(j), so
    the near child is always the next inner node (the deepest leaf is
    j = depth)."""
    nn = 2 * depth + 1
    aabb = np.zeros((6, nn), F)
    aabb[1:3], aabb[4:6] = -1.0, 1.0
    meta = np.zeros((2, nn), np.int32)
    for j in range(depth):
        aabb[0, 2 * j], aabb[3, 2 * j] = inner_x(j), 1e4
        meta[:, 2 * j] = (base_node + 2 * j + 2, 0)
    for j, node in [(j, 2 * j + 1) for j in range(depth)] + [(depth, nn - 1)]:
        aabb[0, node], aabb[3, node] = leaf_x(j), leaf_x(j) + 0.5
        meta[:, node] = (-1, leaf_meta(j))
    return aabb, meta


def stack_bound_scene(td=80, bd=75):
    """Two-level tables with TLAS depth td and BLAS depth bd: a TLAS chain
    whose leaves are identity instances of one BLAS chain, whose leaf j
    holds one triangle facing -x at its box's near face. A ray along +x
    from the origin walks the deepest TLAS leaf, then the deepest BLAS
    leaf, with td + bd + 1 entries on its stack; every other leaf is
    culled behind the hit."""
    tlas_aabb, tlas_meta = _chain(td, lambda j: 5000.0 - j,
                                  lambda j: float(j), 0, lambda j: -(j + 1))
    nt = tlas_aabb.shape[1]
    leaf_x = lambda j: 3000.0 - j if j < bd else 200.0  # noqa: E731
    blas_aabb, blas_meta = _chain(bd, leaf_x, lambda j: 100.0 + j, nt,
                                  lambda j: 32 * j)
    tris = np.zeros((12, 32 * (bd + 1)), F)
    for j in range(bd + 1):
        v0 = np.array([[leaf_x(j), -2.0, -2.0]], F)
        tris[:, 32 * j] = build_v5(v0, np.array([[0, 0, 6.0]], F),
                                   np.array([[0, 6.0, 0]], F))[0][:, 0]
    inst_inv = np.tile(np.array([1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0], F)
                       [:, None], (1, td + 1))
    inst_meta = np.stack([np.full(td + 1, nt, np.int32),
                          np.arange(td + 1, dtype=np.int32) * 1000])
    return (tris, np.concatenate([tlas_aabb, blas_aabb], 1),
            np.concatenate([tlas_meta, blas_meta], 1), inst_inv, inst_meta)


def _bound_rays(n):
    rng = np.random.default_rng(15)
    org = np.zeros((n, 3), F)
    org[:, 1:] = rng.uniform(-0.5, 0.5, (n, 2))
    d = np.zeros((n, 3), F)
    d[:, 0] = 1.0
    d[:, 1:] = rng.uniform(-1e-4, 1e-4, (n, 2))
    return org, d, np.zeros(n, F), np.full(n, INF, F)


def test_stack_bound_scene():
    tables = stack_bound_scene()
    right = tables[2][0]
    nt = int(tables[4][0][0])
    td = _depth(right[:nt])
    bd = _depth(np.where(right[nt:] >= 0, right[nt:] - nt, -1))
    assert (td, bd) == (80, 75) and td + bd + 4 == dense_v5i.STACK - 1
    rays = _bound_rays(64)
    tt = [torch.from_numpy(x) for x in tables]
    rt = [torch.from_numpy(r) for r in rays]
    got = dense_v5i._walk_ref(*tt, *rt, counts=True)
    walk = NumpyWalk(lambda b: tables[0][:, b:b + 32], *tables[1:])
    _check(got, walk.trace(*rays, np.zeros(64, np.int64)))
    # the deepest BLAS leaf of the deepest instance: x = 200
    assert torch.allclose(got[0], torch.full((64,), 200.0), rtol=1e-4)
    assert (got[3] == 32 * 75 + 1000 * 80).all()
    # the walk needs td + bd + 1 stack entries, and no more
    args = (per_ray.attr_major_rows(tt[0]), tt[1], tt[2], *rt, 0)
    kw = dict(inst_inv=tt[3], inst_meta=tt[4])
    per_ray.walk_ref(*args, td + bd + 1, **kw)
    with pytest.raises(RuntimeError, match="stack"):
        per_ray.walk_ref(*args, td + bd, **kw)


@pytest.mark.requires_cuda
def test_cuda_kernel_at_stack_bound():
    """The dense_v5i kernel bit-equal to the twin on the stack-bound
    scene (its lanes hold td + bd + 1 = 156 of the 160 entries)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the dense_v5i kernel is CUDA-only)")
    tables = [torch.from_numpy(x).cuda() for x in stack_bound_scene()]
    rays = [torch.from_numpy(r).cuda() for r in _bound_rays(2048)]
    ref = dense_v5i._walk_ref(*tables, *rays)
    got = dense_v5i._walk_cuda(*tables, *rays)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert torch.equal(a, b)

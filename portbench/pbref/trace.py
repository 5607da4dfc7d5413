"""The plain reference's ray queries: every triangle a ray's box test
lets through, tested in closed form; the closest valid hit, or any.

The triangles are kept as pbrlab's linear forms (n, n.v0, b1, b1.v0, b2,
b2.v0, computed as the program's commit documents them), so a ray's t,
u and v follow the same float operations as the program's kernels. The
search is brute force over clusters of 32 triangles in Morton order of
their centroids: each ray is box-tested against every cluster (boxes
padded, so no hit is culled) and the triangles of the clusters it enters
are tested. A hit needs u >= 0, v >= 0, u + v <= 1 and min_t <= t <
max_t; the closest hit is the least t, ties to the least face id.
"""
from __future__ import annotations

import numpy as np
import torch

INF = 1.844e18  # pbrlab's kInf, the program's t of a miss
CLUSTER = 32
RAYS = 8192  # rays box-tested at once
PAIRS = 1 << 16  # (ray, cluster) pairs tested at once


def _morton(c):
    lo, hi = c.min(axis=0), c.max(axis=0)
    q = ((c - lo) / np.maximum(hi - lo, 1e-12) * 1023).astype(np.int64)

    def spread(x):
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        return (x | (x << 2)) & 0x09249249

    return spread(q[:, 0]) | (spread(q[:, 1]) << 1) | (spread(q[:, 2]) << 2)


class Tracer:
    def __init__(self, v0, e1, e2, device, dtype=torch.float32):
        n = np.cross(e1, e2)
        nrm2 = np.maximum((n * n).sum(-1, keepdims=True), 1e-30)
        b1 = np.cross(e2, n) / nrm2
        b2 = np.cross(n, e1) / nrm2
        rows = np.concatenate([
            n, (n * v0).sum(-1)[:, None], b1, (b1 * v0).sum(-1)[:, None],
            b2, (b2 * v0).sum(-1)[:, None]], axis=1).astype(np.float32)
        f = v0.shape[0]
        order = np.argsort(_morton(v0 + (e1 + e2) / 3.0), kind="stable")
        c = (f + CLUSTER - 1) // CLUSTER
        ids = np.full((c * CLUSTER,), -1, np.int64)
        ids[:f] = order
        lo = np.full((c * CLUSTER, 3), np.inf, np.float32)
        hi = np.full((c * CLUSTER, 3), -np.inf, np.float32)
        pts = np.stack([v0, v0 + e1, v0 + e2], axis=1)[order]
        lo[:f], hi[:f] = pts.min(axis=1), pts.max(axis=1)
        lo = lo.reshape(c, CLUSTER, 3).min(axis=1)
        hi = hi.reshape(c, CLUSTER, 3).max(axis=1)
        pad = 1e-4 * (1.0 + np.maximum(np.abs(lo), np.abs(hi)))
        self.dev, self.dtype = device, dtype
        self.box = torch.from_numpy(
            np.concatenate([lo - pad, hi + pad], axis=1)).to(device)
        self.ids = torch.from_numpy(ids.reshape(c, CLUSTER)).to(device)
        self.rows = torch.from_numpy(rows).to(device=device, dtype=dtype)
        self.num_faces = f

    def _pairs(self, o, d, min_t, max_t):
        """(ray, cluster) pairs whose padded box the ray enters within
        [min_t, max_t], in float32 whatever the dtype."""
        o, d = o.float(), d.float()
        inv = 1.0 / torch.where(torch.abs(d) < 1e-12,
                                torch.where(d < 0.0, -1e-12, 1e-12), d)
        out = []
        for r0 in range(0, o.shape[0], RAYS):
            oi, ii = o[r0:r0 + RAYS, None], inv[r0:r0 + RAYS, None]
            t0 = (self.box[None, :, :3] - oi) * ii
            t1 = (self.box[None, :, 3:] - oi) * ii
            tn = torch.minimum(t0, t1).amax(-1)
            tf = torch.maximum(t0, t1).amin(-1)
            lo = min_t[r0:r0 + RAYS, None].float()
            hi = max_t[r0:r0 + RAYS, None].float()
            ok = (tn <= tf) & (tf >= lo) & (tn <= hi) & (hi >= lo)
            r, c = torch.nonzero(ok, as_tuple=True)
            out.append((r + r0, c))
        return (torch.cat([p[0] for p in out]), torch.cat([p[1] for p in out]))

    def _test(self, face, o, d, min_t):
        """t, u, v [k] of rays o, d [k, 3] against faces [k]
        (pbrlab's linear forms, the kernels' order of operations)."""
        nx, ny, nz, k0, b1x, b1y, b1z, c1, b2x, b2y, b2z, c2 = \
            self.rows[face].unbind(-1)
        ox, oy, oz = o.unbind(-1)
        dx, dy, dz = d.unbind(-1)
        t = (k0 - (ox * nx + oy * ny + oz * nz)) \
            / (dx * nx + dy * ny + dz * nz)
        u = (ox * b1x + oy * b1y + oz * b1z - c1) \
            + t * (dx * b1x + dy * b1y + dz * b1z)
        v = (ox * b2x + oy * b2y + oz * b2z - c2) \
            + t * (dx * b2x + dy * b2y + dz * b2z)
        ok = (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t >= min_t)
        return t, u, v, ok

    def query(self, o, d, min_t, max_t, any_hit=False):
        """Closest hit -> (t, u, v, face) with t = INF (the program's
        miss value, 1.844e18) and face = -1 on a miss; any_hit ->
        occluded [n] bool."""
        n = o.shape[0]
        best = torch.full((n,), torch.iinfo(torch.int64).max,
                          dtype=torch.int64, device=self.dev)
        ray, clu = self._pairs(o, d, min_t, max_t)
        for p0 in range(0, ray.numel(), PAIRS):
            r = ray[p0:p0 + PAIRS, None].expand(-1, CLUSTER)
            face = self.ids[clu[p0:p0 + PAIRS]]
            valid = face >= 0
            fc = face.clamp(min=0)
            t, _, _, ok = self._test(fc, o[r], d[r], min_t[r])
            ok = ok & valid & (t < max_t[r])
            tb = (t.float() + 0.0).clamp(min=0.0).view(torch.int32)
            key = torch.where(ok, (tb.to(torch.int64) << 32) | fc,
                              torch.iinfo(torch.int64).max)
            best.scatter_reduce_(0, r[:, 0], key.amin(1), "amin")
        hit = best != torch.iinfo(torch.int64).max
        if any_hit:
            return hit
        face = torch.where(hit, best & 0xFFFFFFFF, 0)
        t, u, v, _ = self._test(face, o, d, min_t)
        return (torch.where(hit, t, INF), torch.where(hit, u, 0.0),
                torch.where(hit, v, 0.0), torch.where(hit, face, -1))

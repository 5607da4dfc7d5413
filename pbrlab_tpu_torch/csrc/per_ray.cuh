// Per-ray walks for Hopper (sm_90a): the BVH walk of the dense_v5, dense_v5
// dual and dense_v5l kernels (csrc/dense_v5.cu) and the dense_v5i kernel
// (csrc/dense_v5i.cu), and the cluster walk (`cluster_walk` at the end of
// this file) of the dense_v4 kernels (csrc/dense_v4.cu), the dense_curve
// kernel (csrc/dense_curve.cu) and the dense_v3 kernel (csrc/dense_v3.cu).
//
// One thread walks one ray alone, with its own stack of (node, entry t)
// pairs: no block reduction, no vote and no barrier anywhere in the walk.
// At an inner node the thread tests both children's boxes against its own
// best t and pushes the far child first, the near one second (popped
// first); a popped node is skipped once `tn (1 - 1e-6) - 1e-6 > best t`,
// the lane's own (the TPU's packet walks cull against the group's largest
// best t). With the instance level (dense_v5i), a TLAS leaf maps the ray
// into the instance's space (the transform in the Pallas order, the
// direction not renormalised, the slab reciprocals recomputed), pushes the
// BLAS root above the stack pointer it had there (`sp_base`), and the
// thread returns to world space when its stack drops back to sp_base. A
// BLAS leaf's 32 triangles are tested in order with a strict `t < best t`,
// so an exact tie keeps the first one. Any-hit ends the lane's walk at the
// end of the first leaf that gives it a hit.
//
// The slab test (x 1.00000024 slop), the transform and the triangle test
// are the float operations of the Pallas bodies, in their order; the
// library is built with --fmad=false and IEEE division, so the plain torch
// twin (pbrlab_tpu_torch/ops/per_ray.py), which follows each lane's own pop
// sequence, gives the same bits.
//
// Leaf loads: attribute a of triangle k of a leaf sits at rows[a * stride +
// k], where rows is the leaf's slot base b (attr-major, stride S) or b * 12
// (leaf-major, stride 32), fixed per kernel by kLeafMajor. The table is
// 16-byte aligned and S a multiple of 4 (the wrappers check it), and an
// attr-major b is a multiple of 32 (build_v5 and build_instanced check it;
// b * 12 is aligned for any b), so one float4 load brings one attribute of 4
// triangles: 12 loads per 4 triangles. The tables are read through the
// read-only cache.
//
// Stack: a lane needs at most (TLAS depth) + 1 + (BLAS depth) + 1 entries
// (one pending sibling per level of its path, the BLAS root, and the two
// children of the last inner node); one level: depth + 1. The stack lives
// in the thread's local memory, cached in L1: on dense_v5i it ran about
// twice as fast there as in a shared-memory slice of 32-thread blocks
// (PERF.md).

#pragma once

#include <cuda_runtime.h>

namespace per_ray {
namespace {

constexpr int kCluster = 32;
constexpr float kBig = 1e30f;
constexpr float kSlop = 1.00000024f;
constexpr float kEps = 1e-12f;
constexpr int kList = 256;  // clusters in a lane's list: one chunk

// jnp / torch maximum and minimum: NaN in either operand gives NaN
__device__ __forceinline__ float pmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}
__device__ __forceinline__ float pmin(float a, float b) {
  return (a < b || a != a) ? a : b;
}

__device__ __forceinline__ float inv_dir(float d) {
  const float e = fabsf(d) < kEps ? (d < 0.f ? -kEps : kEps) : d;
  return 1.0f / e;
}

struct Frame {  // one ray in one space, with its slab-test terms
  float ox, oy, oz, dx, dy, dz;
  float ix, iy, iz, oix, oiy, oiz;  // 1 / d, o / d
};

__device__ __forceinline__ Frame make_frame(float ox, float oy, float oz,
                                            float dx, float dy, float dz) {
  Frame f;
  f.ox = ox;
  f.oy = oy;
  f.oz = oz;
  f.dx = dx;
  f.dy = dy;
  f.dz = dz;
  f.ix = inv_dir(dx);
  f.iy = inv_dir(dy);
  f.iz = inv_dir(dz);
  f.oix = ox * f.ix;
  f.oiy = oy * f.iy;
  f.oiz = oz * f.iz;
  return f;
}

struct Tables {
  const float* tris;   // leaf rows (see leaf)
  size_t stride;       // between a leaf's attribute rows
  const float* naabb;  // [6, Nn]
  const int* nmeta;    // [2, Nn]
  int nodes;           // Nn
  const float* inv;    // [12, K] world-to-local rows (instanced only)
  const int* imeta;    // [2, K] BLAS root, slot-to-face-id delta
  int insts;           // K
};

struct Hit {
  float t, u, v;
  int prim;
};

// entry t of the ray into box `node` if it enters before `cap`, else kBig
__device__ __forceinline__ float slab(const Tables& tb, int node,
                                      const Frame& f, float mint, float cap) {
  const float* __restrict__ a = tb.naabb;
  const int n = tb.nodes;
  float t0 = __ldg(a + node) * f.ix - f.oix;
  float t1 = __ldg(a + 3 * n + node) * f.ix - f.oix;
  const float nx = pmin(t0, t1), fx = pmax(t0, t1);
  t0 = __ldg(a + n + node) * f.iy - f.oiy;
  t1 = __ldg(a + 4 * n + node) * f.iy - f.oiy;
  const float ny = pmin(t0, t1), fy = pmax(t0, t1);
  t0 = __ldg(a + 2 * n + node) * f.iz - f.oiz;
  t1 = __ldg(a + 5 * n + node) * f.iz - f.oiz;
  const float nz = pmin(t0, t1), fz = pmax(t0, t1);
  const float tnear = pmax(pmax(nx, ny), pmax(nz, mint));
  const float tfar = pmin(pmin(fx, fy), pmin(fz, cap));
  return tnear <= tfar * kSlop ? tnear : kBig;
}

// one ray-triangle test (the Pallas body's operations in its order); den
// == 0 (padding rows are all zero) gives t inf or nan: no hit
__device__ __forceinline__ void tri(float nx, float ny, float nz, float k0,
                                    float b1x, float b1y, float b1z, float c1,
                                    float b2x, float b2y, float b2z, float c2,
                                    const Frame& f, float mint, int id,
                                    Hit& h) {
  const float t = (k0 - (f.ox * nx + f.oy * ny + f.oz * nz)) /
                  (f.dx * nx + f.dy * ny + f.dz * nz);
  const float u = (f.ox * b1x + f.oy * b1y + f.oz * b1z - c1) +
                  t * (f.dx * b1x + f.dy * b1y + f.dz * b1z);
  const float v = (f.ox * b2x + f.oy * b2y + f.oz * b2z - c2) +
                  t * (f.dx * b2x + f.dy * b2y + f.dz * b2z);
  // strict t < best t keeps the first-visited triangle on ties
  if (u >= 0.f && v >= 0.f && u + v <= 1.f && t >= mint && t < h.t) {
    h.t = t;
    h.u = u;
    h.v = v;
    h.prim = id;
  }
}

// the 32 triangles of the leaf at slot base `base`, in order; id0 is the
// prim id of its first slot
template <bool kLeafMajor>
__device__ __forceinline__ void leaf(const Tables& tb, int base,
                                     const Frame& f, float mint, int id0,
                                     Hit& h) {
  const float* rows =
      tb.tris + static_cast<size_t>(base) * (kLeafMajor ? 12 : 1);
#pragma unroll 1
  for (int k = 0; k < kCluster; k += 4) {
    float4 q[12];
#pragma unroll
    for (int a = 0; a < 12; ++a) {
      q[a] = __ldg(reinterpret_cast<const float4*>(rows + a * tb.stride + k));
    }
    tri(q[0].x, q[1].x, q[2].x, q[3].x, q[4].x, q[5].x, q[6].x, q[7].x,
        q[8].x, q[9].x, q[10].x, q[11].x, f, mint, id0 + k, h);
    tri(q[0].y, q[1].y, q[2].y, q[3].y, q[4].y, q[5].y, q[6].y, q[7].y,
        q[8].y, q[9].y, q[10].y, q[11].y, f, mint, id0 + k + 1, h);
    tri(q[0].z, q[1].z, q[2].z, q[3].z, q[4].z, q[5].z, q[6].z, q[7].z,
        q[8].z, q[9].z, q[10].z, q[11].z, f, mint, id0 + k + 2, h);
    tri(q[0].w, q[1].w, q[2].w, q[3].w, q[4].w, q[5].w, q[6].w, q[7].w,
        q[8].w, q[9].w, q[10].w, q[11].w, f, mint, id0 + k + 3, h);
  }
}

// The walk of one ray from node `root`: h holds max t and no hit on entry
// (a lane with max t < min t walks nothing) and the lane's answer on exit.
// stk is the thread's stack of kStack (node, entry t bits) entries; two
// walks of one thread may reuse it one after the other.
template <bool kInstanced, bool kAnyHit, bool kLeafMajor, int kStack>
__device__ __forceinline__ void walk(const Tables& tb, const Frame& world,
                                     float mint, int root, Hit& h,
                                     int2 (&stk)[kStack]) {
  Frame cur = world;
  int sp = 0, sp_base = -1, fid = 0;
  if (h.t >= mint) {
    stk[0] = make_int2(root, __float_as_int(-1e30f));
    sp = 1;
  }
  while (true) {
    if (kInstanced && sp == sp_base) {  // the instance's BLAS is done
      cur = world;
      sp_base = -1;
    }
    if (sp == 0) break;
    const int2 top = stk[--sp];
    const int node = top.x;
    // relative + absolute pad: as tolerant as the slab test
    if (!(__int_as_float(top.y) * 0.999999f - 1e-6f <= h.t)) continue;
    const int right = __ldg(tb.nmeta + node);
    if (right >= 0) {
      const int left = node + 1;
      const float tn_l = slab(tb, left, cur, mint, h.t);
      const float tn_r = slab(tb, right, cur, mint, h.t);
      const bool l_far = tn_l > tn_r;
      const float far_tn = pmax(tn_l, tn_r), near_tn = pmin(tn_l, tn_r);
      if (far_tn < kBig) {
        stk[sp++] = make_int2(l_far ? left : right, __float_as_int(far_tn));
      }
      if (near_tn < kBig) {
        stk[sp++] = make_int2(l_far ? right : left, __float_as_int(near_tn));
      }
      continue;
    }
    const int base = __ldg(tb.nmeta + tb.nodes + node);
    if (kInstanced && base < 0) {  // TLAS leaf: into the instance's space
      const int k = -base - 1;
      float a[12];
#pragma unroll
      for (int r = 0; r < 12; ++r) a[r] = __ldg(tb.inv + r * tb.insts + k);
      const float ox = world.ox, oy = world.oy, oz = world.oz;
      const float dx = world.dx, dy = world.dy, dz = world.dz;
      cur = make_frame(((a[0] * ox + a[1] * oy) + a[2] * oz) + a[3],
                       ((a[4] * ox + a[5] * oy) + a[6] * oz) + a[7],
                       ((a[8] * ox + a[9] * oy) + a[10] * oz) + a[11],
                       (a[0] * dx + a[1] * dy) + a[2] * dz,
                       (a[4] * dx + a[5] * dy) + a[6] * dz,
                       (a[8] * dx + a[9] * dy) + a[10] * dz);
      const int blas = __ldg(tb.imeta + k);
      fid = __ldg(tb.imeta + tb.insts + k);
      sp_base = sp;
      const float tn0 = slab(tb, blas, cur, mint, h.t);
      if (tn0 < kBig) stk[sp++] = make_int2(blas, __float_as_int(tn0));
      continue;
    }
    leaf<kLeafMajor>(tb, base, cur, mint, base + fid, h);
    if (kAnyHit && h.prim >= 0) break;
  }
}

// The legacy dense kernels' slab test (dense_curve, dense_v3; the Pallas
// bodies' `(box - o) * inv` form, with inv = 1 / d and a |d| < 1e-12
// component taken as +1e-12 whatever its sign, `inv_up`): the entry t of
// the ray into box c of aabb [>= 6, m] if it enters before cap, else
// kBig. The entry t is not clipped below by min t.
struct DiffRay {
  float ox, oy, oz, ix, iy, iz;
};

__device__ __forceinline__ float inv_up(float d) {
  return 1.0f / (fabsf(d) < kEps ? kEps : d);
}

__device__ __forceinline__ DiffRay diff_ray(float ox, float oy, float oz,
                                            float dx, float dy, float dz) {
  return {ox, oy, oz, inv_up(dx), inv_up(dy), inv_up(dz)};
}

__device__ __forceinline__ float slab_diff(const float* __restrict__ aabb,
                                           int m, int c, const DiffRay& r,
                                           float mint, float cap) {
  const float tx0 = (__ldg(aabb + c) - r.ox) * r.ix;
  const float tx1 = (__ldg(aabb + 3 * m + c) - r.ox) * r.ix;
  const float ty0 = (__ldg(aabb + m + c) - r.oy) * r.iy;
  const float ty1 = (__ldg(aabb + 4 * m + c) - r.oy) * r.iy;
  const float tz0 = (__ldg(aabb + 2 * m + c) - r.oz) * r.iz;
  const float tz1 = (__ldg(aabb + 5 * m + c) - r.oz) * r.iz;
  const float tnear =
      pmax(pmax(pmin(tx0, tx1), pmin(ty0, ty1)), pmin(tz0, tz1));
  const float tfar =
      pmin(pmin(pmax(tx0, tx1), pmax(ty0, ty1)), pmax(tz0, tz1));
  return tnear <= tfar * kSlop && tfar >= mint && tnear <= cap ? tnear
                                                                : kBig;
}

// The rule of the dense_curve and dense_v3 kernels: a candidate at t with
// prim id beats h when its t is smaller, or equal with a lower slot (id
// mod 8). The TPU keeps one best per slot with a strict `t < best` and at
// the end takes the least t, the lowest slot on ties; one best per lane
// with this rule keeps the same lexicographic minimum of (t, id mod 8),
// the first visited on a full tie.
__device__ __forceinline__ bool beats(float t, int id, const Hit& h) {
  return t < h.t || (t == h.t && h.prim >= 0 && (id & 7) < (h.prim & 7));
}

// The cluster walk of one ray (no tree) over `clusters` clusters, in
// chunks of kMax in cluster order. For each chunk the thread tests its ray
// against the chunk's boxes in cluster order, `box(c, cap)` returning the
// entry t into box c if the ray enters it before cap, else kBig, capped at
// the lane's best t (every lane reads the same box at the same step: a
// broadcast); keeps the clusters it enters in lst as (cluster, entry t
// bits) ordered by entry t (inserted behind equal ones: ties keep the
// lower cluster id); then walks the list front to back, `leaf(c, h)`
// testing cluster c's primitives, until `tn (1 - 1e-6) - 1e-6 > best t`
// (the pad of walk), and goes on to the next chunk. With kAnyHit the walk
// ends after the first cluster that gives the lane a hit. h holds max t
// and no hit on entry (a lane with max t < min t tests nothing) and the
// lane's answer on exit. The leaf functor carries the cluster's size and
// its primitive test: dense_v4's 32 triangles, dense_curve's 128
// ribbons, dense_v3's 128 legacy triangles.
template <bool kAnyHit, int kMax, class Box, class Leaf>
__device__ __forceinline__ void cluster_walk(int clusters, float mint,
                                             const Box& box, const Leaf& leaf,
                                             Hit& h, int2 (&lst)[kMax]) {
  if (!(h.t >= mint)) return;  // a dead lane tests nothing
#pragma unroll 1
  for (int c0 = 0; c0 < clusters; c0 += kMax) {
    const int c1 = min(c0 + kMax, clusters);
    int cnt = 0;
#pragma unroll 1
    for (int c = c0; c < c1; ++c) {
      const float tn = box(c, h.t);
      if (!(tn < kBig)) continue;
      int j = cnt++;
      for (; j > 0 && __int_as_float(lst[j - 1].y) > tn; --j) {
        lst[j] = lst[j - 1];
      }
      lst[j] = make_int2(c, __float_as_int(tn));
    }
#pragma unroll 1
    for (int j = 0; j < cnt; ++j) {
      if (!(__int_as_float(lst[j].y) * 0.999999f - 1e-6f <= h.t)) break;
      leaf(lst[j].x, h);
      if (kAnyHit && h.prim >= 0) return;
    }
  }
}

}  // namespace
}  // namespace per_ray

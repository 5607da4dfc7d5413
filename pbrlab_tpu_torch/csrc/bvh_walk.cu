// Threaded-BVH walks for Hopper (sm_90a), plain C interface.
//
// Replaces the JAX package's CPU traces, which it walks in an XLA
// lax.while_loop (no Pallas):
//   bvh_trace        <- pbrlab_tpu/ops/intersect.py:133 _bvh_trace
//                       (intersect_bvh, occluded_bvh)
//   curve_bvh_trace  <- pbrlab_tpu/ops/curves.py:108 curve_trace
// Bound with ctypes from pbrlab_tpu_torch/ops/bvh_walk.py (walk_cuda),
// which also holds the plain torch twin (walk_ref); the leaf tests' twins
// are intersect._mt_intersect and curves._ribbon_intersect.
//
// Inputs: the tree of geometry/bvh.py build_bvh (bmin, bmax [Nn, 3],
// skip [Nn], prim_offset [Nn] (-1 for an inner node), prim_ids [Np] padded
// with -1), the primitive columns (triangles: v0, e1, e2 [F, 3]; curves:
// p0, p1 [C, 3], r0, r1, u0, u1 [C]) and the rays as contiguous arrays
// (org/dir [N, 3], min_t/max_t [N]), any N.
//
// Design: one thread a ray, 128 threads a block, no stack, no shared
// memory, no vote. The thread keeps one node pointer: a box it enters (slab
// test against [min_t, min(max_t, best t)]) that is inner sends it to
// node + 1, a leaf or a box it misses to skip[node]; it is done when the
// pointer passes the last node. A leaf tests its 4 slots in order with the
// cap it had on entering the leaf, keeping a hit that is strictly below
// the running best: the first least t, as the JAX package's argmin then
// strict `<` keeps. Any-hit stops after the first leaf with a hit. A lane
// with max_t < min_t walks nothing (no hit could pass both bounds). Tables
// are read through the read-only cache.
//
// The float operations are the JAX bodies', in their order: the slab test
// (box - o) * inv with the x 1.00000024 pad on tfar; Moller-Trumbore with
// TRI_EPS 1e-9 and no backface cull; the ribbon test of _ribbon_intersect.
// The reciprocal clamps at 1e-20 for triangles and 1e-12 for curves, the
// sign kept. The library is built with --fmad=false and IEEE division and
// sqrt, so the twin gives the same bits.
//
// What bounds it: f32 operations, 27 per node step (a box), 40 per
// ray-triangle and 56 per ray-ribbon test; a walk's steps are dependent,
// so a long walk is bound by its latency chain.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // threads a block, one ray each
constexpr int kLeaf = 4;       // slots a leaf (geometry/bvh.py LEAF_SIZE)
constexpr float kInf = 1.844e18f;  // core.math.INF
constexpr float kSlop = 1.00000024f;
constexpr float kTriEps = 1e-9f;

// jnp / torch maximum and minimum: NaN in either operand gives NaN
__device__ __forceinline__ float pmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}
__device__ __forceinline__ float pmin(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return pmin(pmax(x, lo), hi);
}
__device__ __forceinline__ float3 ld3(const float* __restrict__ p, int i) {
  return make_float3(__ldg(p + 3 * i), __ldg(p + 3 * i + 1),
                     __ldg(p + 3 * i + 2));
}
__device__ __forceinline__ float3 sub(float3 a, float3 b) {
  return make_float3(a.x - b.x, a.y - b.y, a.z - b.z);
}
// (a0 b0 + a1 b1) + a2 b2
__device__ __forceinline__ float dot(float3 a, float3 b) {
  return (a.x * b.x + a.y * b.y) + a.z * b.z;
}
// jnp.cross
__device__ __forceinline__ float3 cross(float3 a, float3 b) {
  return make_float3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
                     a.x * b.y - a.y * b.x);
}
__device__ __forceinline__ float inv_dir(float d, float eps) {
  return 1.0f / (fabsf(d) < eps ? (d < 0.f ? -eps : eps) : d);
}

struct Tree {
  const float* bmin;
  const float* bmax;
  const int* skip;
  const int* prim_offset;
  int n_nodes;
  const int* prim_ids;
  int n_ids;
};

struct Rays {
  const float* org;
  const float* dir;
  const float* min_t;
  const float* max_t;
  int n;
  float* out_t;
  float* out_u;
  float* out_v;
  int* out_prim;
};

struct Hit {
  float t, u, v;
  int prim;
};

struct Ray {
  float3 o, d, inv;
  float mint;
};

struct Triangles {
  const float* v0;
  const float* e1;
  const float* e2;

  // Moller-Trumbore of slot `pid` against a lane's ray
  __device__ __forceinline__ void test(int pid, const Ray& r, float cap,
                                       Hit& h) const {
    const float3 a = ld3(v0, pid), e1v = ld3(e1, pid), e2v = ld3(e2, pid);
    const float3 pvec = cross(r.d, e2v);
    const float det = dot(e1v, pvec);
    const bool ok = fabsf(det) > kTriEps;
    const float inv_det = ok ? 1.0f / det : 0.f;
    const float3 tvec = sub(r.o, a);
    const float u = dot(tvec, pvec) * inv_det;
    const float3 qvec = cross(tvec, e1v);
    const float v = dot(r.d, qvec) * inv_det;
    const float t = dot(e2v, qvec) * inv_det;
    if (ok && u >= 0.f && v >= 0.f && u + v <= 1.0f && t >= r.mint &&
        t <= cap && t < h.t) {
      h = {t, u, v, pid};
    }
  }
};

struct Ribbons {
  const float* p0;
  const float* p1;
  const float* r0;
  const float* r1;
  const float* u0;
  const float* u1;

  // the ray-facing ribbon around sub-segment `pid` (_ribbon_intersect)
  __device__ __forceinline__ void test(int pid, const Ray& r, float cap,
                                       Hit& h) const {
    const float3 q0 = ld3(p0, pid), q1 = ld3(p1, pid);
    const float a_r0 = __ldg(r0 + pid), a_r1 = __ldg(r1 + pid);
    const float3 a = sub(q0, r.o), b = sub(q1, r.o);
    const float ad = dot(a, r.d);
    const float bd = dot(b, r.d);
    const float3 a_perp = make_float3(a.x - ad * r.d.x, a.y - ad * r.d.y,
                                      a.z - ad * r.d.z);
    const float3 b_perp = make_float3(b.x - bd * r.d.x, b.y - bd * r.d.y,
                                      b.z - bd * r.d.z);
    const float3 seg = sub(b_perp, a_perp);
    const float denom = dot(seg, seg);
    float s = -dot(a_perp, seg) / pmax(denom, 1e-12f);
    s = denom > 1e-12f ? clip(s, 0.f, 1.f) : 0.f;
    const float3 c = make_float3(a_perp.x + s * seg.x, a_perp.y + s * seg.y,
                                 a_perp.z + s * seg.z);
    const float d2 = dot(c, c);
    const float rad = a_r0 + (a_r1 - a_r0) * s;
    const float t = ad + s * (bd - ad);
    if (d2 <= rad * rad && t >= r.mint && t <= cap && rad > 0.f &&
        t < h.t) {
      // signed offset: the sign from the (direction x tangent) bitangent
      const float3 bit = cross(r.d, sub(q1, q0));
      const float bit_len = sqrtf(pmax(dot(bit, bit), 1e-20f));
      const float v = clip(-dot(c, bit) / (bit_len * pmax(rad, 1e-12f)),
                           -1.f, 1.f);
      const float w0 = __ldg(u0 + pid), w1 = __ldg(u1 + pid);
      h = {t, w0 + (w1 - w0) * s, v, pid};
    }
  }
};

template <bool kAnyHit, class Prims>
__global__ void __launch_bounds__(kThreads)
    walk_kernel(const Tree tree, const Prims prims, const Rays rays,
                float eps) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= rays.n) return;
  Ray r;
  r.o = ld3(rays.org, i);
  r.d = ld3(rays.dir, i);
  r.inv = make_float3(inv_dir(r.d.x, eps), inv_dir(r.d.y, eps),
                      inv_dir(r.d.z, eps));
  r.mint = rays.min_t[i];
  const float maxt = rays.max_t[i];
  Hit h = {kInf, 0.f, 0.f, -1};
  int node = maxt >= r.mint ? 0 : tree.n_nodes;
  while (node < tree.n_nodes) {
    const float cap = pmin(maxt, h.t);
    const float3 lo = ld3(tree.bmin, node), hi = ld3(tree.bmax, node);
    const float tx0 = (lo.x - r.o.x) * r.inv.x, tx1 = (hi.x - r.o.x) * r.inv.x;
    const float ty0 = (lo.y - r.o.y) * r.inv.y, ty1 = (hi.y - r.o.y) * r.inv.y;
    const float tz0 = (lo.z - r.o.z) * r.inv.z, tz1 = (hi.z - r.o.z) * r.inv.z;
    const float tnear =
        pmax(pmax(pmin(tx0, tx1), pmin(ty0, ty1)), pmin(tz0, tz1));
    const float tfar =
        pmin(pmin(pmax(tx0, tx1), pmax(ty0, ty1)), pmax(tz0, tz1));
    const bool enter = tnear <= tfar * kSlop && tfar >= r.mint && tnear <= cap;
    const int poff = __ldg(tree.prim_offset + node);
    if (enter && poff < 0) {
      ++node;
      continue;
    }
    const int skip = __ldg(tree.skip + node);
    if (enter) {  // a leaf: its slots in order, the entry cap for each
#pragma unroll
      for (int k = 0; k < kLeaf; ++k) {
        const int slot = poff + k;
        const int pid = slot < tree.n_ids ? __ldg(tree.prim_ids + slot) : -1;
        if (pid >= 0) prims.test(pid, r, cap, h);
      }
      if (kAnyHit && h.prim >= 0) break;
    }
    node = skip;
  }
  rays.out_t[i] = h.t;
  rays.out_u[i] = h.u;
  rays.out_v[i] = h.v;
  rays.out_prim[i] = h.prim;
}

template <class Prims>
int launch(const Tree& tree, const Prims& prims, const Rays& rays,
           int any_hit, float eps, void* stream) {
  void (*kernel)(Tree, Prims, Rays, float) =
      any_hit ? walk_kernel<true, Prims> : walk_kernel<false, Prims>;
  if (rays.n > 0) {
    kernel<<<(rays.n + kThreads - 1) / kThreads, kThreads, 0,
             static_cast<cudaStream_t>(stream)>>>(tree, prims, rays, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// closest (any_hit 0) or any hit of n rays over the triangle BVH
extern "C" int bvh_trace(const float* bmin, const float* bmax,
                         const int* skip, const int* prim_offset, int n_nodes,
                         const int* prim_ids, int n_ids, const float* v0,
                         const float* e1, const float* e2, const float* org,
                         const float* dir, const float* min_t,
                         const float* max_t, int any_hit, int n,
                         float* out_t, float* out_u, float* out_v,
                         int* out_prim, void* stream) {
  const Tree tree = {bmin, bmax, skip, prim_offset, n_nodes, prim_ids, n_ids};
  const Triangles tris = {v0, e1, e2};
  const Rays rays = {org, dir, min_t, max_t, n, out_t, out_u, out_v, out_prim};
  return launch(tree, tris, rays, any_hit, 1e-20f, stream);
}

// closest (any_hit 0) or any hit of n rays over the curve BVH; out_prim is
// the sub-segment id
extern "C" int curve_bvh_trace(const float* bmin, const float* bmax,
                               const int* skip, const int* prim_offset,
                               int n_nodes, const int* prim_ids, int n_ids,
                               const float* p0, const float* p1,
                               const float* r0, const float* r1,
                               const float* u0, const float* u1,
                               const float* org, const float* dir,
                               const float* min_t, const float* max_t,
                               int any_hit, int n, float* out_t, float* out_u,
                               float* out_v, int* out_prim, void* stream) {
  const Tree tree = {bmin, bmax, skip, prim_offset, n_nodes, prim_ids, n_ids};
  const Ribbons ribbons = {p0, p1, r0, r1, u0, u1};
  const Rays rays = {org, dir, min_t, max_t, n, out_t, out_u, out_v, out_prim};
  return launch(tree, ribbons, rays, any_hit, 1e-12f, stream);
}

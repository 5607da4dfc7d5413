// Legacy dense triangle trace kernels v1, v2 and v3 for Hopper (sm_90a),
// plain C interface.
//
// Replaces the Pallas TPU kernels of the JAX package's brute-force
// backends:
//   dense_v1_trace <- pbrlab_tpu/ops/pallas/dense.py     _trace_kernel
//   dense_v2_trace <- pbrlab_tpu/ops/pallas/dense_v2.py  _trace_kernel
//   dense_v3_trace <- pbrlab_tpu/ops/pallas/dense_v3.py  _trace_kernel
// Bound with ctypes from pbrlab_tpu_torch/ops/dense.py, dense_v2.py and
// dense_v3.py; dense.py also holds the plain torch twin of all three
// (`walk_ref`) and the host packing (`pack_triangles`).
//
// Inputs: tris [12, Fpad], one column of linear forms per Morton-sorted
// triangle (n, k0 = n.v0, b1, c1 = b1.v0, b2, c2 = b2.v0; padding columns
// are zero), attribute-major with stride Fpad (a multiple of 128; the
// wrappers check the 16-byte alignment), and the boxes aabb [8, M] (rows
// 0:3 lo, 3:6 hi) of M clusters of 128 columns; the rays as contiguous
// arrays (org/dir [N, 3], min_t/max_t [N], max_t clamped to INF), any N.
//
// Design: one template, `legacy_kernel<Rule, kAnyHit>`, on
// per_ray.cuh `cluster_walk`: one thread a ray, 128 threads a block, no
// vote, no barrier and no shared memory. The thread walks the clusters in
// chunks of 256 in cluster order: it slab-tests its ray against the
// chunk's boxes (per_ray::slab_diff, the `(box - o) * inv` arithmetic of
// dense.py:151-165, dense_v2.py:74-87 and dense_v3.py:158-180) capped at
// its own best t, keeps the clusters it enters in a local-memory list
// ordered by entry t, and walks them front to back until its best t lies
// before the next entry. Any-hit ends the lane's walk after the first
// cluster that gives it a hit. One float4 load brings one attribute of 4
// triangles: 12 loads per 4 triangles. The TPU walks groups instead: v1
// an 8-ray block enters a cluster when any of its rays' boxes passes
// against that ray's max t; v2 a 128-ray group when any lane's box passes
// against its running best (with any-hit until every lane has a hit); v3
// a group's survivor list that an XLA prelude builds; and every lane of a
// group tests every triangle of every cluster its group enters. Each lane
// culls exactly here, and pays only for its own clusters.
//
// Ties (per_ray::TieRule): the TPU keeps one best per slot, strict
// `t < best`, and at the end takes the least t, the lowest slot on ties.
// * v2: slot = id mod 8 (the tri-step sublane), max_t folded into the
//   initial best, clusters in index order: the lexicographic minimum of
//   (t, id mod 8, id), which no visit order changes, so the rule adds the
//   id as the last key;
// * v1: slot = id mod 128 (the triangle lane), the best starting at INF
//   with the bound t <= max_t, clusters in index order: the minimum of
//   (t, id mod 128, id) up to max_t inclusive (the rule takes a candidate
//   at the lane's initial best, max_t, while it has no hit), and a miss's
//   t is INF (the `inf` argument); any_hit is ignored, as in JAX;
// * v3: slot = id mod 8 over a survivor list in the group's entry order:
//   the minimum of (t, id mod 8), the first visited on a full tie.
//
// Arithmetic: the Pallas bodies' ray-triangle test on the linear forms, in
// their operand order (dense.py:173-187, dense_v2.py:103-117,
// dense_v3.py:121-135); the library is built with --fmad=false and IEEE
// division, so the twin, which visits each lane's clusters in the same
// order, gives the same bits. prim is int32 here and in the twin (the TPU
// carries it as float32, exact below 2^24 faces: ROADMAP C9).
//
// What bounds it: f32 operations, 40 per ray-triangle test of every
// cluster the lane walks and 27 per ray-box test (M per live lane).

#include "per_ray.cuh"

namespace {

constexpr int kThreads = 128;  // threads a block, one ray each
constexpr int kTris = 128;     // triangles a cluster

using V1 = per_ray::TieRule<kTris, true, true>;
using V2 = per_ray::TieRule<8, true, false>;
using V3 = per_ray::TieRule<8, false, false>;

struct Params {
  const float* tris;
  size_t fpad;  // stride between the attribute rows
  const float* aabb;
  int m;
  const float* org;
  const float* dir;
  const float* min_t;
  const float* max_t;
  float miss_t;  // v1's t of a miss (INF); unused by the others
  int n;
  float* out_t;
  float* out_u;
  float* out_v;
  int* out_prim;
};

struct Ray {
  float ox, oy, oz, dx, dy, dz, mint;
};

// one ray-triangle test on the linear forms, in the Pallas operand order
template <class Rule>
__device__ __forceinline__ void tri(float nx, float ny, float nz, float k0,
                                    float b1x, float b1y, float b1z, float c1,
                                    float b2x, float b2y, float b2z, float c2,
                                    const Ray& r, int id, per_ray::Hit& h) {
  const float den = r.dx * nx + r.dy * ny + r.dz * nz;
  const float num = k0 - (r.ox * nx + r.oy * ny + r.oz * nz);
  const float t = num / (fabsf(den) < 1e-12f ? 1e-12f : den);
  const float u = ((r.ox * b1x + r.oy * b1y + r.oz * b1z) - c1) +
                  t * (r.dx * b1x + r.dy * b1y + r.dz * b1z);
  const float v = ((r.ox * b2x + r.oy * b2y + r.oz * b2z) - c2) +
                  t * (r.dx * b2x + r.dy * b2y + r.dz * b2z);
  if (fabsf(den) > 1e-12f && u >= 0.f && v >= 0.f && u + v <= 1.f &&
      t >= r.mint && Rule::beats(t, id, h)) {
    h.t = t;
    h.u = u;
    h.v = v;
    h.prim = id;
  }
}

// the 128 triangles of cluster c, in order
template <class Rule>
__device__ __forceinline__ void cluster(const Params& p, int c, const Ray& r,
                                        per_ray::Hit& h) {
  const float* rows = p.tris + static_cast<size_t>(c) * kTris;
#pragma unroll 1
  for (int k = 0; k < kTris; k += 4) {
    float4 q[12];
#pragma unroll
    for (int a = 0; a < 12; ++a) {
      q[a] = __ldg(reinterpret_cast<const float4*>(rows + a * p.fpad + k));
    }
    const int id = c * kTris + k;
    tri<Rule>(q[0].x, q[1].x, q[2].x, q[3].x, q[4].x, q[5].x, q[6].x,
              q[7].x, q[8].x, q[9].x, q[10].x, q[11].x, r, id, h);
    tri<Rule>(q[0].y, q[1].y, q[2].y, q[3].y, q[4].y, q[5].y, q[6].y,
              q[7].y, q[8].y, q[9].y, q[10].y, q[11].y, r, id + 1, h);
    tri<Rule>(q[0].z, q[1].z, q[2].z, q[3].z, q[4].z, q[5].z, q[6].z,
              q[7].z, q[8].z, q[9].z, q[10].z, q[11].z, r, id + 2, h);
    tri<Rule>(q[0].w, q[1].w, q[2].w, q[3].w, q[4].w, q[5].w, q[6].w,
              q[7].w, q[8].w, q[9].w, q[10].w, q[11].w, r, id + 3, h);
  }
}

template <class Rule, bool kAnyHit>
__global__ void __launch_bounds__(kThreads) legacy_kernel(const Params p) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= p.n) return;
  Ray r;
  r.ox = p.org[3 * i];
  r.oy = p.org[3 * i + 1];
  r.oz = p.org[3 * i + 2];
  r.dx = p.dir[3 * i];
  r.dy = p.dir[3 * i + 1];
  r.dz = p.dir[3 * i + 2];
  r.mint = p.min_t[i];
  const per_ray::DiffRay box_ray =
      per_ray::diff_ray(r.ox, r.oy, r.oz, r.dx, r.dy, r.dz);
  int2 lst[per_ray::kList];
  per_ray::Hit h = {p.max_t[i], 0.f, 0.f, -1};
  per_ray::cluster_walk<kAnyHit>(
      p.m, r.mint,
      [&](int c, float cap) {
        return per_ray::slab_diff(p.aabb, p.m, c, box_ray, r.mint, cap);
      },
      [&](int c, per_ray::Hit& hit) { cluster<Rule>(p, c, r, hit); }, h,
      lst);
  // v1's best starts at INF (dense.py:139), so its miss's t is INF; v2's
  // and v3's start at max t, which a miss keeps
  p.out_t[i] = Rule::kUpTo && h.prim < 0 ? p.miss_t : h.t;
  p.out_u[i] = h.u;
  p.out_v[i] = h.v;
  p.out_prim[i] = h.prim;
}

int launch(void (*kernel)(Params), const Params& p, void* stream) {
  if (p.n > 0) {
    kernel<<<(p.n + kThreads - 1) / kThreads, kThreads, 0,
             static_cast<cudaStream_t>(stream)>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// the closest hit of n rays over the m clusters of tris [12, fpad]; a
// miss's t is inf
extern "C" int dense_v1_trace(const float* tris, int fpad, const float* aabb,
                              int m, const float* org, const float* dir,
                              const float* min_t, const float* max_t,
                              float inf, int n, float* out_t, float* out_u,
                              float* out_v, int* out_prim, void* stream) {
  const Params p = {tris,  static_cast<size_t>(fpad), aabb,  m,     org,
                    dir,   min_t,                     max_t, inf,   n,
                    out_t, out_u,                     out_v, out_prim};
  return launch(legacy_kernel<V1, false>, p, stream);
}

// closest (any_hit 0) or any hit of n rays over the m clusters of tris
// [12, fpad]; a miss's t is its max t
extern "C" int dense_v2_trace(const float* tris, int fpad, const float* aabb,
                              int m, const float* org, const float* dir,
                              const float* min_t, const float* max_t,
                              int any_hit, int n, float* out_t, float* out_u,
                              float* out_v, int* out_prim, void* stream) {
  const Params p = {tris,  static_cast<size_t>(fpad), aabb,  m,     org,
                    dir,   min_t,                     max_t, 0.f,   n,
                    out_t, out_u,                     out_v, out_prim};
  return launch(any_hit ? legacy_kernel<V2, true> : legacy_kernel<V2, false>,
                p, stream);
}

// the same with v3's rule
extern "C" int dense_v3_trace(const float* tris, int fpad, const float* aabb,
                              int m, const float* org, const float* dir,
                              const float* min_t, const float* max_t,
                              int any_hit, int n, float* out_t, float* out_u,
                              float* out_v, int* out_prim, void* stream) {
  const Params p = {tris,  static_cast<size_t>(fpad), aabb,  m,     org,
                    dir,   min_t,                     max_t, 0.f,   n,
                    out_t, out_u,                     out_v, out_prim};
  return launch(any_hit ? legacy_kernel<V3, true> : legacy_kernel<V3, false>,
                p, stream);
}

// dense_v4 triangle trace kernels for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernels of pbrlab_tpu/ops/pallas/dense_v4.py:
//   dense_v4_trace       <- _trace_kernel      (wrapper dense_trace_v4)
//   dense_v4_trace_dual  <- _trace_kernel_dual (wrapper dense_trace_v4_dual)
// Bound with ctypes from pbrlab_tpu_torch/ops/dense_v4.py; the plain torch
// twin of both is pbrlab_tpu_torch/ops/per_ray.py `cluster_walk_ref`.
//
// Inputs: the attr-major triangle table [12, S] (dense_tris_v4: cluster
// c's 32 triangles at slots 32 c + k, S = 32 M), the cluster boxes [R, M]
// (dense_cluster_aabb_v4, R >= 6: rows 0:3 lo, 3:6 hi; M <= 256), and the
// rays as contiguous arrays (org/dir [N, 3], min_t/max_t [N]; the dual's
// shadow direction [N, 3], min t and max t [N]), any N.
//
// Design (per_ray.cuh `cluster_walk`): one thread a ray, 128 threads a
// block. The thread slab-tests its ray against all M boxes, each step the
// same box in every lane (a broadcast load), keeps the clusters it enters
// in a list in local memory ordered by entry t, and walks them front to
// back, a cluster's 32 triangles as 12 float4 loads per 4 triangles, until
// its own best t lies before the next entry. The dual's thread runs its
// closest query, then its shadow query as an any-hit walk with its own
// scan and list, so its closest answer is the single kernel's to the bit,
// and a lane whose shadow max t is below its min t walks no shadow ray.
// The TPU kernels walk one survivor list per 1024-ray group, which an XLA
// prelude builds from every ray's slab tests and sorts by the group's least
// entry t, so each ray pays for its group's union of clusters and rarely
// exits early; here each lane tests only the clusters it enters before its
// own best t, and needs no prelude.
//
// What bounds them: the f32 operations of each lane's own tests, 27 per
// box (M per live query) and 40 per ray-triangle test; in practice the
// latency of the dependent loads and the divergence of a warp's walks.

#include "per_ray.cuh"

namespace {

constexpr int kThreads = 128;      // threads a block, one ray each
constexpr int kMaxClusters = 256;  // ops/dense_v4.py MAX_CLUSTERS

struct Params {
  per_ray::Tables tb;
  const float* org;
  const float* dir;
  const float* min_t;
  const float* max_t;
  const float* sdir;  // dual: shadow direction, min t, max t
  const float* smin_t;
  const float* smax_t;
  int n;
  float* out_t;
  float* out_u;
  float* out_v;
  int* out_prim;
  unsigned char* out_occ;  // dual
};

// ray i's closest (or any) hit; with kDual then its shadow any-hit
template <bool kAnyHit, bool kDual>
__global__ void __launch_bounds__(kThreads) v4_kernel(const Params p) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= p.n) return;
  const float ox = p.org[3 * i], oy = p.org[3 * i + 1], oz = p.org[3 * i + 2];
  int2 lst[kMaxClusters];
  per_ray::Hit h = {p.max_t[i], 0.f, 0.f, -1};
  per_ray::cluster_walk<kAnyHit>(
      p.tb,
      per_ray::make_frame(ox, oy, oz, p.dir[3 * i], p.dir[3 * i + 1],
                          p.dir[3 * i + 2]),
      p.min_t[i], h, lst);
  p.out_t[i] = h.t;
  p.out_u[i] = h.u;
  p.out_v[i] = h.v;
  p.out_prim[i] = h.prim;
  if (kDual) {
    per_ray::Hit s = {p.smax_t[i], 0.f, 0.f, -1};
    per_ray::cluster_walk<true>(
        p.tb,
        per_ray::make_frame(ox, oy, oz, p.sdir[3 * i], p.sdir[3 * i + 1],
                            p.sdir[3 * i + 2]),
        p.smin_t[i], s, lst);
    p.out_occ[i] = s.prim >= 0 ? 1 : 0;
  }
}

int launch(void (*kernel)(Params), const Params& p, void* stream) {
  if (p.tb.nodes > kMaxClusters) return cudaErrorInvalidValue;
  if (p.n > 0) {
    kernel<<<(p.n + kThreads - 1) / kThreads, kThreads, 0,
             static_cast<cudaStream_t>(stream)>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

Params rays(const float* tris, int slots, const float* aabb, int m,
            const float* org, const float* dir, const float* min_t,
            const float* max_t, int n, float* out_t, float* out_u,
            float* out_v, int* out_prim) {
  Params p = {};
  p.tb.tris = tris;
  p.tb.stride = slots;
  p.tb.naabb = aabb;
  p.tb.nodes = m;
  p.org = org;
  p.dir = dir;
  p.min_t = min_t;
  p.max_t = max_t;
  p.n = n;
  p.out_t = out_t;
  p.out_u = out_u;
  p.out_v = out_v;
  p.out_prim = out_prim;
  return p;
}

}  // namespace

// closest (any_hit 0) or any hit of n rays over m clusters
extern "C" int dense_v4_trace(const float* tris, int slots, const float* aabb,
                              int m, const float* org, const float* dir,
                              const float* min_t, const float* max_t,
                              int any_hit, int n, float* out_t, float* out_u,
                              float* out_v, int* out_prim, void* stream) {
  const Params p = rays(tris, slots, aabb, m, org, dir, min_t, max_t, n,
                        out_t, out_u, out_v, out_prim);
  return launch(any_hit ? v4_kernel<true, false> : v4_kernel<false, false>,
                p, stream);
}

// closest hit + shadow any-hit of n lanes sharing the origin
extern "C" int dense_v4_trace_dual(
    const float* tris, int slots, const float* aabb, int m, const float* org,
    const float* dir, const float* min_t, const float* max_t,
    const float* sdir, const float* smin_t, const float* smax_t, int n,
    float* out_t, float* out_u, float* out_v, int* out_prim,
    unsigned char* out_occ, void* stream) {
  Params p = rays(tris, slots, aabb, m, org, dir, min_t, max_t, n, out_t,
                  out_u, out_v, out_prim);
  p.sdir = sdir;
  p.smin_t = smin_t;
  p.smax_t = smax_t;
  p.out_occ = out_occ;
  return launch(v4_kernel<false, true>, p, stream);
}

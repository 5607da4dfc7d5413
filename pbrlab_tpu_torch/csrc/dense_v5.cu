// dense_v5 BVH traversal kernels for Hopper (sm_90a), plain C interface.
//
// Replaces the three Pallas TPU kernels of pbrlab_tpu/ops/pallas/dense_v5.py:
//   dense_v5_trace       <- _trace_kernel      (wrapper dense_trace_v5)
//   dense_v5_trace_dual  <- _trace_kernel_dual (wrapper dense_trace_v5_dual)
//   dense_v5l_trace      <- _trace_kernel_dma  (wrapper dense_trace_v5l, and
//                           through it the dense_trace_v5s scheduler)
// Bound with ctypes from pbrlab_tpu_torch/ops/dense_v5.py; the plain torch
// twin of all three is pbrlab_tpu_torch/ops/per_ray.py `walk_ref`.
//
// Inputs: the triangle table, attr-major [12, S] (dense_tris_v4, every
// leaf's 32 slots from a multiple of 32) for v5 and the dual kernel,
// leaf-major [M, 12 * 32] (dense_tris_v5l: leaf m's attribute a of
// triangle k at m * 384 + a * 32 + k) for v5l, the BVH nodes node_aabb
// [6, Nn] (lo.xyz, hi.xyz) and node_meta [2, Nn] (right child or -1 for a
// leaf; leaf slot base), v5l's optional per-group root nodes [G], and the
// rays as contiguous arrays (org/dir [N, 3], min_t/max_t [N]; the dual's
// shadow direction [N, 3], min t and max t [N]); v5l takes N = G * 1024.
//
// Design (per_ray.cuh): one thread walks one ray alone with its own stack
// in local memory, 128 threads a block (512 blocks at 65536 lanes, 192 at
// 24576), ray i from node 0, or for v5l from node roots[i / 1024]; a
// leaf's rows take one float4 load per attribute and 4 triangles. The
// dual kernel's thread walks its closest ray, then its shadow ray (any-hit
// from the same origin with its own min and max t) on the same stack; a
// lane whose shadow max t is below its min t walks no shadow ray. So the
// dual's closest answer is the single kernel's to the bit, and its
// occlusion that of an any-hit launch on the shadow rays. A dead lane
// (max t < min t) pushes nothing. They replace packet walks of one
// 1024-ray group per 1024-thread block, as the TPU walks one group per
// grid step: each ray paid for the union of its group's nodes and leaves
// (the dual for the union of both queries'), one or two block barriers
// per node kept the block in lock-step, and 65536 lanes made 64 blocks.
//
// What bounds them: the f32 operations of each lane's own tests (about
// 40 per ray-triangle and 27 per ray-box test), in practice the latency
// of the dependent node and leaf loads and the divergence of a warp's
// walks.

#include "per_ray.cuh"

namespace {

constexpr int kGroup = 1024;   // v5l: rays per group root
constexpr int kStack = 128;    // ops/build.py STACK (the build checks depth)
constexpr int kThreads = 128;  // threads a block, one ray each

struct Params {
  per_ray::Tables tb;
  const int* roots;  // v5l: [n / 1024], or null: node 0
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
template <bool kAnyHit, bool kLeafMajor, bool kDual>
__device__ __forceinline__ void trace_ray(const Params& p, int i) {
  const float ox = p.org[3 * i], oy = p.org[3 * i + 1], oz = p.org[3 * i + 2];
  int2 stk[kStack];
  per_ray::Hit h = {p.max_t[i], 0.f, 0.f, -1};
  per_ray::walk<false, kAnyHit, kLeafMajor, kStack>(
      p.tb,
      per_ray::make_frame(ox, oy, oz, p.dir[3 * i], p.dir[3 * i + 1],
                          p.dir[3 * i + 2]),
      p.min_t[i], p.roots ? p.roots[i / kGroup] : 0, h, stk);
  p.out_t[i] = h.t;
  p.out_u[i] = h.u;
  p.out_v[i] = h.v;
  p.out_prim[i] = h.prim;
  if (kDual) {
    per_ray::Hit s = {p.smax_t[i], 0.f, 0.f, -1};
    per_ray::walk<false, true, kLeafMajor, kStack>(
        p.tb,
        per_ray::make_frame(ox, oy, oz, p.sdir[3 * i], p.sdir[3 * i + 1],
                            p.sdir[3 * i + 2]),
        p.smin_t[i], 0, s, stk);
    p.out_occ[i] = s.prim >= 0 ? 1 : 0;
  }
}

template <bool kAnyHit, bool kDual>
__global__ void __launch_bounds__(kThreads) v5_kernel(const Params p) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < p.n) trace_ray<kAnyHit, false, kDual>(p, i);
}

template <bool kAnyHit>
__global__ void __launch_bounds__(kThreads) v5l_kernel(const Params p) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < p.n) trace_ray<kAnyHit, true, false>(p, i);
}

int launch(void (*kernel)(Params), const Params& p, void* stream) {
  if (p.n > 0) {
    kernel<<<(p.n + kThreads - 1) / kThreads, kThreads, 0,
             static_cast<cudaStream_t>(stream)>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

Params rays(const float* tris, size_t stride, const float* naabb,
            const int* nmeta, int nodes, const float* org, const float* dir,
            const float* min_t, const float* max_t, int n, float* out_t,
            float* out_u, float* out_v, int* out_prim) {
  Params p = {};
  p.tb.tris = tris;
  p.tb.stride = stride;
  p.tb.naabb = naabb;
  p.tb.nmeta = nmeta;
  p.tb.nodes = nodes;
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

// closest (any_hit 0) or any hit of n rays over the attr-major [12, slots]
// table
extern "C" int dense_v5_trace(const float* tris, int slots,
                              const float* naabb, const int* nmeta, int nodes,
                              const float* org, const float* dir,
                              const float* min_t, const float* max_t,
                              int any_hit, int n, float* out_t, float* out_u,
                              float* out_v, int* out_prim, void* stream) {
  const Params p = rays(tris, slots, naabb, nmeta, nodes, org, dir, min_t,
                        max_t, n, out_t, out_u, out_v, out_prim);
  return launch(any_hit ? v5_kernel<true, false> : v5_kernel<false, false>,
                p, stream);
}

// closest hit + shadow any-hit of n lanes sharing the origin, attr-major
// table
extern "C" int dense_v5_trace_dual(
    const float* tris, int slots, const float* naabb, const int* nmeta,
    int nodes, const float* org, const float* dir, const float* min_t,
    const float* max_t, const float* sdir, const float* smin_t,
    const float* smax_t, int n, float* out_t, float* out_u, float* out_v,
    int* out_prim, unsigned char* out_occ, void* stream) {
  Params p = rays(tris, slots, naabb, nmeta, nodes, org, dir, min_t, max_t,
                  n, out_t, out_u, out_v, out_prim);
  p.sdir = sdir;
  p.smin_t = smin_t;
  p.smax_t = smax_t;
  p.out_occ = out_occ;
  return launch(v5_kernel<false, true>, p, stream);
}

// closest or any hit over the leaf-major [M, 384] table, groups * 1024
// rays, ray i from node roots[i / 1024] (roots null: the whole tree)
extern "C" int dense_v5l_trace(const float* tris, const float* naabb,
                               const int* nmeta, int nodes, const int* roots,
                               const float* org, const float* dir,
                               const float* min_t, const float* max_t,
                               int any_hit, int groups, float* out_t,
                               float* out_u, float* out_v, int* out_prim,
                               void* stream) {
  Params p = rays(tris, per_ray::kCluster, naabb, nmeta, nodes, org, dir,
                  min_t, max_t, groups * kGroup, out_t, out_u, out_v,
                  out_prim);
  p.roots = roots;
  return launch(any_hit ? v5l_kernel<true> : v5l_kernel<false>, p, stream);
}

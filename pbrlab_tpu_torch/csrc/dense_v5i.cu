// dense_v5i two-level (TLAS/BLAS) per-ray traversal kernel for Hopper
// (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel pbrlab_tpu/ops/pallas/dense_v5i.py
// _trace_kernel (wrapper dense_trace_v5i): closest hit or any hit over an
// instanced scene, where each local scene is one BLAS in local space shared
// by its instances and the TLAS leaves are instances with a world-to-local
// affine transform. Bound with ctypes from pbrlab_tpu_torch/ops/dense_v5i.py;
// the plain torch twin is pbrlab_tpu_torch/ops/per_ray.py `walk_ref`.
//
// Inputs: the packed local triangles attr-major [12, S] (i5_tris; every
// leaf's 32 slots start at a multiple of 32), one node array for both
// levels, node_aabb [6, Nn] and node_meta [2, Nn] (TLAS nodes first:
// meta[0] the right child or -1 on a leaf; on a leaf meta[1] the BLAS slot
// base, or -(instance + 1) on a TLAS leaf), per instance inst_inv [12, K]
// (world-to-local rows r00 r01 r02 t0 r10 ...) and inst_meta [2, K] (BLAS
// root node, slot-to-face-id delta), and the rays as contiguous arrays
// (org/dir [N, 3], min_t/max_t [N]).
//
// Design (per_ray.cuh): one thread walks one ray through both levels with
// its own stack, 128 threads a block, so 65536 lanes make 512 blocks for
// the 132 SMs and no lane waits for another. The kernel it replaces
// walked one 1024-ray group per 1024-thread block, as the TPU walks one
// group per grid step: each ray paid for the union of its group's nodes
// and leaves (on random bounce rays nearly all 256 instances), one or two
// block barriers per node kept 1024 threads in lock-step, and 65536 lanes
// made only 64 blocks.
//
// What bounds it: the f32 operations of the tests each lane does (about
// 40 per ray-triangle test, 27 per ray-box test, 42 per transform), and in
// practice the latency of the dependent node and leaf loads and the
// divergence of 32 lanes' walks in a warp. The stack: STACK = 160 entries
// (the build checks TLAS depth + deepest BLAS + 4 < 160, and a lane needs
// at most their sum + 2), in local memory.

#include "per_ray.cuh"

namespace {

constexpr int kStack = 160;
constexpr int kThreads = 128;

struct Params {
  per_ray::Tables tb;
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

template <bool kAnyHit>
__global__ void __launch_bounds__(kThreads) v5i_kernel(const Params p) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= p.n) return;
  const per_ray::Frame world =
      per_ray::make_frame(p.org[3 * i], p.org[3 * i + 1], p.org[3 * i + 2],
                          p.dir[3 * i], p.dir[3 * i + 1], p.dir[3 * i + 2]);
  per_ray::Hit h = {p.max_t[i], 0.f, 0.f, -1};
  int2 stk[kStack];
  per_ray::walk<true, kAnyHit, false, kStack>(p.tb, world, p.min_t[i], 0, h,
                                              stk);
  p.out_t[i] = h.t;
  p.out_u[i] = h.u;
  p.out_v[i] = h.v;
  p.out_prim[i] = h.prim;
}

}  // namespace

// closest (any_hit 0) or any hit over an instanced scene's tables, n rays
extern "C" int dense_v5i_trace(const float* tris, int slots,
                               const float* naabb, const int* nmeta,
                               int nodes, const float* inv, const int* imeta,
                               int insts, const float* org, const float* dir,
                               const float* min_t, const float* max_t,
                               int any_hit, int n, float* out_t,
                               float* out_u, float* out_v, int* out_prim,
                               void* stream) {
  Params p = {};
  p.tb.tris = tris;
  p.tb.stride = static_cast<size_t>(slots);
  p.tb.naabb = naabb;
  p.tb.nmeta = nmeta;
  p.tb.nodes = nodes;
  p.tb.inv = inv;
  p.tb.imeta = imeta;
  p.tb.insts = insts;
  p.org = org;
  p.dir = dir;
  p.min_t = min_t;
  p.max_t = max_t;
  p.n = n;
  p.out_t = out_t;
  p.out_u = out_u;
  p.out_v = out_v;
  p.out_prim = out_prim;
  if (n > 0) {
    const int blocks = (n + kThreads - 1) / kThreads;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (any_hit) {
      v5i_kernel<true><<<blocks, kThreads, 0, s>>>(p);
    } else {
      v5i_kernel<false><<<blocks, kThreads, 0, s>>>(p);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

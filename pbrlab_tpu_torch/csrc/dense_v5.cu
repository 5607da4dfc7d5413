// dense_v5 BVH traversal kernels for Hopper (sm_90a), plain C interface.
//
// Replaces the three Pallas TPU kernels of pbrlab_tpu/ops/pallas/dense_v5.py:
//   dense_v5_trace       <- _trace_kernel      (wrapper dense_trace_v5)
//   dense_v5_trace_dual  <- _trace_kernel_dual (wrapper dense_trace_v5_dual)
//   dense_v5l_trace      <- _trace_kernel_dma  (wrapper dense_trace_v5l, and
//                           through it the dense_trace_v5s scheduler)
// Bound with ctypes from pbrlab_tpu_torch/ops/dense_v5.py, which also holds
// the plain torch version of the two packet kernels (_packet_ref); the
// plain twin of the per-ray v5l kernel is pbrlab_tpu_torch/ops/per_ray.py
// `walk_ref`.
//
// Inputs: the triangle table, attr-major [12, S] (dense_tris_v4) for v5
// and the dual kernel, leaf-major [M, 12 * 32] (dense_tris_v5l: leaf m's
// attribute a of triangle k at m * 384 + a * 32 + k) for v5l, the BVH
// nodes node_aabb [6, Nn] (lo.xyz, hi.xyz) and node_meta [2, Nn] (right
// child or -1 for a leaf; leaf slot base), v5l's optional per-group root
// nodes [G], and the rays as contiguous arrays (org/dir [N, 3],
// min_t/max_t [N]) with N = G * 1024.
//
// dense_v5l_trace (per_ray.cuh): one thread walks one ray alone with its
// own stack in local memory, 128 threads a block (512 blocks at 65536
// lanes), ray i from node roots[i / 1024] or node 0; the leaf-major rows
// take one float4 load per attribute and 4 triangles. It replaces a packet
// walk of one 1024-ray group per block (the group union of nodes and
// leaves, block barriers per node, 64 blocks at 65536 lanes). What bounds
// it: the f32 operations of each lane's own tests (about 40 per
// ray-triangle and 27 per ray-box test), in practice the latency of the
// dependent node and leaf loads and the divergence of a warp's walks.
//
// dense_v5_trace and dense_v5_trace_dual: one thread block walks one
// 1024-ray group, one thread per ray, exactly as the TPU kernel walks one
// group per grid step. The group-wide scalars of the Pallas body become
// block reductions: a child's entry t (jnp.min over the group's slab
// entries, :194), gmax after a leaf (jnp.max, :245) and the any-hit exit
// (jnp.all, :250). Min and max are exact in any order, so each reduction
// gives every thread the TPU's value and every thread takes the same
// branch: the loop, its stack and its __syncthreads stay uniform over the
// block. The walk, the near-first push order, the cull test (`live`, :206)
// and the float ops of the triangle test are the Pallas body's, in its
// order; the library is built with --fmad=false and IEEE division, so the
// plain torch walk gives the same bits. The 128-entry (node, entry t) stack
// lives in shared memory. Every thread writes the same entries at the same
// step, and only after that step's reduction barrier; it pops only what it
// wrote itself. So a pop never races with another thread's push, and no
// extra barrier is needed. A visited leaf's 384 floats are staged in shared
// memory, one float per thread; the 32 triangle tests then read it as
// broadcasts. What bounds them: f32 divides and multiply-adds of the
// ray-triangle tests (about 40 operations per ray and triangle) and the
// block barriers of the walk (one or two per node). Known first-cut
// weakness: each ray pays for the union of its group's nodes and leaves,
// and a block holds one group (their per-ray redesign is later work).

#include "per_ray.cuh"

namespace {

using per_ray::inv_dir;
using per_ray::kBig;
using per_ray::kCluster;
using per_ray::kSlop;
using per_ray::pmax;
using per_ray::pmin;

constexpr int kGroup = 1024;
constexpr int kStack = 128;
constexpr int kWarps = kGroup / 32;
constexpr int kLeafFloats = 12 * kCluster;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kRayThreads = 128;  // v5l: threads a block, one ray each

enum Mode { kClosest = 0, kAnyHit = 1, kDual = 2 };

struct Params {
  const float* tris;   // [12, S] attr-major
  int slots;           // S (row stride)
  const float* naabb;  // [6, Nn]
  const int* nmeta;    // [2, Nn]
  int nodes;           // Nn
  const float* org;
  const float* dir;
  const float* min_t;
  const float* max_t;
  const float* sdir;  // dual: shadow direction, min t, max t
  const float* smin_t;
  const float* smax_t;
  float* out_t;
  float* out_u;
  float* out_v;
  int* out_prim;
  unsigned char* out_occ;  // dual
};

struct Slab {  // one ray's slab-test terms against node boxes
  float ix, iy, iz, ox, oy, oz, mint;
};

// entry t of the ray into box `node` if it enters before `cap`, else kBig
__device__ __forceinline__ float slab(const float* __restrict__ naabb,
                                      int nodes, int node, const Slab& s,
                                      float cap) {
  float t0 = __ldg(naabb + node) * s.ix - s.ox;
  float t1 = __ldg(naabb + 3 * nodes + node) * s.ix - s.ox;
  const float nx = pmin(t0, t1), fx = pmax(t0, t1);
  t0 = __ldg(naabb + nodes + node) * s.iy - s.oy;
  t1 = __ldg(naabb + 4 * nodes + node) * s.iy - s.oy;
  const float ny = pmin(t0, t1), fy = pmax(t0, t1);
  t0 = __ldg(naabb + 2 * nodes + node) * s.iz - s.oz;
  t1 = __ldg(naabb + 5 * nodes + node) * s.iz - s.oz;
  const float nz = pmin(t0, t1), fz = pmax(t0, t1);
  const float tnear = pmax(pmax(nx, ny), pmax(nz, s.mint));
  const float tfar = pmin(pmin(fx, fy), pmin(fz, cap));
  return tnear <= tfar * kSlop ? tnear : kBig;
}

// Block-wide min (kMax false) or NaN-propagating max of two values; every
// thread gets the results. `red` alternates between two buffers, so a
// thread still reading one reduction's partials never sees the next one's.
template <bool kMax>
__device__ __forceinline__ void block_reduce2(float& a, float& b,
                                              float (*red)[kWarps][2],
                                              int& buf) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float oa = __shfl_xor_sync(kFull, a, o);
    const float ob = __shfl_xor_sync(kFull, b, o);
    a = kMax ? pmax(a, oa) : fminf(a, oa);
    b = kMax ? pmax(b, ob) : fminf(b, ob);
  }
  const int lane = threadIdx.x & 31;
  if (lane == 0) {
    red[buf][threadIdx.x >> 5][0] = a;
    red[buf][threadIdx.x >> 5][1] = b;
  }
  __syncthreads();
  a = red[buf][lane][0];  // kWarps == 32: lane l reads warp l's partial
  b = red[buf][lane][1];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float oa = __shfl_xor_sync(kFull, a, o);
    const float ob = __shfl_xor_sync(kFull, b, o);
    a = kMax ? pmax(a, oa) : fminf(a, oa);
    b = kMax ? pmax(b, ob) : fminf(b, ob);
  }
  buf ^= 1;
}

template <int kMode>
__global__ void __launch_bounds__(kGroup, 1) v5_kernel(const Params p) {
  static_assert(kWarps == 32, "the reductions assume 32 warps");
  __shared__ int stk_id[kStack];
  __shared__ float stk_tn[kStack];
  __shared__ float red[2][kWarps][2];
  __shared__ float leaf[kLeafFloats];
  int buf = 0;

  const size_t i = static_cast<size_t>(blockIdx.x) * kGroup + threadIdx.x;
  const float ox = p.org[3 * i], oy = p.org[3 * i + 1], oz = p.org[3 * i + 2];
  const float dx = p.dir[3 * i], dy = p.dir[3 * i + 1], dz = p.dir[3 * i + 2];
  const float mint = p.min_t[i], maxt = p.max_t[i];
  Slab sc;
  sc.ix = inv_dir(dx);
  sc.iy = inv_dir(dy);
  sc.iz = inv_dir(dz);
  sc.ox = ox * sc.ix;
  sc.oy = oy * sc.iy;
  sc.oz = oz * sc.iz;
  sc.mint = mint;
  float best_t = maxt, best_u = 0.f, best_v = 0.f;
  int best_p = -1;

  // dual: the shadow query from the same origin
  float sx = 0.f, sy = 0.f, sz = 0.f, smaxt = -1.f;
  bool s_dead = true, occ = false;
  Slab ss;
  if (kMode == kDual) {
    sx = p.sdir[3 * i];
    sy = p.sdir[3 * i + 1];
    sz = p.sdir[3 * i + 2];
    ss.mint = p.smin_t[i];
    smaxt = p.smax_t[i];
    s_dead = smaxt < ss.mint;
    ss.ix = inv_dir(sx);
    ss.iy = inv_dir(sy);
    ss.iz = inv_dir(sz);
    ss.ox = ox * ss.ix;
    ss.oy = oy * ss.iy;
    ss.oz = oz * ss.iz;
  }

  // gmax: the largest t any lane can still use (the cull bound); a group
  // with none (all lanes dead: max_t < 0) walks nothing
  float gmax = best_t;
  float gmax_s = kMode == kDual ? (s_dead ? -1.f : smaxt) : best_t;
  block_reduce2<true>(gmax, gmax_s, red, buf);
  gmax = pmax(gmax, gmax_s);
  stk_id[0] = 0;
  stk_tn[0] = -1e30f;
  int sp = gmax >= 0.f ? 1 : 0;

  while (sp > 0) {
    --sp;
    const int node = stk_id[sp];
    const float tn_pop = stk_tn[sp];
    // relative + absolute pad: as tolerant as the slab test
    if (!(tn_pop * 0.999999f - 1e-6f <= gmax)) continue;
    const int right = __ldg(p.nmeta + node);
    if (right < 0) {
      const int base = __ldg(p.nmeta + p.nodes + node);
      // stage the leaf's 12 x 32 floats, one per thread; the last reader
      // of the previous leaf passed a barrier (its gmax reduction) since
      if (threadIdx.x < kLeafFloats) {
        const int a = threadIdx.x / kCluster, k = threadIdx.x % kCluster;
        leaf[threadIdx.x] =
            __ldg(p.tris + static_cast<size_t>(a) * p.slots + base + k);
      }
      __syncthreads();
#pragma unroll 4
      for (int k = 0; k < kCluster; ++k) {
        const float nx = leaf[0 * kCluster + k];
        const float ny = leaf[1 * kCluster + k];
        const float nz = leaf[2 * kCluster + k];
        const float k0 = leaf[3 * kCluster + k];
        const float b1x = leaf[4 * kCluster + k];
        const float b1y = leaf[5 * kCluster + k];
        const float b1z = leaf[6 * kCluster + k];
        const float c1 = leaf[7 * kCluster + k];
        const float b2x = leaf[8 * kCluster + k];
        const float b2y = leaf[9 * kCluster + k];
        const float b2z = leaf[10 * kCluster + k];
        const float c2 = leaf[11 * kCluster + k];
        // origin terms are shared by both queries of the dual kernel
        const float num = k0 - (ox * nx + oy * ny + oz * nz);
        const float ob1 = ox * b1x + oy * b1y + oz * b1z - c1;
        const float ob2 = ox * b2x + oy * b2y + oz * b2z - c2;
        // den == 0 (padding rows are all zero) -> t inf/nan -> no hit
        const float t = num / (dx * nx + dy * ny + dz * nz);
        const float u = ob1 + t * (dx * b1x + dy * b1y + dz * b1z);
        const float v = ob2 + t * (dx * b2x + dy * b2y + dz * b2z);
        // strict t < best_t keeps the first-visited triangle on ties
        if (u >= 0.f && v >= 0.f && u + v <= 1.f && t >= mint && t < best_t) {
          best_t = t;
          best_u = u;
          best_v = v;
          best_p = base + k;
        }
        if (kMode == kDual) {
          const float ts = num / (sx * nx + sy * ny + sz * nz);
          const float us = ob1 + ts * (sx * b1x + sy * b1y + sz * b1z);
          const float vs = ob2 + ts * (sx * b2x + sy * b2y + sz * b2z);
          if (us >= 0.f && vs >= 0.f && us + vs <= 1.f && ts >= ss.mint &&
              ts < smaxt) {
            occ = true;
          }
        }
      }
      float g1 = best_t;
      float g2 = kMode == kDual ? ((s_dead || occ) ? -1.f : smaxt) : best_t;
      block_reduce2<true>(g1, g2, red, buf);
      gmax = pmax(g1, g2);
      if (kMode == kAnyHit) {
        // stop once every live lane has an occluder; dead and padding
        // lanes (max_t < min_t) can never find one and must not block it
        if (__syncthreads_and(best_p >= 0 || maxt < mint)) sp = 0;
      }
    } else {
      const int left = node + 1;
      float tn_l = slab(p.naabb, p.nodes, left, sc, best_t);
      float tn_r = slab(p.naabb, p.nodes, right, sc, best_t);
      if (kMode == kDual) {
        // union over both queries: a settled or absent shadow query caps
        // its far t below every entry
        const float cap = (s_dead || occ) ? -kBig : smaxt;
        tn_l = fminf(tn_l, slab(p.naabb, p.nodes, left, ss, cap));
        tn_r = fminf(tn_r, slab(p.naabb, p.nodes, right, ss, cap));
      }
      block_reduce2<false>(tn_l, tn_r, red, buf);
      // push the far child first, the near one second (popped first)
      const bool l_far = tn_l > tn_r;
      const float far_tn = pmax(tn_l, tn_r), near_tn = pmin(tn_l, tn_r);
      if (far_tn < kBig) {
        stk_id[sp] = l_far ? left : right;
        stk_tn[sp] = far_tn;
        ++sp;
      }
      if (near_tn < kBig) {
        stk_id[sp] = l_far ? right : left;
        stk_tn[sp] = near_tn;
        ++sp;
      }
    }
  }

  p.out_t[i] = best_t;
  p.out_u[i] = best_u;
  p.out_v[i] = best_v;
  p.out_prim[i] = best_p;
  if (kMode == kDual) p.out_occ[i] = occ ? 1 : 0;
}

template <int kMode>
int launch(const Params& p, int groups, void* stream) {
  if (groups > 0) {
    v5_kernel<kMode><<<groups, kGroup, 0,
                       static_cast<cudaStream_t>(stream)>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

Params rays(const float* tris, int slots, const float* naabb,
            const int* nmeta, int nodes, const float* org, const float* dir,
            const float* min_t, const float* max_t, float* out_t,
            float* out_u, float* out_v, int* out_prim) {
  Params p = {};
  p.tris = tris;
  p.slots = slots;
  p.naabb = naabb;
  p.nmeta = nmeta;
  p.nodes = nodes;
  p.org = org;
  p.dir = dir;
  p.min_t = min_t;
  p.max_t = max_t;
  p.out_t = out_t;
  p.out_u = out_u;
  p.out_v = out_v;
  p.out_prim = out_prim;
  return p;
}

struct RayParams {  // dense_v5l: n rays, each from its group's root
  per_ray::Tables tb;
  const int* roots;  // [n / 1024] or null: node 0
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
__global__ void __launch_bounds__(kRayThreads) v5l_kernel(const RayParams p) {
  const int i = blockIdx.x * kRayThreads + threadIdx.x;
  if (i >= p.n) return;
  const per_ray::Frame f =
      per_ray::make_frame(p.org[3 * i], p.org[3 * i + 1], p.org[3 * i + 2],
                          p.dir[3 * i], p.dir[3 * i + 1], p.dir[3 * i + 2]);
  per_ray::Hit h = {p.max_t[i], 0.f, 0.f, -1};
  per_ray::walk<false, kAnyHit, true, kStack>(
      p.tb, f, p.min_t[i], p.roots ? p.roots[i / kGroup] : 0, h);
  p.out_t[i] = h.t;
  p.out_u[i] = h.u;
  p.out_v[i] = h.v;
  p.out_prim[i] = h.prim;
}

}  // namespace

// closest (any_hit 0) or any hit over the attr-major [12, slots] table
extern "C" int dense_v5_trace(const float* tris, int slots,
                              const float* naabb, const int* nmeta, int nodes,
                              const float* org, const float* dir,
                              const float* min_t, const float* max_t,
                              int any_hit, int groups, float* out_t,
                              float* out_u, float* out_v, int* out_prim,
                              void* stream) {
  const Params p = rays(tris, slots, naabb, nmeta, nodes, org, dir, min_t,
                        max_t, out_t, out_u, out_v, out_prim);
  return any_hit ? launch<kAnyHit>(p, groups, stream)
                 : launch<kClosest>(p, groups, stream);
}

// closest hit + shadow any-hit sharing the origin, attr-major table
extern "C" int dense_v5_trace_dual(
    const float* tris, int slots, const float* naabb, const int* nmeta,
    int nodes, const float* org, const float* dir, const float* min_t,
    const float* max_t, const float* sdir, const float* smin_t,
    const float* smax_t, int groups, float* out_t, float* out_u,
    float* out_v, int* out_prim, unsigned char* out_occ, void* stream) {
  Params p = rays(tris, slots, naabb, nmeta, nodes, org, dir, min_t, max_t,
                  out_t, out_u, out_v, out_prim);
  p.sdir = sdir;
  p.smin_t = smin_t;
  p.smax_t = smax_t;
  p.out_occ = out_occ;
  return launch<kDual>(p, groups, stream);
}

// closest or any hit over the leaf-major [M, 384] table, one thread per
// ray, ray i from node roots[i / 1024] (roots null: the whole tree)
extern "C" int dense_v5l_trace(const float* tris, const float* naabb,
                               const int* nmeta, int nodes, const int* roots,
                               const float* org, const float* dir,
                               const float* min_t, const float* max_t,
                               int any_hit, int groups, float* out_t,
                               float* out_u, float* out_v, int* out_prim,
                               void* stream) {
  RayParams p = {};
  p.tb.tris = tris;
  p.tb.stride = kCluster;
  p.tb.naabb = naabb;
  p.tb.nmeta = nmeta;
  p.tb.nodes = nodes;
  p.roots = roots;
  p.org = org;
  p.dir = dir;
  p.min_t = min_t;
  p.max_t = max_t;
  p.n = groups * kGroup;
  p.out_t = out_t;
  p.out_u = out_u;
  p.out_v = out_v;
  p.out_prim = out_prim;
  if (groups > 0) {
    const int blocks = (p.n + kRayThreads - 1) / kRayThreads;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (any_hit) {
      v5l_kernel<true><<<blocks, kRayThreads, 0, s>>>(p);
    } else {
      v5l_kernel<false><<<blocks, kRayThreads, 0, s>>>(p);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

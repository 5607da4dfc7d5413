// dense_v4 triangle trace kernels for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernels of pbrlab_tpu/ops/pallas/dense_v4.py:
//   dense_v4_trace       <- _trace_kernel      (wrapper dense_trace_v4)
//   dense_v4_trace_dual  <- _trace_kernel_dual (wrapper dense_trace_v4_dual)
// Bound with ctypes from pbrlab_tpu_torch/ops/dense_v4.py, which also holds
// the plain torch version of both (_walk_ref) and the prelude that builds
// the survivor lists.
//
// Inputs: tris [12, S] packed linear forms (n, k0, b1, c1, b2, c2; see
// ops/build.py), per 1024-ray group g a front-to-back survivor list
// surv[g, 0:cnt[g]] of 32-triangle cluster ids with tnear[g, :] the
// group's lower bound of the slab entry t of each, and the rays as
// separate contiguous arrays (org/dir [N, 3], min_t/max_t [N]).
//
// Design: one thread per ray; a ray's group is i / 1024, so all 32 threads
// of a warp walk the same survivor list and every triangle load is a
// broadcast. The 12 floats of a triangle are read with __ldg; at the bench
// scene's 3904 slots the table is 187 KB and stays in L1/L2. The arithmetic
// is the Pallas body's (dense_v4.py:166-193, :305-340) in the same order;
// the library is built with --fmad=false and IEEE division so the plain
// torch walk gives the same bits.
//
// Early exit is per thread where the TPU exits per group. The list is
// sorted by a lower bound of every ray's own slab entry t into each
// cluster, and a triangle's hit t is no less than the slab entry of its
// cluster's box (within the 1e-6 pad), so once best_t <= tnear[si] (padded)
// no later cluster can give a closer hit: stopping the lane there returns
// the same hit as walking on, which is what the group-wide exit of the TPU
// kernel and the exit-free plain version both return.
//
// What bounds it: f32 divides and multiply-adds per (ray, triangle) pair,
// with the table in cache. Known first-cut weakness: at 65536 lanes there
// are only 64 groups, and rays of one warp diverge in hit distance, so
// some threads idle while others walk on.

#include <cuda_runtime.h>

namespace {

constexpr int kGroup = 1024;
constexpr int kCluster = 32;
constexpr int kBlock = 256;

struct Tri {
  float nx, ny, nz, k0, b1x, b1y, b1z, c1, b2x, b2y, b2z, c2;
};

__device__ __forceinline__ Tri load_tri(const float* __restrict__ tris,
                                        int slots, int i) {
  Tri r;
  r.nx = __ldg(tris + 0 * slots + i);
  r.ny = __ldg(tris + 1 * slots + i);
  r.nz = __ldg(tris + 2 * slots + i);
  r.k0 = __ldg(tris + 3 * slots + i);
  r.b1x = __ldg(tris + 4 * slots + i);
  r.b1y = __ldg(tris + 5 * slots + i);
  r.b1z = __ldg(tris + 6 * slots + i);
  r.c1 = __ldg(tris + 7 * slots + i);
  r.b2x = __ldg(tris + 8 * slots + i);
  r.b2y = __ldg(tris + 9 * slots + i);
  r.b2z = __ldg(tris + 10 * slots + i);
  r.c2 = __ldg(tris + 11 * slots + i);
  return r;
}

// cluster entry bound with the TPU kernel's relative + absolute pad
// (0.999999f is 1 - 1e-6 rounded to float, as the Pallas body computes it)
__device__ __forceinline__ float exit_bound(float tnear) {
  return tnear * 0.999999f - 1e-6f;
}

__global__ void trace_kernel(const float* __restrict__ tris, int slots,
                             const int* __restrict__ surv,
                             const int* __restrict__ cnt,
                             const float* __restrict__ tnear, int m,
                             const float* __restrict__ org,
                             const float* __restrict__ dir,
                             const float* __restrict__ min_t,
                             const float* __restrict__ max_t, int any_hit,
                             int n, float* __restrict__ out_t,
                             float* __restrict__ out_u,
                             float* __restrict__ out_v,
                             int* __restrict__ out_prim) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int g = i / kGroup;
  const float ox = org[3 * i], oy = org[3 * i + 1], oz = org[3 * i + 2];
  const float dx = dir[3 * i], dy = dir[3 * i + 1], dz = dir[3 * i + 2];
  const float mint = min_t[i], maxt = max_t[i];
  // dead lanes (max_t < min_t) count as done for the any-hit exit
  const bool dead = maxt < mint;
  float best_t = maxt, best_u = 0.f, best_v = 0.f;
  int best_p = -1;
  const int count = cnt[g];
  const int* gsurv = surv + static_cast<size_t>(g) * m;
  const float* gnear = tnear + static_cast<size_t>(g) * m;
  for (int si = 0; si < count; ++si) {
    if (!(best_t > exit_bound(gnear[si]))) break;
    if (any_hit && (best_p >= 0 || dead)) break;
    const int base = gsurv[si] * kCluster;
    for (int k = 0; k < kCluster; ++k) {
      const int idx = base + k;
      const Tri tr = load_tri(tris, slots, idx);
      const float den = dx * tr.nx + dy * tr.ny + dz * tr.nz;
      const float num = tr.k0 - (ox * tr.nx + oy * tr.ny + oz * tr.nz);
      // den == 0 (padding rows are all zero) -> t inf/nan -> no hit
      const float t = num / den;
      const float u = (ox * tr.b1x + oy * tr.b1y + oz * tr.b1z - tr.c1) +
                      t * (dx * tr.b1x + dy * tr.b1y + dz * tr.b1z);
      const float v = (ox * tr.b2x + oy * tr.b2y + oz * tr.b2z - tr.c2) +
                      t * (dx * tr.b2x + dy * tr.b2y + dz * tr.b2z);
      // strict t < best_t keeps the first-visited triangle on ties
      if (u >= 0.f && v >= 0.f && u + v <= 1.f && t >= mint && t < best_t) {
        best_t = t;
        best_u = u;
        best_v = v;
        best_p = idx;
      }
    }
  }
  out_t[i] = best_t;
  out_u[i] = best_u;
  out_v[i] = best_v;
  out_prim[i] = best_p;
}

__global__ void trace_dual_kernel(
    const float* __restrict__ tris, int slots, const int* __restrict__ surv,
    const int* __restrict__ cnt, const float* __restrict__ tnear, int m,
    const float* __restrict__ org, const float* __restrict__ dir,
    const float* __restrict__ min_t, const float* __restrict__ max_t,
    const float* __restrict__ sdir, const float* __restrict__ smin_t,
    const float* __restrict__ smax_t, int n, float* __restrict__ out_t,
    float* __restrict__ out_u, float* __restrict__ out_v,
    int* __restrict__ out_prim, unsigned char* __restrict__ out_occ) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int g = i / kGroup;
  const float ox = org[3 * i], oy = org[3 * i + 1], oz = org[3 * i + 2];
  const float dx = dir[3 * i], dy = dir[3 * i + 1], dz = dir[3 * i + 2];
  const float sx = sdir[3 * i], sy = sdir[3 * i + 1], sz = sdir[3 * i + 2];
  const float mint = min_t[i], maxt = max_t[i];
  const float smint = smin_t[i], smaxt = smax_t[i];
  const bool s_dead = smaxt < smint;  // no shadow query on this lane
  float best_t = maxt, best_u = 0.f, best_v = 0.f;
  int best_p = -1;
  bool occ = false;
  const int count = cnt[g];
  const int* gsurv = surv + static_cast<size_t>(g) * m;
  const float* gnear = tnear + static_cast<size_t>(g) * m;
  for (int si = 0; si < count; ++si) {
    const float bound = exit_bound(gnear[si]);
    const bool can_c = best_t > bound;
    // an unresolved shadow query can still be occluded by clusters
    // entered before its max t
    const bool can_s = !(s_dead || occ) && smaxt > bound;
    if (!(can_c || can_s)) break;
    const int base = gsurv[si] * kCluster;
    for (int k = 0; k < kCluster; ++k) {
      const int idx = base + k;
      const Tri tr = load_tri(tris, slots, idx);
      // origin terms are shared by both queries
      const float num = tr.k0 - (ox * tr.nx + oy * tr.ny + oz * tr.nz);
      const float ob1 = ox * tr.b1x + oy * tr.b1y + oz * tr.b1z - tr.c1;
      const float ob2 = ox * tr.b2x + oy * tr.b2y + oz * tr.b2z - tr.c2;
      const float t = num / (dx * tr.nx + dy * tr.ny + dz * tr.nz);
      const float u = ob1 + t * (dx * tr.b1x + dy * tr.b1y + dz * tr.b1z);
      const float v = ob2 + t * (dx * tr.b2x + dy * tr.b2y + dz * tr.b2z);
      if (u >= 0.f && v >= 0.f && u + v <= 1.f && t >= mint && t < best_t) {
        best_t = t;
        best_u = u;
        best_v = v;
        best_p = idx;
      }
      const float ts = num / (sx * tr.nx + sy * tr.ny + sz * tr.nz);
      const float us = ob1 + ts * (sx * tr.b1x + sy * tr.b1y + sz * tr.b1z);
      const float vs = ob2 + ts * (sx * tr.b2x + sy * tr.b2y + sz * tr.b2z);
      if (us >= 0.f && vs >= 0.f && us + vs <= 1.f && ts >= smint &&
          ts < smaxt) {
        occ = true;
      }
    }
  }
  out_t[i] = best_t;
  out_u[i] = best_u;
  out_v[i] = best_v;
  out_prim[i] = best_p;
  out_occ[i] = occ ? 1 : 0;
}

}  // namespace

extern "C" int dense_v4_trace(const float* tris, int slots, const int* surv,
                              const int* cnt, const float* tnear, int m,
                              const float* org, const float* dir,
                              const float* min_t, const float* max_t,
                              int any_hit, int n, float* out_t, float* out_u,
                              float* out_v, int* out_prim, void* stream) {
  if (n > 0) {
    trace_kernel<<<(n + kBlock - 1) / kBlock, kBlock, 0,
                   static_cast<cudaStream_t>(stream)>>>(
        tris, slots, surv, cnt, tnear, m, org, dir, min_t, max_t, any_hit, n,
        out_t, out_u, out_v, out_prim);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dense_v4_trace_dual(const float* tris, int slots,
                                   const int* surv, const int* cnt,
                                   const float* tnear, int m,
                                   const float* org, const float* dir,
                                   const float* min_t, const float* max_t,
                                   const float* sdir, const float* smin_t,
                                   const float* smax_t, int n, float* out_t,
                                   float* out_u, float* out_v, int* out_prim,
                                   unsigned char* out_occ, void* stream) {
  if (n > 0) {
    trace_dual_kernel<<<(n + kBlock - 1) / kBlock, kBlock, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        tris, slots, surv, cnt, tnear, m, org, dir, min_t, max_t, sdir,
        smin_t, smax_t, n, out_t, out_u, out_v, out_prim, out_occ);
  }
  return static_cast<int>(cudaGetLastError());
}

// Legacy dense triangle trace kernels v1 and v2 for Hopper (sm_90a), plain
// C interface.
//
// Replaces the Pallas TPU kernels of the JAX package's brute-force
// backends:
//   dense_v1_trace <- pbrlab_tpu/ops/pallas/dense.py     _trace_kernel
//   dense_v2_trace <- pbrlab_tpu/ops/pallas/dense_v2.py  _trace_kernel
// Bound with ctypes from pbrlab_tpu_torch/ops/dense.py and dense_v2.py,
// which hold the plain torch versions (_walk_ref) and the host packing
// (dense.pack_triangles). The third legacy kernel, dense_v3, walks per ray
// (csrc/dense_v3.cu).
//
// Inputs: tris [12, Fpad], one column of linear forms per Morton-sorted
// triangle (n, k0 = n.v0, b1, c1 = b1.v0, b2, c2 = b2.v0; padding columns
// are zero), cluster boxes aabb [8, M] (rows 0:3 lo, 3:6 hi) of 128
// triangles each, and the rays as contiguous arrays (org/dir [N, 3],
// min_t/max_t [N], max_t clamped to INF), N a multiple of 128, padded as
// the JAX wrappers pad (org 0, dir 1, min_t 0, max_t -1).
//
// Design: one block of 128 threads, one thread per ray. The TPU's group
// decisions stay group decisions, so the kernels stay bit-equal to their
// plain versions, which keep the TPU's semantics:
// * v1 decides per aligned 8-ray block (its sublanes): a block enters a
//   cluster when any of its 8 rays' slab tests passes against the ray's
//   max t (a ballot over the warp, masked to the 8 lanes);
// * v2 decides per 128-ray group: any lane's slab test against its
//   running best (__syncthreads_or), and with any-hit it stops once every
//   lane has a hit (__syncthreads_and).
// An entered cluster's 128 columns (6 KB) are staged into shared memory,
// and every thread of the block reads them as broadcasts.
//
// Ties: v2 keeps the TPU's 8 per-slot bests (slot = id mod 8, the
// tri-step sublane) in registers, with max_t folded into the initial best
// and a strict t < best, and resolves them at the end as the Pallas body
// does (least t, the lowest slot with a hit). v1's slot is the triangle's
// lane in its cluster (128 of them), so it keeps one best and takes a
// candidate when its t is smaller, or equal with a lower lane: the
// lexicographic minimum of (t, id mod 128, cluster) that the TPU's
// per-lane bests give.
//
// Arithmetic: the Pallas bodies' ray-triangle test on the linear forms, in
// their operand order (dense.py:173-187, dense_v2.py:103-117); the library
// is built with --fmad=false and IEEE division, so the plain torch
// versions give the same bits. prim is int32 here and in the plain
// versions (the TPU carries it as float32, exact below 2^24 faces:
// ROADMAP C9).
//
// What bounds it: f32 operations, 40 per ray-triangle test of every
// cluster the thread's group (v1: 8-ray block) enters, and 27 per ray-box
// test (every cluster, every ray). Every lane pays for the union of the
// clusters its group enters, and a block stages one cluster at a time
// behind a barrier: v2 is the next kernel to walk per ray (ROADMAP B3).

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;  // threads per block = rays per TPU group
constexpr int kTris = 128;   // triangles per cluster
constexpr int kSlots = 8;    // v2 per-slot bests (sublanes)
constexpr int kSteps = kTris / kSlots;
constexpr int kBlockLanes = 8;  // v1's ray block
constexpr float kSlop = 1.00000024f;

// jnp / torch maximum and minimum: NaN in either operand gives NaN
__device__ __forceinline__ float pmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}
__device__ __forceinline__ float pmin(float a, float b) {
  return (a < b || a != a) ? a : b;
}
// the Pallas bodies' inverse direction: a tiny negative becomes +1e-12
__device__ __forceinline__ float inv_dir(float d) {
  return 1.0f / (fabsf(d) < 1e-12f ? 1e-12f : d);
}

struct Ray {
  float ox, oy, oz, dx, dy, dz, mint, maxt, ix, iy, iz;
};

__device__ __forceinline__ Ray load_ray(const float* __restrict__ org,
                                        const float* __restrict__ dir,
                                        const float* __restrict__ min_t,
                                        const float* __restrict__ max_t,
                                        int i) {
  Ray r;
  r.ox = org[3 * i];
  r.oy = org[3 * i + 1];
  r.oz = org[3 * i + 2];
  r.dx = dir[3 * i];
  r.dy = dir[3 * i + 1];
  r.dz = dir[3 * i + 2];
  r.mint = min_t[i];
  r.maxt = max_t[i];
  r.ix = inv_dir(r.dx);
  r.iy = inv_dir(r.dy);
  r.iz = inv_dir(r.dz);
  return r;
}

// slab entry and exit t of the ray into cluster c (dense.py:155-170)
__device__ __forceinline__ void slab(const float* __restrict__ aabb, int m,
                                     int c, const Ray& r, float* tnear,
                                     float* tfar) {
  const float tx0 = (__ldg(aabb + c) - r.ox) * r.ix;
  const float tx1 = (__ldg(aabb + 3 * m + c) - r.ox) * r.ix;
  const float ty0 = (__ldg(aabb + m + c) - r.oy) * r.iy;
  const float ty1 = (__ldg(aabb + 4 * m + c) - r.oy) * r.iy;
  const float tz0 = (__ldg(aabb + 2 * m + c) - r.oz) * r.iz;
  const float tz1 = (__ldg(aabb + 5 * m + c) - r.oz) * r.iz;
  *tnear = pmax(pmax(pmin(tx0, tx1), pmin(ty0, ty1)), pmin(tz0, tz1));
  *tfar = pmin(pmin(pmax(tx0, tx1), pmax(ty0, ty1)), pmax(tz0, tz1));
}

// the block's copy of cluster c: rows[r * 128 + k] = tris[r, c * 128 + k]
__device__ __forceinline__ void stage(const float* __restrict__ tris,
                                      int fpad, int c, float* rows) {
  const float* src = tris + static_cast<size_t>(c) * kTris + threadIdx.x;
#pragma unroll
  for (int r = 0; r < 12; ++r) {
    rows[r * kTris + threadIdx.x] = __ldg(src + static_cast<size_t>(r) * fpad);
  }
}

// one ray-triangle test on the linear forms of column k of the staged
// rows, in the Pallas operand order; returns whether it is a hit up to
// the upper bound on t, which the caller applies
__device__ __forceinline__ bool tri_test(const float* rows, int k,
                                         const Ray& r, float* t, float* u,
                                         float* v) {
  const float nx = rows[0 * kTris + k], ny = rows[1 * kTris + k];
  const float nz = rows[2 * kTris + k], k0 = rows[3 * kTris + k];
  const float b1x = rows[4 * kTris + k], b1y = rows[5 * kTris + k];
  const float b1z = rows[6 * kTris + k], c1 = rows[7 * kTris + k];
  const float b2x = rows[8 * kTris + k], b2y = rows[9 * kTris + k];
  const float b2z = rows[10 * kTris + k], c2 = rows[11 * kTris + k];
  const float den = r.dx * nx + r.dy * ny + r.dz * nz;
  const float num = k0 - (r.ox * nx + r.oy * ny + r.oz * nz);
  *t = num / (fabsf(den) < 1e-12f ? 1e-12f : den);
  *u = ((r.ox * b1x + r.oy * b1y + r.oz * b1z) - c1) +
       *t * (r.dx * b1x + r.dy * b1y + r.dz * b1z);
  *v = ((r.ox * b2x + r.oy * b2y + r.oz * b2z) - c2) +
       *t * (r.dx * b2x + r.dy * b2y + r.dz * b2z);
  return fabsf(den) > 1e-12f && *u >= 0.f && *v >= 0.f && *u + *v <= 1.f &&
         *t >= r.mint;
}

__global__ void __launch_bounds__(kLanes) v1_kernel(
    const float* __restrict__ tris, int fpad, const float* __restrict__ aabb,
    int m, const float* __restrict__ org, const float* __restrict__ dir,
    const float* __restrict__ min_t, const float* __restrict__ max_t,
    float inf, float* __restrict__ out_t, float* __restrict__ out_u,
    float* __restrict__ out_v, int* __restrict__ out_prim) {
  __shared__ float rows[12 * kTris];
  const int i = blockIdx.x * kLanes + threadIdx.x;
  const Ray r = load_ray(org, dir, min_t, max_t, i);
  const int shift = threadIdx.x & 31 & ~(kBlockLanes - 1);
  float best_t = inf, best_u = 0.f, best_v = 0.f;
  int best_p = -1;
  for (int c = 0; c < m; ++c) {
    float tnear, tfar;
    slab(aabb, m, c, r, &tnear, &tfar);
    const bool box_hit =
        tnear <= tfar * kSlop && tfar >= r.mint && tnear <= r.maxt;
    const unsigned ballot = __ballot_sync(0xffffffffu, box_hit);
    const bool enter = ((ballot >> shift) & 0xffu) != 0u;
    if (!__syncthreads_or(enter)) continue;  // block-uniform
    stage(tris, fpad, c, rows);
    __syncthreads();
    if (enter) {
      for (int k = 0; k < kTris; ++k) {
        float t, u, v;
        if (tri_test(rows, k, r, &t, &u, &v) && t <= r.maxt &&
            (t < best_t ||
             (t == best_t && best_p >= 0 && k < (best_p & (kTris - 1))))) {
          best_t = t;
          best_u = u;
          best_v = v;
          best_p = c * kTris + k;
        }
      }
    }
    __syncthreads();  // every thread is done with the rows
  }
  out_t[i] = best_t;
  out_u[i] = best_u;
  out_v[i] = best_v;
  out_prim[i] = best_p;
}

// v2 per-lane state: the TPU's 8 per-slot bests
struct Slots {
  float t[kSlots], u[kSlots], v[kSlots];
  int p[kSlots];

  __device__ __forceinline__ void init(float maxt) {
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      t[s] = maxt;
      u[s] = 0.f;
      v[s] = 0.f;
      p[s] = -1;
    }
  }
  __device__ __forceinline__ float min_t() const {
    float x = t[0];
#pragma unroll
    for (int s = 1; s < kSlots; ++s) x = pmin(x, t[s]);
    return x;
  }
  __device__ __forceinline__ bool found() const {
    bool f = false;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) f |= p[s] >= 0;
    return f;
  }
  // the 16 steps of 8 slots over the staged cluster c
  __device__ __forceinline__ void visit(const float* rows, int c,
                                        const Ray& r) {
    for (int step = 0; step < kSteps; ++step) {
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        const int k = step * kSlots + s;
        float tt, uu, vv;
        if (tri_test(rows, k, r, &tt, &uu, &vv) && tt < t[s]) {
          t[s] = tt;
          u[s] = uu;
          v[s] = vv;
          p[s] = c * kTris + k;
        }
      }
    }
  }
  // the Pallas body's end of a group (dense_v2.py:148-157)
  __device__ __forceinline__ void write(int i, float* out_t, float* out_u,
                                        float* out_v, int* out_prim) const {
    const float tmin = min_t();
    float uu = 0.f, vv = 0.f;
    int pp = -1;
    bool done = false;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      if (!done && t[s] == tmin && p[s] >= 0) {
        uu = u[s];
        vv = v[s];
        pp = p[s];
        done = true;
      }
    }
    out_t[i] = tmin;
    out_u[i] = uu;
    out_v[i] = vv;
    out_prim[i] = pp;
  }
};

__global__ void __launch_bounds__(kLanes) v2_kernel(
    const float* __restrict__ tris, int fpad, const float* __restrict__ aabb,
    int m, const float* __restrict__ org, const float* __restrict__ dir,
    const float* __restrict__ min_t, const float* __restrict__ max_t,
    int any_hit, float* __restrict__ out_t, float* __restrict__ out_u,
    float* __restrict__ out_v, int* __restrict__ out_prim) {
  __shared__ float rows[12 * kTris];
  const int i = blockIdx.x * kLanes + threadIdx.x;
  const Ray r = load_ray(org, dir, min_t, max_t, i);
  Slots best;
  best.init(r.maxt);
  for (int c = 0; c < m; ++c) {
    float tnear, tfar;
    slab(aabb, m, c, r, &tnear, &tfar);
    // the cull against the lane's running best over its slots
    const bool box_hit =
        tnear <= tfar * kSlop && tfar >= r.mint && tnear <= best.min_t();
    // block-uniform: every thread votes, every thread gets the result
    const bool any_box = __syncthreads_or(box_hit);
    const bool all_found = any_hit && __syncthreads_and(best.found());
    if (!any_box || all_found) continue;
    stage(tris, fpad, c, rows);
    __syncthreads();
    best.visit(rows, c, r);
    __syncthreads();  // every thread is done with the rows
  }
  best.write(i, out_t, out_u, out_v, out_prim);
}

}  // namespace

extern "C" int dense_v1_trace(const float* tris, int fpad, const float* aabb,
                              int m, const float* org, const float* dir,
                              const float* min_t, const float* max_t,
                              float inf, int n, float* out_t, float* out_u,
                              float* out_v, int* out_prim, void* stream) {
  if (n > 0) {
    v1_kernel<<<n / kLanes, kLanes, 0, static_cast<cudaStream_t>(stream)>>>(
        tris, fpad, aabb, m, org, dir, min_t, max_t, inf, out_t, out_u, out_v,
        out_prim);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dense_v2_trace(const float* tris, int fpad, const float* aabb,
                              int m, const float* org, const float* dir,
                              const float* min_t, const float* max_t,
                              int any_hit, int n, float* out_t, float* out_u,
                              float* out_v, int* out_prim, void* stream) {
  if (n > 0) {
    v2_kernel<<<n / kLanes, kLanes, 0, static_cast<cudaStream_t>(stream)>>>(
        tris, fpad, aabb, m, org, dir, min_t, max_t, any_hit, out_t, out_u,
        out_v, out_prim);
  }
  return static_cast<int>(cudaGetLastError());
}

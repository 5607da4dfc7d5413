// dense_curve hair trace kernel for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel of pbrlab_tpu/ops/pallas/dense_curve.py:
//   dense_curve_trace  <- _trace_kernel  (wrapper dense_curve_trace)
// Bound with ctypes from pbrlab_tpu_torch/ops/dense_curve.py, which also
// holds the plain torch version (_walk_ref) and the host-side packing.
//
// Inputs: segs [M * 128, 12], one row per linear hair sub-segment in
// Morton order (p0, e = p1 - p0, r0, dr, p0.e, e.e, u0, du; padding rows
// have r0 = dr = 0), the cluster boxes aabb [8, M] (rows 0:3 lo, 3:6 hi),
// and the rays as contiguous arrays (org/dir [N, 3], min_t/max_t [N],
// max_t clamped to INF) with N a multiple of 128.
//
// Design: one block of 128 threads per TPU lane group, one thread per ray.
// The group-wide decisions of the Pallas body become block votes: a group
// enters cluster c when any of its lanes' slab test passes against that
// lane's running best t (jnp.any -> __syncthreads_or), and an any-hit
// group stops entering once every lane has a hit (jnp.all ->
// __syncthreads_and). Inside an entered cluster the block stages the
// cluster's 128 rows (6 KB) into shared memory, and every thread tests all
// 128 of them, reading each row as a broadcast. A per-thread cull would
// test other (ray, segment) pairs: no hit changes in exact arithmetic, but
// a grazing hit can flip in float, so the group vote is kept.
//
// The TPU keeps one running best per sublane slot (segment id mod 8) with
// a strict t < best, and at the end takes the least t, the lowest slot on
// ties (dense_curve.py:205-219): the lexicographic minimum of
// (t, id mod 8), the first visited on a full tie. One best per thread
// gives the same result with the rule below: a candidate wins when its t
// is smaller, or equal with a lower slot. The cull reads the least t over
// the slots, which is that one best. The float ops of the ribbon test are
// the Pallas body's, in its order (:165-192); the library is built with
// --fmad=false and IEEE division and sqrt, so the plain torch walk gives
// the same bits. Its d2 expands |a_perp|^2 and cancels terms of
// ~|p0 - o|^2 down to ~r^2: any rewrite would be another hit set.
//
// What bounds it: f32 operations, 56 per ray and sub-segment of every
// cluster its group enters (the test up to the hit decision; the ribbon
// offset only on a hit), plus one slab test per ray and cluster; the
// rows come from shared memory and the boxes through the read-only cache.
// Known first-cut weakness: every lane of a group pays for the union of
// the clusters its group enters, and a block stages one cluster at a time
// behind a barrier (no double buffering).

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;
constexpr int kSegBlock = 128;
constexpr int kRow = 12;
constexpr int kSlots = 8;
constexpr int kClusterVec4 = kSegBlock * kRow / 4;
constexpr float kSlop = 1.00000024f;

// jnp / torch maximum and minimum: NaN in either operand gives NaN
__device__ __forceinline__ float pmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}
__device__ __forceinline__ float pmin(float a, float b) {
  return (a < b || a != a) ? a : b;
}
// jnp.clip / torch.clamp
__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return pmin(pmax(x, lo), hi);
}
// the Pallas body's inverse direction: a tiny negative becomes +1e-12
__device__ __forceinline__ float inv_dir(float d) {
  return 1.0f / (fabsf(d) < 1e-12f ? 1e-12f : d);
}

__global__ void __launch_bounds__(kLanes) curve_kernel(
    const float* __restrict__ segs, const float* __restrict__ aabb, int m,
    const float* __restrict__ org, const float* __restrict__ dir,
    const float* __restrict__ min_t, const float* __restrict__ max_t,
    int any_hit, float* __restrict__ out_t, float* __restrict__ out_u,
    float* __restrict__ out_v, int* __restrict__ out_sub) {
  __shared__ float4 rows4[kClusterVec4];
  const float* rows = reinterpret_cast<const float*>(rows4);
  const int i = blockIdx.x * kLanes + threadIdx.x;
  const float ox = org[3 * i], oy = org[3 * i + 1], oz = org[3 * i + 2];
  const float dx = dir[3 * i], dy = dir[3 * i + 1], dz = dir[3 * i + 2];
  const float mint = min_t[i];
  const float ix = inv_dir(dx), iy = inv_dir(dy), iz = inv_dir(dz);
  const float od = ox * dx + oy * dy + oz * dz;
  const float oo = ox * ox + oy * oy + oz * oz;
  float best_t = max_t[i], best_u = 0.f, best_v = 0.f;
  int best_p = -1;

  for (int c = 0; c < m; ++c) {
    const float tx0 = (__ldg(aabb + c) - ox) * ix;
    const float tx1 = (__ldg(aabb + 3 * m + c) - ox) * ix;
    const float ty0 = (__ldg(aabb + m + c) - oy) * iy;
    const float ty1 = (__ldg(aabb + 4 * m + c) - oy) * iy;
    const float tz0 = (__ldg(aabb + 2 * m + c) - oz) * iz;
    const float tz1 = (__ldg(aabb + 5 * m + c) - oz) * iz;
    const float tnear =
        pmax(pmax(pmin(tx0, tx1), pmin(ty0, ty1)), pmin(tz0, tz1));
    const float tfar =
        pmin(pmin(pmax(tx0, tx1), pmax(ty0, ty1)), pmax(tz0, tz1));
    // the cull against the lane's least t over the slots: its one best
    const bool box_hit =
        tnear <= tfar * kSlop && tfar >= mint && tnear <= best_t;
    // block-uniform: every thread votes, every thread gets the result
    const bool any_box = __syncthreads_or(box_hit);
    const bool all_found = any_hit && __syncthreads_and(best_p >= 0);
    if (!any_box || all_found) continue;

    const float4* src =
        reinterpret_cast<const float4*>(segs) +
        static_cast<size_t>(c) * kClusterVec4;
    for (int k = threadIdx.x; k < kClusterVec4; k += kLanes) {
      rows4[k] = __ldg(src + k);
    }
    __syncthreads();
    for (int k = 0; k < kSegBlock; ++k) {
      const float* r = rows + k * kRow;
      const float p0x = r[0], p0y = r[1], p0z = r[2];
      const float ex = r[3], ey = r[4], ez = r[5];
      const float r0 = r[6], dr = r[7], p0e = r[8], ee = r[9];
      const float ad = (p0x * dx + p0y * dy + p0z * dz) - od;
      const float ed = ex * dx + ey * dy + ez * dz;
      const float ae = p0e - (ex * ox + ey * oy + ez * oz);
      const float aa = ((p0x * p0x + p0y * p0y + p0z * p0z) -
                        2.0f * (p0x * ox + p0y * oy + p0z * oz)) +
                       oo;
      const float ep2 = pmax(ee - ed * ed, 1e-12f);
      const float q = ae - ad * ed;
      const float s = clip(-q / ep2, 0.f, 1.f);
      const float d2 = (aa - ad * ad) + 2.0f * s * q + s * s * ep2;
      const float t = ad + s * ed;
      const float rad = r0 + s * dr;
      const int slot = k & (kSlots - 1);  // == id mod 8: clusters are 128
      if (d2 <= rad * rad && t >= mint && rad > 0.f &&
          (t < best_t ||
           (t == best_t && best_p >= 0 && slot < (best_p & (kSlots - 1))))) {
        // signed ribbon offset: the triple product -det[p0 - o, d, e]
        const float cx = dy * ez - dz * ey;
        const float cy = dz * ex - dx * ez;
        const float cz = dx * ey - dy * ex;
        const float det = (p0x - ox) * cx + (p0y - oy) * cy + (p0z - oz) * cz;
        const float blen = sqrtf(pmax(cx * cx + cy * cy + cz * cz, 1e-20f));
        best_v = clip(-det / (blen * pmax(rad, 1e-12f)), -1.f, 1.f);
        best_u = r[10] + s * r[11];
        best_p = c * kSegBlock + k;
        best_t = t;
      }
    }
    __syncthreads();  // every thread is done with the rows
  }
  out_t[i] = best_t;
  out_u[i] = best_u;
  out_v[i] = best_v;
  out_sub[i] = best_p;
}

}  // namespace

extern "C" int dense_curve_trace(const float* segs, const float* aabb, int m,
                                 const float* org, const float* dir,
                                 const float* min_t, const float* max_t,
                                 int any_hit, int n, float* out_t,
                                 float* out_u, float* out_v, int* out_sub,
                                 void* stream) {
  if (n > 0) {
    curve_kernel<<<n / kLanes, kLanes, 0, static_cast<cudaStream_t>(stream)>>>(
        segs, aabb, m, org, dir, min_t, max_t, any_hit, out_t, out_u, out_v,
        out_sub);
  }
  return static_cast<int>(cudaGetLastError());
}

// dense_curve hair trace kernel for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel of pbrlab_tpu/ops/pallas/dense_curve.py:
//   dense_curve_trace  <- _trace_kernel  (wrapper dense_curve_trace)
// Bound with ctypes from pbrlab_tpu_torch/ops/dense_curve.py, which also
// holds the plain torch twin (_walk_ref) and the host-side packing.
//
// Inputs: segs [M * 128, 12], one row per linear hair sub-segment in
// Morton order (p0, e = p1 - p0, r0, dr, p0.e, e.e, u0, du; padding rows
// have r0 = dr = 0), the cluster boxes aabb [8, M] (rows 0:3 lo, 3:6 hi),
// and the rays as contiguous arrays (org/dir [N, 3], min_t/max_t [N],
// max_t clamped to INF), any N.
//
// Design (per_ray.cuh `cluster_walk`): one thread a ray, 128 threads a
// block, no vote, no barrier and no shared memory. The thread walks the
// clusters in chunks of 256 in cluster (Morton) order: it slab-tests its
// ray against the chunk's boxes (per_ray::slab_diff, the Pallas body's
// `(box - o) * inv` arithmetic and x 1.00000024 slop) capped at its own
// best t, keeps the clusters it enters in a local-memory list ordered by
// entry t, and walks them front to back until its best t lies before the
// next entry; then the next chunk. Any-hit ends the lane's walk after the
// first cluster that gives it a hit. A cluster's 128 rows are read as
// three 16-byte __ldg loads each (48 B a row; the wrapper checks the
// alignment), four rows at a time, whose tests are independent: a lane
// that walks many clusters is bound by its chain of dependent operations,
// and four chains in flight hide their latency. The TPU walks 128-ray
// groups instead: a group enters a cluster when any lane's box test
// passes, and every lane tests all 128 ribbons of every cluster its group
// enters (the demo tuft's groups enter 41.6 of 42).
//
// The TPU keeps one running best per sublane slot (segment id mod 8) with
// a strict t < best, and at the end takes the least t, the lowest slot on
// ties (dense_curve.py:205-219): the lexicographic minimum of
// (t, id mod 8), the first visited on a full tie. The thread keeps one
// best with per_ray::beats, which gives that minimum. The float ops of
// the ribbon test are the Pallas body's, in its order (:165-192); the
// library is built with --fmad=false and IEEE division and sqrt, so the
// plain torch twin, which visits each lane's clusters in the same order,
// gives the same bits. Its d2 expands |a_perp|^2 and cancels terms of
// ~|p0 - o|^2 down to ~r^2: any rewrite would be another hit set.
//
// What bounds it: f32 operations, 56 per ray and sub-segment of every
// cluster the lane walks (the test up to the hit decision; the ribbon
// offset only on a hit), plus 27 per ray and cluster box: on a scene of
// thousands of clusters the M box tests of every live lane set the pace.

#include "per_ray.cuh"

namespace {

constexpr int kThreads = 128;  // threads a block, one ray each
constexpr int kSegs = 128;     // sub-segments a cluster
constexpr int kStep = 4;       // ribbons tested together

struct Params {
  const float4* segs;  // 3 float4 a row
  const float* aabb;
  int m;
  const float* org;
  const float* dir;
  const float* min_t;
  const float* max_t;
  int n;
  float* out_t;
  float* out_u;
  float* out_v;
  int* out_sub;
};

struct Ray {
  float ox, oy, oz, dx, dy, dz, mint, od, oo;
};

// jnp.clip / torch.clamp
__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return per_ray::pmin(per_ray::pmax(x, lo), hi);
}

// the 128 ribbons of cluster c, in order (the Pallas body's operations):
// four at a time, their loads and tests independent of each other (the
// lane's latency, not the card's rate, sets a long walk's time), then the
// four candidates taken in order with per_ray::beats
__device__ __forceinline__ void ribbons(const float4* __restrict__ segs,
                                        int c, const Ray& r,
                                        per_ray::Hit& h) {
  const float4* rows = segs + static_cast<size_t>(c) * kSegs * 3;
#pragma unroll 1
  for (int k = 0; k < kSegs; k += kStep) {
    float4 a[kStep], b[kStep], e[kStep];
#pragma unroll
    for (int j = 0; j < kStep; ++j) {
      a[j] = __ldg(rows + 3 * (k + j));
      b[j] = __ldg(rows + 3 * (k + j) + 1);
      e[j] = __ldg(rows + 3 * (k + j) + 2);
    }
    float t[kStep], s[kStep], rad[kStep];
    bool ok[kStep];
#pragma unroll
    for (int j = 0; j < kStep; ++j) {
      const float p0x = a[j].x, p0y = a[j].y, p0z = a[j].z;
      const float ex = a[j].w, ey = b[j].x, ez = b[j].y;
      const float r0 = b[j].z, dr = b[j].w, p0e = e[j].x, ee = e[j].y;
      const float ad = (p0x * r.dx + p0y * r.dy + p0z * r.dz) - r.od;
      const float ed = ex * r.dx + ey * r.dy + ez * r.dz;
      const float ae = p0e - (ex * r.ox + ey * r.oy + ez * r.oz);
      const float aa = ((p0x * p0x + p0y * p0y + p0z * p0z) -
                        2.0f * (p0x * r.ox + p0y * r.oy + p0z * r.oz)) +
                       r.oo;
      const float ep2 = per_ray::pmax(ee - ed * ed, 1e-12f);
      const float q = ae - ad * ed;
      s[j] = clip(-q / ep2, 0.f, 1.f);
      const float d2 = (aa - ad * ad) + 2.0f * s[j] * q + s[j] * s[j] * ep2;
      t[j] = ad + s[j] * ed;
      rad[j] = r0 + s[j] * dr;
      ok[j] = d2 <= rad[j] * rad[j] && t[j] >= r.mint && rad[j] > 0.f;
    }
#pragma unroll
    for (int j = 0; j < kStep; ++j) {
      const int id = c * kSegs + k + j;
      if (ok[j] && per_ray::beats(t[j], id, h)) {
        const float p0x = a[j].x, p0y = a[j].y, p0z = a[j].z;
        const float ex = a[j].w, ey = b[j].x, ez = b[j].y;
        // signed ribbon offset: the triple product -det[p0 - o, d, e]
        const float cx = r.dy * ez - r.dz * ey;
        const float cy = r.dz * ex - r.dx * ez;
        const float cz = r.dx * ey - r.dy * ex;
        const float det =
            (p0x - r.ox) * cx + (p0y - r.oy) * cy + (p0z - r.oz) * cz;
        const float blen =
            sqrtf(per_ray::pmax(cx * cx + cy * cy + cz * cz, 1e-20f));
        h.v = clip(-det / (blen * per_ray::pmax(rad[j], 1e-12f)), -1.f,
                   1.f);
        h.u = e[j].z + s[j] * e[j].w;
        h.prim = id;
        h.t = t[j];
      }
    }
  }
}

template <bool kAnyHit>
__global__ void __launch_bounds__(kThreads) curve_kernel(const Params p) {
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
  r.od = r.ox * r.dx + r.oy * r.dy + r.oz * r.dz;
  r.oo = r.ox * r.ox + r.oy * r.oy + r.oz * r.oz;
  const per_ray::DiffRay box_ray =
      per_ray::diff_ray(r.ox, r.oy, r.oz, r.dx, r.dy, r.dz);
  int2 lst[per_ray::kList];
  per_ray::Hit h = {p.max_t[i], 0.f, 0.f, -1};
  per_ray::cluster_walk<kAnyHit>(
      p.m, r.mint,
      [&](int c, float cap) {
        return per_ray::slab_diff(p.aabb, p.m, c, box_ray, r.mint, cap);
      },
      [&](int c, per_ray::Hit& hit) { ribbons(p.segs, c, r, hit); }, h,
      lst);
  p.out_t[i] = h.t;
  p.out_u[i] = h.u;
  p.out_v[i] = h.v;
  p.out_sub[i] = h.prim;
}

}  // namespace

// closest (any_hit 0) or any hit of n rays over m clusters
extern "C" int dense_curve_trace(const float* segs, const float* aabb, int m,
                                 const float* org, const float* dir,
                                 const float* min_t, const float* max_t,
                                 int any_hit, int n, float* out_t,
                                 float* out_u, float* out_v, int* out_sub,
                                 void* stream) {
  const Params p = {reinterpret_cast<const float4*>(segs),
                    aabb,
                    m,
                    org,
                    dir,
                    min_t,
                    max_t,
                    n,
                    out_t,
                    out_u,
                    out_v,
                    out_sub};
  void (*kernel)(Params) =
      any_hit ? curve_kernel<true> : curve_kernel<false>;
  if (n > 0) {
    kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
             static_cast<cudaStream_t>(stream)>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

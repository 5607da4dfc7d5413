// The no-grad wavefront step's two kernels for Hopper (sm_90a), plain C
// interface, around the step's trace launch:
//   step_pre    the four pre-trace draws, the volume lanes' new direction
//               and scatter distance, the rays' min and max t, and on a
//               resolving step the pending shadow queries' rays;
//   step_shade  from the hit to the new packed state: emission MIS and
//               roulette, the volume walk step, the principled closure
//               (or the diffuse exit), the deferred NEE and the closure
//               sample, SSS entry and the state merge.
// Bound with ctypes from pbrlab_tpu_torch/ops/step.py; their plain twin
// is the torch chain of render/integrator.py `wavefront_step`, to the bit
// (step.cuh says how).
//
// Inputs: the packed state rows [N, 39] (render/integrator.py
// `pack_state`), read with a row stride `ld` >= 39 so a caller's wider
// rows step in place of a copy; the hit of the trace (t, u, v [N] float,
// prim [N] int32, occluded [N] bytes on a resolving step); the scene's
// face_fat [F, 26], mat_fat [M, K] and light_fat [L, 16] rows and the
// light CDF [L]. Outputs: step_pre's ray arrays, step_shade's new rows
// [N, 39], contiguous.
//
// Design: one thread a lane, 128 threads a block; a lane reads its row
// into registers, computes with no shared state, and writes its outputs.
// step_shade recomputes step_pre's part of the lane (the same bits) in
// place of reading it back. The torch chain launches ~3,600 kernels a
// step, each a pass over every lane; here each lane's work runs in one
// thread, so a step costs two launches and one pass over the rows and the
// fat tables it gathers.

#include <cuda_runtime.h>

#include "step.cuh"

namespace {

constexpr int kThreads = 128;  // threads a block, one lane each

struct PreParams {
  const float* rows;
  int ld, n, freeze, resolving;
  float* org;  // [N, 3]
  float* dir;  // [N, 3]
  float* min_t;
  float* max_t;
  float* sdir;  // resolving: the shadow rays (direction, min t, max t)
  float* smin;
  float* smax;
};

struct ShadeParams {
  const float* rows;
  int ld, n, freeze, resolving;
  const float* t;
  const float* u;
  const float* v;
  const int* prim;
  const unsigned char* occ;  // resolving
  step::Scene scene;
  float* out;  // [N, 39]
};

__device__ __forceinline__ void load_row(const float* rows, int ld, int i,
                                         float* r) {
  const float* src = rows + static_cast<int64_t>(i) * ld;
#pragma unroll
  for (int k = 0; k < step::kCols; ++k) r[k] = src[k];
}

__global__ void __launch_bounds__(kThreads) pre_kernel(const PreParams p) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= p.n) return;
  float r[step::kCols];
  load_row(p.rows, p.ld, i, r);
  const step::Pre pre = step::pre_lane(r, p.freeze != 0);
#pragma unroll
  for (int k = 0; k < 3; ++k) p.org[3 * i + k] = r[k];
  p.dir[3 * i] = pre.dir.x;
  p.dir[3 * i + 1] = pre.dir.y;
  p.dir[3 * i + 2] = pre.dir.z;
  p.min_t[i] = pre.min_t;
  p.max_t[i] = pre.max_t;
  if (p.resolving) {
#pragma unroll
    for (int k = 0; k < 3; ++k) p.sdir[3 * i + k] = r[32 + k];
    p.smin[i] = static_cast<float>(1e-3);  // EPS
    p.smax[i] = step::resolve_mask(r, pre, p.freeze != 0) ? r[38] : -1.0f;
  }
}

__global__ void __launch_bounds__(kThreads) shade_kernel(const ShadeParams p) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= p.n) return;
  float r[step::kCols];
  load_row(p.rows, p.ld, i, r);
  const step::Pre pre = step::pre_lane(r, p.freeze != 0);
  float o[step::kCols];
  step::shade_lane(p.scene, r, pre, p.freeze != 0, p.resolving != 0, p.t[i],
                   p.u[i], p.v[i], p.prim[i],
                   p.resolving ? p.occ[i] != 0 : false, o);
  float* dst = p.out + static_cast<int64_t>(i) * step::kCols;
#pragma unroll
  for (int k = 0; k < step::kCols; ++k) dst[k] = o[k];
}

int launched() { return static_cast<int>(cudaGetLastError()); }

}  // namespace

extern "C" int step_pre(const float* rows, int ld, int n, int freeze,
                        int resolving, float* org, float* dir, float* min_t,
                        float* max_t, float* sdir, float* smin, float* smax,
                        void* stream) {
  if (ld < step::kCols) return cudaErrorInvalidValue;
  const PreParams p = {rows, ld, n, freeze, resolving, org, dir, min_t,
                       max_t, sdir, smin, smax};
  if (n > 0) {
    pre_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(p);
  }
  return launched();
}

extern "C" int step_shade(const float* rows, int ld, int n, int freeze,
                          int resolving, const float* t, const float* u,
                          const float* v, const int* prim,
                          const unsigned char* occ, const float* face_fat,
                          int faces, const float* mat_fat, int mat_cols,
                          int mats, const float* light_fat,
                          const float* light_cdf, int lights, float* out,
                          void* stream) {
  if (ld < step::kCols || mats < 1 || faces < 1) return cudaErrorInvalidValue;
  ShadeParams p = {rows, ld, n, freeze, resolving, t, u, v, prim, occ};
  p.scene.face_fat = face_fat;
  p.scene.faces = faces;
  p.scene.mat_fat = mat_fat;
  p.scene.mat_cols = mat_cols;
  p.scene.mats = mats;
  p.scene.light_fat = light_fat;
  p.scene.light_cdf = light_cdf;
  p.scene.lights = lights;
  p.out = out;
  if (n > 0) {
    shade_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(p);
  }
  return launched();
}

// The wavefront step's per-lane code (pbrlab_tpu_torch/csrc/step.cuh)
// compiled for the host, as loops over the lanes with the arguments of
// csrc/step.cu's kernels: tests/test_torch_step_kernels.py checks its
// logic against the torch chain on the CPU.
#include "step.cuh"

extern "C" void host_pre(const float* rows, int ld, int n, int freeze,
                         int resolving, float* org, float* dir, float* min_t,
                         float* max_t, float* sdir, float* smin, float* smax) {
  for (int i = 0; i < n; ++i) {
    const float* r = rows + static_cast<long>(i) * ld;
    const step::Pre p = step::pre_lane(r, freeze != 0);
    for (int k = 0; k < 3; ++k) org[3 * i + k] = r[k];
    dir[3 * i] = p.dir.x;
    dir[3 * i + 1] = p.dir.y;
    dir[3 * i + 2] = p.dir.z;
    min_t[i] = p.min_t;
    max_t[i] = p.max_t;
    if (resolving) {
      for (int k = 0; k < 3; ++k) sdir[3 * i + k] = r[32 + k];
      smin[i] = static_cast<float>(1e-3);
      smax[i] = step::resolve_mask(r, p, freeze != 0) ? r[38] : -1.0f;
    }
  }
}

extern "C" void host_shade(const float* rows, int ld, int n, int freeze,
                           int resolving, const float* t, const float* u,
                           const float* v, const int* prim,
                           const unsigned char* occ, const float* face_fat,
                           int faces, const float* mat_fat, int mat_cols,
                           int mats, const float* light_fat,
                           const float* light_cdf, int lights, float* out) {
  const step::Scene sc = {face_fat, faces,     mat_fat,  mat_cols,
                          mats,     light_fat, light_cdf, lights};
  for (int i = 0; i < n; ++i) {
    const float* r = rows + static_cast<long>(i) * ld;
    const step::Pre p = step::pre_lane(r, freeze != 0);
    step::shade_lane(sc, r, p, freeze != 0, resolving != 0, t[i], u[i], v[i],
                     prim[i], resolving ? occ[i] != 0 : false,
                     out + static_cast<long>(i) * step::kCols);
  }
}

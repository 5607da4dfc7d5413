// One wavefront step of one lane, before and after its trace: the device
// functions of csrc/step.cu, the kernels of the no-grad step of
// render/integrator.py `wavefront_step` on a baked, untextured, hair-free
// scene. Every function here is the plain torch chain it names, operation
// for operation, in the order and the rounding the chain's CUDA kernels
// give on the card (built with --fmad=false, no fast math):
//
// * a Python number meets a float32 tensor as a float (`F(x)` below: the
//   double constant rounded once, as torch rounds its scalar); `a / x` of
//   a tensor over a number is never written in the chain, and `x / t`
//   (`Tensor.__rtruediv__`) is torch's reciprocal times x;
// * `sum(-1)` over 3 values (`vdot`, `mean`, the norms) is the reduction
//   kernel's order, two threads, the first holding entries 0 and 2, then
//   a warp shuffle: (x0 + x2) + x1 from a zero start, so -0 comes out +0;
// * `torch.clamp` keeps a NaN, `torch.maximum` / `minimum` propagate one,
//   and `amax` is their reduction;
// * `torch.where` of a value that a lane does not take is not computed:
//   the value it takes has the same bits either way.
//
// The functions also compile as plain C++ (no __CUDACC__), so the same
// code runs on a host for a check of its logic.
#pragma once

#include <math.h>
#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#define STEP_FN __host__ __device__ __forceinline__
#else
#define STEP_FN inline
#endif

namespace step {

// the packed state's columns (render/integrator.py `pack_state`)
constexpr int kCols = 39;
// the fat rows' widths and the material columns (scene/scene.py
// `build_fat_tables`, scene/materials.py `fat_layout`); ops/step.py checks
// them against the Python layout
constexpr int kFaceCols = 26;
constexpr int kLightCols = 16;
enum MatCol {
  kBaseColor = 3, kSubsurface = 6, kSubsurfaceRadius = 7,
  kSubsurfaceColor = 10, kMetallic = 13, kSpecular = 14, kSpecularTint = 15,
  kRoughness = 16, kAnisotropic = 17, kClearcoat = 21,
  kClearcoatRoughness = 22, kTransmission = 24,
};

#define F(x) static_cast<float>(x)
constexpr double kPi = 3.141592653589793;
constexpr int kFront = 0, kBack = 1, kAmbiguous = 2;

struct F3 {
  float x, y, z;
};

STEP_FN F3 mk(float x, float y, float z) {
  F3 r;
  r.x = x;
  r.y = y;
  r.z = z;
  return r;
}
STEP_FN F3 ld3(const float* p) { return mk(p[0], p[1], p[2]); }
STEP_FN F3 add(F3 a, F3 b) { return mk(a.x + b.x, a.y + b.y, a.z + b.z); }
STEP_FN F3 sub(F3 a, F3 b) { return mk(a.x - b.x, a.y - b.y, a.z - b.z); }
STEP_FN F3 mul(F3 a, F3 b) { return mk(a.x * b.x, a.y * b.y, a.z * b.z); }
STEP_FN F3 scale(F3 a, float s) { return mk(a.x * s, a.y * s, a.z * s); }
STEP_FN F3 neg(F3 a) { return mk(-a.x, -a.y, -a.z); }
STEP_FN F3 zero3() { return mk(0.0f, 0.0f, 0.0f); }

STEP_FN uint32_t bits(float f) {
#ifdef __CUDA_ARCH__
  return __float_as_uint(f);
#else
  uint32_t u;
  memcpy(&u, &f, 4);
  return u;
#endif
}
STEP_FN float from_bits(uint32_t u) {
#ifdef __CUDA_ARCH__
  return __uint_as_float(u);
#else
  float f;
  memcpy(&f, &u, 4);
  return f;
#endif
}

// torch.clamp(x, min=lo), clamp(x, max=hi), clamp(x, 0, 1)
STEP_FN float clamp_lo(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}
STEP_FN float clamp_hi(float v, float hi) {
  return isnan(v) ? v : fminf(v, hi);
}
STEP_FN float saturate(float v) {
  return isnan(v) ? v : fminf(fmaxf(v, 0.0f), 1.0f);
}
// torch.maximum / torch.minimum
STEP_FN float tmax(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
STEP_FN float tmin(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}
// x.sum(-1) over 3 entries, the CUDA reduction's order
STEP_FN float sum3(float a, float b, float c) { return ((a + c) + b) + 0.0f; }
STEP_FN float vdot(F3 a, F3 b) { return sum3(a.x * b.x, a.y * b.y, a.z * b.z); }
// x.amax(-1): NaN wins
STEP_FN float amax3(F3 a) {
  float m = a.x;
  m = (m != m || m > a.z) ? m : a.z;
  return (m != m || m > a.y) ? m : a.y;
}
STEP_FN bool finite3(F3 a) {
  return isfinite(a.x) && isfinite(a.y) && isfinite(a.z);
}

// core/math.py
STEP_FN F3 vnormalize(F3 a) {
  const float inv = 1.0f / sqrtf(clamp_lo(vdot(a, a), F(1e-20)));
  return scale(a, inv);
}
STEP_FN float rgb_to_y(F3 c) {
  return (c.x * F(0.212671) + c.y * F(0.715160)) + c.z * F(0.072169);
}
STEP_FN float safe_div(float a, float b) {  // safe_divide_spectrum
  const bool small = fabsf(b) < F(1.1920929e-07);
  const float q = a / (small ? 1.0f : b);
  return small ? 0.0f : q;
}
STEP_FN float fresnel_dielectric_cos(float cos_i, float eta) {
  const float eta_eff = cos_i < 0.0f ? 1.0f / (eta == 0.0f ? 1.0f : eta) : eta;
  const float c = fabsf(cos_i);
  const float g2 = (eta_eff * eta_eff - 1.0f) + c * c;
  const float g = sqrtf(clamp_lo(g2, F(1e-20)));
  const float a = (g - c) / (g + c);
  const float b = (c * (g + c) - 1.0f) / (c * (g - c) + 1.0f);
  float refl = ((a * 0.5f) * a) * (b * b + 1.0f);
  refl = g2 > 0.0f ? refl : 1.0f;
  return fabsf(eta) < F(1.1920929e-07) ? 1.0f : refl;
}

// core/rng.py: PCG draws on the uint32 state
STEP_FN uint32_t pcg_out(uint32_t s) {
  const uint32_t w = ((s >> ((s >> 28) + 4u)) ^ s) * 277803737u;
  return (w >> 22) ^ w;
}
STEP_FN float draw(uint32_t& s) {
  s = s * 747796405u + 2891336453u;
  return from_bits((pcg_out(s) >> 9) | 0x3F800000u) - 1.0f;
}

// core/sampling.py, core/onb.py
STEP_FN F3 cosine_sample_hemisphere(float u1, float u2) {
  const float phi = u1 * F(2.0 * kPi);
  const float r = sqrtf(u2);
  const float z = sqrtf(clamp_lo(1.0f - u2, 0.0f));
  return mk(cosf(phi) * r, sinf(phi) * r, z);
}
STEP_FN F3 uniform_sample_sphere(float u1, float u2) {
  const float y = u2 * 2.0f - 1.0f;
  const float norm = sqrtf(clamp_lo(1.0f - y * y, 0.0f));
  const float theta = u1 * F(2.0 * kPi);
  return mk(norm * cosf(theta), y, norm * sinf(theta));
}
STEP_FN float power_heuristic_weight(float s, float o) {
  float big = tmax(s, o);
  big = big > 0.0f ? big : 1.0f;
  const float r_gt = o / big;
  const float r_lt = s / big;
  const float mis_gt = 1.0f / (r_gt * r_gt + 1.0f);
  const float mis_lt = 1.0f - 1.0f / (r_lt * r_lt + 1.0f);
  return s > o ? mis_gt : (s < o ? mis_lt : 0.5f);
}
STEP_FN void branchless_onb(F3 n, F3& ex, F3& ey) {
  const float sign = n.z >= 0.0f ? 1.0f : -1.0f;
  const float a = (1.0f / (sign + n.z)) * -1.0f;
  const float b = (n.x * n.y) * a;
  ex = mk(((sign * n.x) * n.x) * a + 1.0f, sign * b, -sign * n.x);
  ey = mk(b, sign + (n.y * n.y) * a, -n.y);
}
STEP_FN F3 to_local(F3 v, F3 ex, F3 ey, F3 ez) {
  return mk(vdot(v, ex), vdot(v, ey), vdot(v, ez));
}
STEP_FN F3 to_global(F3 v, F3 ex, F3 ey, F3 ez) {
  return add(add(scale(ex, v.x), scale(ey, v.y)), scale(ez, v.z));
}

// shading/sss.py
STEP_FN float sample_scatter_distance(F3 tp, F3 sigma_s, F3 sigma_t, float u0,
                                      float u1, F3& pdf) {
  const F3 albedo = mk(safe_div(sigma_s.x, sigma_t.x),
                       safe_div(sigma_s.y, sigma_t.y),
                       safe_div(sigma_s.z, sigma_t.z));
  const F3 w = mk(fabsf(tp.x * albedo.x), fabsf(tp.y * albedo.y),
                  fabsf(tp.z * albedo.z));
  const float total = sum3(w.x, w.y, w.z);
  const float den = total > 0.0f ? total : 1.0f;
  pdf = total > 0.0f ? mk(w.x / den, w.y / den, w.z / den)
                     : mk(F(1.0 / 3.0), F(1.0 / 3.0), F(1.0 / 3.0));
  const float cdf1 = pdf.x + pdf.y;
  const float sig =
      u0 < pdf.x ? sigma_t.x : (u0 < cdf1 ? sigma_t.y : sigma_t.z);
  return -logf(clamp_lo(1.0f - u1, F(1e-12))) / clamp_lo(sig, F(1e-12));
}
// scattering_coefficients, one channel
STEP_FN void scattering(float weight, float a, float radius, float& sigma_t,
                        float& sigma_s, float& tp0) {
  const float alpha =
      1.0f - expf(a * (a * (F(2.61188) - a * F(4.31805)) + F(-5.09406)));
  const float d = a - F(0.8);
  const float s = (F(1.9) - a) + (d * d) * F(3.5);
  sigma_t = 1.0f / clamp_lo(radius * s, F(1e-16));
  sigma_s = sigma_t * alpha;
  tp0 = safe_div(weight, a);
}

// shading/ggx.py
STEP_FN float d_gtr1(F3 h, float alpha) {
  const float alpha2 = alpha * alpha;
  const float t = ((alpha2 - 1.0f) * h.z) * h.z + 1.0f;
  const float val = (alpha2 - 1.0f) /
                    ((logf(clamp_lo(alpha2, F(1e-12))) * F(kPi)) * t);
  return alpha >= 1.0f ? F(1.0 / kPi) : val;
}
STEP_FN float d_gtr2(F3 h, float alpha2) {
  const float c2 = h.z * h.z;
  const float c4 = c2 * c2;
  const float tan2 = (1.0f - c2) / clamp_lo(c2, F(1e-12));
  return alpha2 / clamp_lo(((c4 * F(kPi)) * (alpha2 + tan2)) * (alpha2 + tan2),
                           F(1e-12));
}
STEP_FN float g1_of(float alpha2, float cos2) {  // the isotropic Smith G1
  return (1.0f / (sqrtf(clamp_lo((alpha2 * (1.0f - cos2)) /
                                          clamp_lo(cos2, F(1e-12)) + 1.0f,
                                      0.0f)) + 1.0f)) * 2.0f;
}
STEP_FN float aniso_g1(F3 omega, float cos_n, float ax, float ay) {
  const float tan2 = (1.0f - cos_n * cos_n) / clamp_lo(cos_n * cos_n, F(1e-12));
  const float cph = omega.x, sph = omega.y;
  const float denom = clamp_lo(cph * cph + sph * sph, F(1e-12));
  const float a2 = ((cph * cph) * (ax * ax) + (sph * sph) * (ay * ay)) / denom;
  return (1.0f / (sqrtf(clamp_lo(a2 * tan2 + 1.0f, 0.0f)) + 1.0f)) * 2.0f;
}
// eval_pdf: distrib 1 = GTR1 clearcoat, 2 = GTR2
STEP_FN void ggx_eval(F3 wi, F3 wo, float ax, float ay, int distrib, float& f,
                      float& pdf) {
  const float cos_no = wo.z, cos_ni = wi.z;
  const bool reflect = cos_no > 0.0f && cos_ni > 0.0f;
  const F3 m = vnormalize(add(wi, wo));
  const float alpha2 = ax * ay;
  const bool iso = fabsf(ax - ay) < F(1.1920929e-07);
  float d, g1o, g1i;
  if (iso) {
    const float alpha2_g = distrib == 1 ? 0.0625f : alpha2;
    d = distrib == 1 ? d_gtr1(m, ax) : d_gtr2(m, alpha2);
    g1o = g1_of(alpha2_g, cos_no * cos_no);
    g1i = g1_of(alpha2_g, cos_ni * cos_ni);
  } else {
    const float mz = fabsf(m.z) < F(1e-12) ? F(1e-12) : m.z;
    const float sx = -m.x / (mz * clamp_lo(ax, F(1e-12)));
    const float sy = -m.y / (mz * clamp_lo(ay, F(1e-12)));
    const float len = (sx * sx + 1.0f) + sy * sy;
    const float cm2 = m.z * m.z;
    const float cm4 = cm2 * cm2;
    d = 1.0f / clamp_lo((((len * len) * F(kPi)) * (ax * ay)) * cm4, F(1e-12));
    g1o = aniso_g1(wo, cos_no, ax, ay);
    g1i = aniso_g1(wi, cos_ni, ax, ay);
  }
  const float common = (d * 0.25f) / clamp_lo(cos_no * cos_ni, F(1e-12));
  float fv = (g1o * g1i) * common;
  if (distrib == 1) fv = fv * 0.25f;
  f = reflect ? fv : 0.0f;
  pdf = reflect ? g1o * common : 0.0f;
}
STEP_FN void sample_slopes(float cos_t, float sin_t, float randu, float randv,
                           float& slope_x, float& slope_y) {
  if (cos_t >= F(0.99999)) {  // normal incidence
    const float r = sqrtf(randu / clamp_lo(1.0f - randu, F(1e-12)));
    const float phi = randv * F(2.0 * kPi);
    slope_x = r * cosf(phi);
    slope_y = r * sinf(phi);
    return;
  }
  const float tan_t = sin_t / clamp_lo(cos_t, F(1e-12));
  const float g1_inv =
      (sqrtf(clamp_lo(tan_t * tan_t + 1.0f, 0.0f)) + 1.0f) * 0.5f;
  const float a = ((randu * 2.0f) * g1_inv) - 1.0f;
  const float aa = a * a;
  const float tmp = 1.0f / (fabsf(aa - 1.0f) < F(1e-12) ? F(1e-12) : aa - 1.0f);
  const float b = tan_t;
  const float bb = b * b;
  const float d = sqrtf(clamp_lo(bb * (tmp * tmp) - (aa - bb) * tmp, F(1e-24)));
  const float x1 = b * tmp - d;
  const float x2 = b * tmp + d;
  slope_x = (a < 0.0f || x2 * tan_t > 1.0f) ? x1 : x2;
  const bool hi = randv > 0.5f;
  const float s = hi ? 1.0f : -1.0f;
  const float rv = hi ? (randv - 0.5f) * 2.0f : (0.5f - randv) * 2.0f;
  const float z = (rv * (rv * (rv * F(0.27385) - F(0.73369)) + F(0.46341))) /
                  (rv * (rv * (rv * F(0.093073) + F(0.309420)) - 1.0f) +
                   F(0.597999));
  slope_y = (s * z) * sqrtf(clamp_lo(slope_x * slope_x + 1.0f, 0.0f));
}
STEP_FN F3 sample_stretched(F3 wo, float ax, float ay, float randu,
                            float randv) {
  const F3 wi = vnormalize(mk(ax * wo.x, ay * wo.y, wo.z));
  const bool not_normal = wi.z < F(0.99999);
  const float cos_t = not_normal ? wi.z : 1.0f;
  const float sin_t =
      not_normal ? sqrtf(clamp_lo(1.0f - wi.z * wi.z, F(1e-12))) : 0.0f;
  const float invlen = 1.0f / clamp_lo(sin_t, F(1e-12));
  const float cosphi = not_normal ? wi.x * invlen : 1.0f;
  const float sinphi = not_normal ? wi.y * invlen : 0.0f;
  float sx, sy;
  sample_slopes(cos_t, sin_t, randu, randv, sx, sy);
  const float tmp = cosphi * sx - sinphi * sy;
  sy = sinphi * sx + cosphi * sy;
  return vnormalize(mk(-(ax * tmp), -(ay * sy), 1.0f));
}
STEP_FN F3 ggx_sample(F3 wo, float ax, float ay, float u1, float u2) {
  const F3 m = sample_stretched(wo, ax, ay, u1, u2);
  const float c2 = vdot(m, wo) * 2.0f;
  return sub(scale(m, c2), wo);
}

// shading/principled.py
struct Bsdf {
  bool en_d, en_ss, en_s, en_c;
  F3 dw, ssw, ssa, ssr, sw, sc, cw, cc;
  float ax, ay, ior, ca, cior;
};

STEP_FN Bsdf diffuse_only_bsdf(F3 weight) {
  Bsdf b;
  b.en_d = true;
  b.en_ss = b.en_s = b.en_c = false;
  b.dw = weight;
  b.ssw = b.ssa = b.ssr = b.sw = b.sc = b.cw = b.cc = zero3();
  b.ax = b.ay = b.ca = 0.0f;
  b.ior = b.cior = 1.5f;
  return b;
}

STEP_FN Bsdf param_to_bsdf(const float* m) {
  const float cutoff = F(1e-3);
  const float subsurface = m[kSubsurface], metallic = m[kMetallic];
  const float specular = m[kSpecular], clearcoat = m[kClearcoat];
  const float transmission = m[kTransmission];
  const F3 base = ld3(m + kBaseColor);
  const float diffuse_w =
      (1.0f - saturate(metallic)) * (1.0f - saturate(transmission));
  const float final_transmission =
      saturate(transmission) * (1.0f - saturate(metallic));
  const float specular_w = 1.0f - final_transmission;
  const F3 sub_color = ld3(m + kSubsurfaceColor);
  const float one_minus_ss = 1.0f - subsurface;
  const F3 mixed = add(scale(sub_color, subsurface), scale(base, one_minus_ss));
  const bool mixed_ok = sum3(mixed.x, mixed.y, mixed.z) * F(1.0 / 3.0) > cutoff;
  const bool pick_diffuse =
      mixed_ok && subsurface < cutoff && diffuse_w > cutoff;
  const bool pick_sss = mixed_ok && subsurface > cutoff;

  // bssrdf_setup(mixed * diffuse_w, mixed, radius * subsurface), per channel
  const F3 radius = scale(ld3(m + kSubsurfaceRadius), subsurface);
  float w2[3], add_d[3], r_out[3];
  const float mx[3] = {mixed.x, mixed.y, mixed.z};
  const float rd[3] = {radius.x, radius.y, radius.z};
  for (int c = 0; c < 3; ++c) {
    const float w = mx[c] * diffuse_w;
    const bool tiny = rd[c] < F(1e-8);
    const float r = tiny ? 0.0f : rd[c];
    const float a = mx[c];
    const float d = a - F(0.8);
    const float fit = (F(1.85) - a) + fabsf((d * d) * d) * 7.0f;
    const float ro = (r * F(0.25 * (1.0 / kPi))) / clamp_lo(fit, F(1e-12));
    w2[c] = tiny ? 0.0f : w;
    add_d[c] = pick_sss ? (tiny ? w : 0.0f) : 0.0f;
    r_out[c] = tiny ? 0.0f : ro;
  }
  const bool has_add =
      sum3(fabsf(add_d[0]), fabsf(add_d[1]), fabsf(add_d[2])) > 0.0f;

  Bsdf b;
  b.en_d = pick_diffuse || (pick_sss && has_add);
  const F3 dweight = pick_diffuse ? scale(base, diffuse_w) : zero3();
  b.dw = add(dweight, mk(add_d[0], add_d[1], add_d[2]));
  b.en_ss = pick_sss;
  b.ssw = pick_sss ? mk(w2[0], w2[1], w2[2]) : zero3();
  b.ssa = pick_sss ? mixed : zero3();
  b.ssr = pick_sss ? mk(r_out[0], r_out[1], r_out[2]) : zero3();

  b.en_s = specular_w > cutoff && (specular > cutoff || metallic > cutoff);
  const float aspect =
      sqrtf(clamp_lo(1.0f - m[kAnisotropic] * F(0.9), 0.0f));
  const float r2 = m[kRoughness] * m[kRoughness];
  const float y_base = rgb_to_y(base);
  const float yc = clamp_lo(y_base, F(1e-12));
  const F3 rho_tint = y_base > 0.0f ? mk(base.x / yc, base.y / yc, base.z / yc)
                                    : zero3();
  const float tint = m[kSpecularTint];
  const F3 rho_spec = mk(1.0f + (rho_tint.x - 1.0f) * tint,
                         1.0f + (rho_tint.y - 1.0f) * tint,
                         1.0f + (rho_tint.z - 1.0f) * tint);
  b.sw = b.en_s ? mk(specular_w, specular_w, specular_w) : zero3();
  b.en_c = clearcoat > cutoff;
  const float cw = (clearcoat * 0.25f) * 1.0f;
  b.cw = b.en_c ? mk(cw, cw, cw) : zero3();
  b.ca = m[kClearcoatRoughness] * m[kClearcoatRoughness];
  b.ax = r2 / clamp_lo(aspect, F(1e-12));
  b.ay = r2 * aspect;
  b.ior = (1.0f / (1.0f - sqrtf(clamp_lo(specular * F(0.08), 0.0f)))) * 2.0f -
          1.0f;
  const F3 a0 = scale(rho_spec, specular * F(0.08));
  b.sc = add(a0, scale(sub(base, a0), metallic));
  b.cior = 1.5f;
  b.cc = mk(F(0.04), F(0.04), F(0.04));
  return b;
}

STEP_FN F3 specular_color(F3 wi, F3 wo, F3 color, float ior) {
  const F3 h = vnormalize(add(wi, wo));
  const float f0 = fresnel_dielectric_cos(1.0f, ior);
  const float fh = (fresnel_dielectric_cos(vdot(h, wo), ior) - f0) /
                   clamp_lo(1.0f - f0, F(1e-12));
  const float k = 1.0f - fh;
  return mk(color.x * k + fh, color.y * k + fh, color.z * k + fh);
}

struct Weights {
  float d, ss, s, c;
};

STEP_FN Weights closure_sample_weights(F3 wo, const Bsdf& b) {
  const F3 mirror = mk(-wo.x, -wo.y, wo.z);
  Weights w;
  w.d = b.en_d ? rgb_to_y(b.dw) : 0.0f;
  w.ss = b.en_ss ? rgb_to_y(b.ssw) : 0.0f;
  w.s = b.en_s ? rgb_to_y(mul(b.sw, specular_color(mirror, wo, b.sc, b.ior)))
               : 0.0f;
  w.c = b.en_c ? rgb_to_y(mul(b.cw, specular_color(mirror, wo, b.cc, b.cior)))
               : 0.0f;
  const float total = ((w.d + w.ss) + w.s) + w.c;
  const float inv = total > 0.0f ? 1.0f / total : 0.0f;
  w.d = w.d * inv;
  w.ss = w.ss * inv;
  w.s = w.s * inv;
  w.c = w.c * inv;
  return w;
}

// eval_bsdf, given the closure weights of (wo, b)
STEP_FN void eval_bsdf(F3 wi, F3 wo, const Bsdf& b, const Weights& w, F3& f,
                       float& pdf) {
  f = zero3();
  pdf = 0.0f;
  f = add(f, b.en_d ? scale(b.dw, F(1.0 / kPi)) : zero3());
  pdf = pdf + (b.en_d ? w.d * (wi.z * F(1.0 / kPi)) : 0.0f);
  float sf = 0.0f, sp = 0.0f;
  F3 term = zero3();
  if (b.en_s) {
    ggx_eval(wi, wo, b.ax, b.ay, 2, sf, sp);
    term = scale(mul(b.sw, specular_color(wi, wo, b.sc, b.ior)), sf);
  }
  f = add(f, term);
  pdf = pdf + (b.en_s ? w.s * sp : 0.0f);
  term = zero3();
  if (b.en_c) {
    ggx_eval(wi, wo, b.ca, b.ca, 1, sf, sp);
    term = scale(mul(b.cw, specular_color(wi, wo, b.cc, b.cior)), sf);
  }
  f = add(f, term);
  pdf = pdf + (b.en_c ? w.c * sp : 0.0f);
}

// sample_surface's direction and pick
STEP_FN F3 sample_surface(F3 wo, const Bsdf& b, const Weights& w, float u_sel,
                          float u1, float u2, bool& pick_sss) {
  const bool pick_diffuse = u_sel < w.d;
  pick_sss = !pick_diffuse && u_sel < w.d + w.ss;
  const bool pick_spec =
      !pick_diffuse && !pick_sss && u_sel < (w.d + w.ss) + w.s;
  if (pick_diffuse) return cosine_sample_hemisphere(u1, u2);
  if (pick_spec) return ggx_sample(wo, b.ax, b.ay, u1, u2);
  return ggx_sample(wo, b.ca, b.ca, u1, u2);
}

// ---- the step ------------------------------------------------------------

struct Scene {
  const float* face_fat;  // [faces, kFaceCols]
  int faces;
  const float* mat_fat;  // [mats, mat_cols]
  int mat_cols, mats;
  const float* light_fat;  // [lights, kLightCols]
  const float* light_cdf;  // [lights]
  int lights;
};

// what the pre-trace part gives a lane: the ray, the volume draws' answer
struct Pre {
  F3 dir;
  float min_t, max_t, t_scatter;
  F3 channel_pdf;
  uint32_t rng;
  bool alive, surface, volume;
};

// the pre-trace draws and the ray of the row r (wavefront_step up to its
// trace launch)
STEP_FN Pre pre_lane(const float* r, bool freeze) {
  Pre p;
  const int mode = static_cast<int>(r[17]);
  p.surface = mode == 0;
  p.volume = mode == 1;
  p.alive = r[15] > 0.5f;
  uint32_t s = bits(r[14]);
  const float ud1 = draw(s), ud2 = draw(s), uc = draw(s), ut = draw(s);
  p.rng = s;
  const bool need_new_dir = p.volume && !(r[18] > 0.5f);
  p.dir = need_new_dir ? uniform_sample_sphere(ud1, ud2) : ld3(r + 3);
  p.min_t = need_new_dir ? 0.0f : r[6];
  p.t_scatter = sample_scatter_distance(ld3(r + 25), ld3(r + 22), ld3(r + 19),
                                        uc, ut, p.channel_pdf);
  const float max_t = p.volume ? p.t_scatter : (freeze ? -1.0f : F(1.844e18));
  p.max_t = p.alive ? max_t : -1.0f;
  return p;
}

// which pending shadow query the trace answers (resolving steps only)
STEP_FN bool resolve_mask(const float* r, const Pre& p, bool freeze) {
  const bool nee_active = r[38] >= 0.0f;
  return freeze ? (p.volume && p.alive && nee_active) : nee_active;
}

// pack_state(unpack_state(r)): the chain's pass-through of a row
STEP_FN void copy_row(const float* r, float* o) {
  for (int k = 0; k < kCols; ++k) o[k] = r[k];
  o[15] = r[15] > 0.5f ? 1.0f : 0.0f;
  o[16] = r[16] > 0.5f ? 1.0f : 0.0f;
  o[18] = r[18] > 0.5f ? 1.0f : 0.0f;
  const int ints[5] = {17, 28, 29, 30, 31};
  for (int k = 0; k < 5; ++k) o[ints[k]] = F(static_cast<int>(r[ints[k]]));
}

// the light sample of sample_all_light (u0 through the CDF's lower bound)
STEP_FN bool sample_light(const Scene& sc, float u0, float u1, float u2,
                          F3& pos, F3& normal, F3& emission, float& pdf) {
  if (sc.lights == 0) {
    pos = normal = emission = zero3();
    pdf = 0.0f;
    return false;
  }
  int lo = 0, hi = sc.lights;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (!(sc.light_cdf[mid] >= u0)) lo = mid + 1;
    else hi = mid;
  }
  const float* row = sc.light_fat + static_cast<int64_t>(
      lo < sc.lights - 1 ? lo : sc.lights - 1) * kLightCols;
  const float big = tmax(u1, u2), small = tmin(u1, u2);
  const float u = 1.0f - big, v = big - small;
  pos = add(add(ld3(row), scale(ld3(row + 3), u)), scale(ld3(row + 6), v));
  normal = ld3(row + 9);
  emission = ld3(row + 12);
  pdf = row[15];
  return true;
}

// the step after the trace: from the row r, its pre-trace part p and the
// hit (t, u, v, prim; occ the pending shadow query's answer where the step
// resolves) to the new row o (which may be r)
STEP_FN void shade_lane(const Scene& sc, const float* r, const Pre& p,
                        bool freeze, bool resolving, float hit_t, float hu,
                        float hv, int prim, bool occ, float* o) {
  if (freeze && p.surface) {  // surface lanes pass through untouched
    copy_row(r, o);
    return;
  }
  const F3 org = ld3(r);
  const F3 tp_in = ld3(r + 7);
  const float bsdf_pdf = r[13];
  const bool first = r[16] > 0.5f;
  const F3 sigma_t = ld3(r + 19), sigma_s = ld3(r + 22), sss_tp = ld3(r + 25);
  const int sss_instance = static_cast<int>(r[28]);
  const F3 nee_dir = ld3(r + 32), nee_contrib = ld3(r + 35);
  const float nee_maxt = r[38];
  const F3 d = p.dir;
  uint32_t s = p.rng;

  F3 contribution = ld3(r + 10);
  bool resolved_now = false;
  if (resolving) {
    const bool rm = resolve_mask(r, p, freeze);
    contribution = add(contribution, (rm && !occ) ? nee_contrib : zero3());
    resolved_now = rm;
  }
  const bool hit_ok = prim >= 0;
  const float t_eff = (p.volume && !hit_ok) ? p.t_scatter : hit_t;
  const float t_shade = (hit_ok || p.volume) ? t_eff : 1.0f;
  const F3 pos = add(org, scale(d, t_shade));
  const float* frow =
      sc.face_fat + static_cast<int64_t>(prim > 0 ? prim : 0) * kFaceCols;
  const F3 ng = ld3(frow);
  const float w0 = (1.0f - hu) - hv;
  const F3 ns_lerp = vnormalize(add(add(scale(ld3(frow + 3), w0),
                                        scale(ld3(frow + 6), hu)),
                                    scale(ld3(frow + 9), hv)));
  const F3 ns = frow[18] > 0.0f ? ns_lerp : ng;
  const int hit_instance = static_cast<int>(frow[25]);
  const int mat_id = static_cast<int>(frow[20]);
  const float dg = vdot(d, ng), ds = vdot(d, ns);
  const int face = (dg < 0.0f && ds < 0.0f) ? kFront
                   : ((dg > 0.0f && ds > 0.0f) ? kBack : kAmbiguous);

  // surface lanes: emission MIS + russian roulette
  bool s_alive = p.alive && p.surface && !freeze;
  const float pdf_area = frow[21];
  const float nsd = vdot(ns, d);
  const float a2sa = fabsf((t_shade * t_shade) /
                           (fabsf(nsd) > F(1e-12) ? nsd : F(1e-12)));
  const float mis_w =
      first ? 1.0f : power_heuristic_weight(bsdf_pdf, pdf_area * a2sa);
  const bool add_em = s_alive && hit_ok && face == kFront && pdf_area > 0.0f;
  contribution = add(contribution,
                     add_em ? mul(scale(ld3(frow + 22), mis_w), tp_in)
                            : zero3());
  const float urr = draw(s);
  const float rr_p = amax3(tp_in);
  const bool rr_die = rr_p < urr;
  const float rr_c = clamp_lo(rr_p, F(1e-12));
  const F3 tp = (s_alive && !rr_die)
                    ? mk(tp_in.x / rr_c, tp_in.y / rr_c, tp_in.z / rr_c)
                    : tp_in;
  s_alive = s_alive && hit_ok && !rr_die;

  // volume lanes: one walk step
  const bool v_alive = p.alive && p.volume;
  const float uvrr = draw(s);
  F3 walk_tp = sss_tp;
  bool exit_ok = false, v_dead_exit = false, v_scatter = false;
  bool v_rr_die = false;
  if (p.volume) {
    const F3 trans = mk(expf(-sigma_t.x * t_eff), expf(-sigma_t.y * t_eff),
                        expf(-sigma_t.z * t_eff));
    const float pdf_hit = vdot(p.channel_pdf, trans);
    const float pdf_scatter = vdot(p.channel_pdf, mul(sigma_t, trans));
    if (hit_ok) {
      const float c = clamp_lo(pdf_hit, F(1e-12));
      const F3 x = mul(sss_tp, trans);
      walk_tp = mk(x.x / c, x.y / c, x.z / c);
    } else {
      const float c = clamp_lo(pdf_scatter, F(1e-12));
      const F3 x = mul(sss_tp, mul(sigma_s, trans));
      walk_tp = mk(x.x / c, x.y / c, x.z / c);
    }
    exit_ok =
        v_alive && hit_ok && hit_instance == sss_instance && face == kBack;
    v_dead_exit = v_alive && hit_ok && !exit_ok;
    v_scatter = v_alive && !hit_ok;
    const float pv = saturate(amax3(walk_tp));
    v_rr_die = v_scatter && uvrr >= pv;
    if (v_scatter) {
      const float c = clamp_lo(pv, F(1e-12));
      walk_tp = mk(walk_tp.x / c, walk_tp.y / c, walk_tp.z / c);
    }
  }

  // shade (surface hit or SSS exit)
  const bool is_exit = exit_ok;
  const bool s_shade = s_alive && face != kAmbiguous;
  const bool s_dead_amb = s_alive && face == kAmbiguous;
  const bool shade_mask = s_shade || is_exit;
  const int mi = mat_id < 0 ? 0 : (mat_id > sc.mats - 1 ? sc.mats - 1 : mat_id);
  const F3 ez = (is_exit || face == kFront) ? ns : neg(ns);
  F3 ex, ey;
  branchless_onb(ez, ex, ey);
  const F3 omega_out = to_local(is_exit ? d : neg(d), ex, ey, ez);
  const Bsdf bsdf =
      is_exit ? diffuse_only_bsdf(walk_tp)
              : param_to_bsdf(sc.mat_fat +
                              static_cast<int64_t>(mi) * sc.mat_cols);
  const Weights cw = closure_sample_weights(omega_out, bsdf);

  // deferred NEE
  const float un0 = draw(s), un1 = draw(s), un2 = draw(s);
  const float keep_maxt = resolved_now ? -1.0f : nee_maxt;
  F3 lpos, lnormal, lemission;
  float lpdf;
  const bool lvalid =
      sample_light(sc, un0, un1, un2, lpos, lnormal, lemission, lpdf);
  const F3 to_light = sub(lpos, pos);
  const float dist = sqrtf(clamp_lo(vdot(to_light, to_light), F(1e-12)));
  const F3 wl = mk(to_light.x / dist, to_light.y / dist, to_light.z / dist);
  const float wl_dot_nl = -vdot(wl, lnormal);
  const float wl_dot_np = vdot(wl, ez);
  const float denom = wl_dot_nl * wl_dot_np;
  const float pdf_sigma = clamp_hi(
      fabsf(((lpdf * dist) * dist) /
            (fabsf(denom) > F(1e-12) ? denom : F(1e-12))),
      F(1e30));
  const bool candidate = shade_mask && lvalid && wl_dot_nl > 0.0f &&
                         wl_dot_np > 0.0f && pdf_sigma > 0.0f;
  const float shadow_max = clamp_lo(dist - F(1e-3), F(1e-3));
  F3 nee_c = zero3();
  if (candidate) {
    F3 f;
    float pdf_b;
    eval_bsdf(to_local(wl, ex, ey, ez), omega_out, bsdf, cw, f, pdf_b);
    const float q = power_heuristic_weight(pdf_sigma, pdf_b) /
                    clamp_lo(pdf_sigma, F(1e-12));
    const F3 c = scale(mul(f, lemission), q);
    nee_c = finite3(c) ? c : zero3();
  }

  // closure sampling
  const float ub0 = draw(s), ub1 = draw(s), ub2 = draw(s);
  draw(s);  // the fourth draw, kept for the stream layout
  bool pick_sss_raw;
  const F3 omega_in =
      sample_surface(omega_out, bsdf, cw, ub0, ub1, ub2, pick_sss_raw);
  F3 f;
  float pdf_b;
  eval_bsdf(omega_in, omega_out, bsdf, cw, f, pdf_b);
  const bool pick_sss = pick_sss_raw && s_shade && face == kFront;
  const bool sss_die = pick_sss_raw && s_shade && face != kFront;
  const float k = fabsf(omega_in.z) / clamp_lo(pdf_b, F(1e-12));
  const F3 factor = scale(f, k);
  const bool bad = pdf_b <= 0.0f || !finite3(factor) || !isfinite(pdf_b);
  const bool cont_surface = shade_mask && !pick_sss && !bad;
  const F3 entry_g =
      to_global(neg(cosine_sample_hemisphere(ub1, ub2)), ex, ey, ez);
  const bool entry_ok = pick_sss && vdot(neg(ng), entry_g) > 0.0f;

  // state merge
  bool new_alive =
      p.surface ? (cont_surface || entry_ok)
                : (v_scatter ? (v_alive && !v_rr_die) : cont_surface);
  new_alive = new_alive && p.alive && !s_dead_amb && !v_dead_exit && !sss_die;
  const bool new_volume = entry_ok || (v_scatter && !v_rr_die);
  const F3 new_tp = cont_surface ? mul(tp, factor) : tp;
  const F3 new_org = (shade_mask || entry_ok) ? pos
                     : (v_scatter ? add(org, scale(d, t_eff)) : org);
  const F3 new_dir = cont_surface ? to_global(omega_in, ex, ey, ez)
                     : (entry_ok ? entry_g : d);
  const float new_min_t = (cont_surface || entry_ok) ? F(1e-3)
                          : (v_scatter ? 0.0f : p.min_t);
  new_alive = new_alive && sum3(fabsf(new_tp.x), fabsf(new_tp.y),
                                fabsf(new_tp.z)) > F(1.1920929e-07);
  F3 new_sigma_t = sigma_t, new_sigma_s = sigma_s;
  F3 new_sss_tp = p.volume ? walk_tp : sss_tp;
  if (entry_ok) {
    float t0[3];
    const float wgt[3] = {bsdf.ssw.x, bsdf.ssw.y, bsdf.ssw.z};
    const float alb[3] = {bsdf.ssa.x, bsdf.ssa.y, bsdf.ssa.z};
    const float rad[3] = {bsdf.ssr.x, bsdf.ssr.y, bsdf.ssr.z};
    float st[3], ss[3];
    for (int c = 0; c < 3; ++c) {
      scattering(wgt[c], alb[c], rad[c], st[c], ss[c], t0[c]);
    }
    new_sigma_t = mk(st[0], st[1], st[2]);
    new_sigma_s = mk(ss[0], ss[1], ss[2]);
    new_sss_tp = mk(t0[0], t0[1], t0[2]);
  }
  const F3 out_nee_dir = shade_mask ? wl : nee_dir;
  const F3 out_nee_contrib = shade_mask ? mul(tp, nee_c) : nee_contrib;
  const float out_nee_maxt =
      shade_mask ? (candidate ? shadow_max : -1.0f) : keep_maxt;

  // every read of r is above: o may be r
  const float lane = F(static_cast<int>(r[29]));
  const float sample = F(static_cast<int>(r[30]));
  const float depth = F(static_cast<int>(r[31]));
  const bool vol_first = r[18] > 0.5f;
  o[0] = new_org.x; o[1] = new_org.y; o[2] = new_org.z;
  o[3] = new_dir.x; o[4] = new_dir.y; o[5] = new_dir.z;
  o[6] = new_min_t;
  o[7] = new_tp.x; o[8] = new_tp.y; o[9] = new_tp.z;
  o[10] = contribution.x; o[11] = contribution.y; o[12] = contribution.z;
  o[13] = cont_surface ? pdf_b : bsdf_pdf;
  o[14] = from_bits(s);
  o[15] = new_alive ? 1.0f : 0.0f;
  o[16] = (first && !shade_mask) ? 1.0f : 0.0f;
  o[17] = new_volume ? 1.0f : 0.0f;
  o[18] = (entry_ok || (vol_first && !p.volume)) ? 1.0f : 0.0f;
  o[19] = new_sigma_t.x; o[20] = new_sigma_t.y; o[21] = new_sigma_t.z;
  o[22] = new_sigma_s.x; o[23] = new_sigma_s.y; o[24] = new_sigma_s.z;
  o[25] = new_sss_tp.x; o[26] = new_sss_tp.y; o[27] = new_sss_tp.z;
  o[28] = F(entry_ok ? hit_instance : sss_instance);
  o[29] = lane; o[30] = sample; o[31] = depth;
  o[32] = out_nee_dir.x; o[33] = out_nee_dir.y; o[34] = out_nee_dir.z;
  o[35] = out_nee_contrib.x;
  o[36] = out_nee_contrib.y;
  o[37] = out_nee_contrib.z;
  o[38] = out_nee_maxt;
}

#undef F

}  // namespace step

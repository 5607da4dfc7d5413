// dense_v5i two-level (TLAS/BLAS) packet traversal kernel for Hopper
// (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel pbrlab_tpu/ops/pallas/dense_v5i.py
// _trace_kernel (wrapper dense_trace_v5i): closest hit or any hit over an
// instanced scene, where each local scene is one BLAS in local space shared
// by its instances and the TLAS leaves are instances with a world-to-local
// affine transform. Bound with ctypes from pbrlab_tpu_torch/ops/dense_v5i.py,
// which also holds the plain torch version (_walk_ref).
//
// Inputs: the packed local triangles attr-major [12, S] (i5_tris), one node
// array for both levels, node_aabb [6, Nn] and node_meta [2, Nn] (TLAS
// nodes first: meta[0] the right child or -1 on a leaf; on a leaf meta[1]
// the BLAS slot base, or -(instance + 1) on a TLAS leaf), per instance
// inst_inv [12, K] (world-to-local rows r00 r01 r02 t0 r10 ...) and
// inst_meta [2, K] (BLAS root node, slot-to-face-id delta), and the rays
// as contiguous arrays (org/dir [N, 3], min_t/max_t [N]) with N = G * 1024.
//
// Design: csrc/dense_v5.cu's packet walk with one more node kind. One
// 1024-thread block walks one 1024-ray group, one thread per ray, as the
// TPU walks one group per grid step; the group-wide min/max/all of the
// Pallas body are block reductions and votes, so every thread takes the
// same branch and the loops, the stack and the barriers stay uniform. One
// shared-memory stack of 160 (node, entry t) entries serves both levels:
// at a TLAS leaf each thread maps its own ray into the instance's space
// (the direction is not renormalised, so t stays comparable across
// instances; the slab reciprocals are recomputed there), the block pushes
// the BLAS root above the current pointer `sp_base` and walks the BLAS
// until the pointer is back at sp_base, then goes on with the TLAS. The
// cull bound gmax starts as the group's largest max_t and changes only
// after a BLAS leaf (:243), as on the TPU. Any-hit: when every live lane
// has a hit, a vote at a BLAS leaf ends the BLAS walk and a vote after
// the instance ends the whole walk. The slab test (x 1.00000024 slop),
// the far-first push order, the pop cull `tn (1 - 1e-6) - 1e-6 <= gmax`
// and the float operations of the transform and the triangle test are
// the Pallas body's, in its order; the library is built with --fmad=false
// and IEEE division, so the plain torch walk gives the same bits. The
// stack is written by every thread alike, only after a barrier, and each
// thread pops only what it wrote, as in dense_v5.cu.
//
// What bounds it: f32 operations, the ray-triangle tests of the BLAS
// leaves (about 40 operations per ray and triangle), the ray-box tests (27)
// and the per-instance transform (about 30 per ray and instance), with one
// or two block barriers per node. The design keeps the tables in global
// memory, read through the read-only cache (the TPU's 1 MB scalar memory
// cap does not apply), stages each visited leaf's 384 floats in shared
// memory, and keeps the ray in both spaces in registers. Known first-cut
// weakness, as dense_v5: each ray pays for the union of its group's nodes
// and leaves, and at 65536 lanes only 64 blocks run on 132 SMs.

#include <cuda_runtime.h>

namespace {

constexpr int kGroup = 1024;
constexpr int kCluster = 32;
constexpr int kStack = 160;
constexpr int kWarps = kGroup / 32;
constexpr int kLeafFloats = 12 * kCluster;
constexpr float kBig = 1e30f;
constexpr float kSlop = 1.00000024f;
constexpr float kEps = 1e-12f;
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const float* tris;   // [12, S]
  int slots;           // S
  const float* naabb;  // [6, Nn]
  const int* nmeta;    // [2, Nn]
  int nodes;           // Nn
  const float* inv;    // [12, K]
  const int* imeta;    // [2, K]
  int insts;           // K
  const float* org;
  const float* dir;
  const float* min_t;
  const float* max_t;
  float* out_t;
  float* out_u;
  float* out_v;
  int* out_prim;
};

// jnp / torch maximum and minimum: NaN in either operand gives NaN
__device__ __forceinline__ float pmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}
__device__ __forceinline__ float pmin(float a, float b) {
  return (a < b || a != a) ? a : b;
}

__device__ __forceinline__ float inv_dir(float d) {
  const float e = fabsf(d) < kEps ? (d < 0.f ? -kEps : kEps) : d;
  return 1.0f / e;
}

struct Slab {  // one ray's slab-test terms in one space
  float ix, iy, iz, ox, oy, oz;
};

__device__ __forceinline__ Slab make_slab(float ox, float oy, float oz,
                                          float dx, float dy, float dz) {
  Slab s;
  s.ix = inv_dir(dx);
  s.iy = inv_dir(dy);
  s.iz = inv_dir(dz);
  s.ox = ox * s.ix;
  s.oy = oy * s.iy;
  s.oz = oz * s.iz;
  return s;
}

// entry t of the ray into box `node` if it enters before `cap`, else kBig
__device__ __forceinline__ float slab(const float* __restrict__ naabb,
                                      int nodes, int node, const Slab& s,
                                      float mint, float cap) {
  float t0 = __ldg(naabb + node) * s.ix - s.ox;
  float t1 = __ldg(naabb + 3 * nodes + node) * s.ix - s.ox;
  const float nx = pmin(t0, t1), fx = pmax(t0, t1);
  t0 = __ldg(naabb + nodes + node) * s.iy - s.oy;
  t1 = __ldg(naabb + 4 * nodes + node) * s.iy - s.oy;
  const float ny = pmin(t0, t1), fy = pmax(t0, t1);
  t0 = __ldg(naabb + 2 * nodes + node) * s.iz - s.oz;
  t1 = __ldg(naabb + 5 * nodes + node) * s.iz - s.oz;
  const float nz = pmin(t0, t1), fz = pmax(t0, t1);
  const float tnear = pmax(pmax(nx, ny), pmax(nz, mint));
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

// test both children of inner node `node` (group-wide entry t each), push
// the far one first and the near one second (popped first)
__device__ __forceinline__ void visit_inner(const Params& p, int node,
                                            int right, const Slab& s,
                                            float mint, float best_t,
                                            int* stk_id, float* stk_tn,
                                            int& sp, float (*red)[kWarps][2],
                                            int& buf) {
  const int left = node + 1;
  float tn_l = slab(p.naabb, p.nodes, left, s, mint, best_t);
  float tn_r = slab(p.naabb, p.nodes, right, s, mint, best_t);
  block_reduce2<false>(tn_l, tn_r, red, buf);
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

template <bool kAnyHit>
__global__ void __launch_bounds__(kGroup, 1) v5i_kernel(const Params p) {
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
  const Slab sw = make_slab(ox, oy, oz, dx, dy, dz);
  float best_t = maxt, best_u = 0.f, best_v = 0.f;
  int best_p = -1;

  // gmax: the largest t any lane can still use (the cull bound); a group
  // with none (all lanes dead: max_t < 0) walks nothing
  float gmax = best_t, unused = best_t;
  block_reduce2<true>(gmax, unused, red, buf);
  stk_id[0] = 0;
  stk_tn[0] = -1e30f;
  int sp = gmax >= 0.f ? 1 : 0;

  while (sp > 0) {
    --sp;
    int node = stk_id[sp];
    // relative + absolute pad: as tolerant as the slab test
    if (!(stk_tn[sp] * 0.999999f - 1e-6f <= gmax)) continue;
    int right = __ldg(p.nmeta + node);
    if (right >= 0) {
      visit_inner(p, node, right, sw, mint, best_t, stk_id, stk_tn, sp, red,
                  buf);
      continue;
    }
    // TLAS leaf: this thread's ray in the instance's space
    const int k = -__ldg(p.nmeta + p.nodes + node) - 1;
    float a[12];
#pragma unroll
    for (int r = 0; r < 12; ++r) a[r] = __ldg(p.inv + r * p.insts + k);
    const float lox = ((a[0] * ox + a[1] * oy) + a[2] * oz) + a[3];
    const float loy = ((a[4] * ox + a[5] * oy) + a[6] * oz) + a[7];
    const float loz = ((a[8] * ox + a[9] * oy) + a[10] * oz) + a[11];
    const float ldx = (a[0] * dx + a[1] * dy) + a[2] * dz;
    const float ldy = (a[4] * dx + a[5] * dy) + a[6] * dz;
    const float ldz = (a[8] * dx + a[9] * dy) + a[10] * dz;
    const Slab sl = make_slab(lox, loy, loz, ldx, ldy, ldz);
    const int root = __ldg(p.imeta + k);
    const int fid_delta = __ldg(p.imeta + p.insts + k);
    int sp_base = sp;
    float tn0 = slab(p.naabb, p.nodes, root, sl, mint, best_t);
    float tn0b = tn0;
    block_reduce2<false>(tn0, tn0b, red, buf);
    if (tn0 < kBig) {
      stk_id[sp] = root;
      stk_tn[sp] = tn0;
      ++sp;
    }
    // the BLAS walk on the stack above sp_base
    while (sp > sp_base) {
      --sp;
      node = stk_id[sp];
      if (!(stk_tn[sp] * 0.999999f - 1e-6f <= gmax)) continue;
      right = __ldg(p.nmeta + node);
      if (right >= 0) {
        visit_inner(p, node, right, sl, mint, best_t, stk_id, stk_tn, sp,
                    red, buf);
        continue;
      }
      const int base = __ldg(p.nmeta + p.nodes + node);
      // stage the leaf's 12 x 32 floats, one per thread; the last reader
      // of the previous leaf passed a barrier (its gmax reduction) since
      if (threadIdx.x < kLeafFloats) {
        const int at = threadIdx.x / kCluster, kk = threadIdx.x % kCluster;
        leaf[threadIdx.x] =
            __ldg(p.tris + static_cast<size_t>(at) * p.slots + base + kk);
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < kCluster; ++kk) {
        const float nx = leaf[0 * kCluster + kk];
        const float ny = leaf[1 * kCluster + kk];
        const float nz = leaf[2 * kCluster + kk];
        const float k0 = leaf[3 * kCluster + kk];
        const float b1x = leaf[4 * kCluster + kk];
        const float b1y = leaf[5 * kCluster + kk];
        const float b1z = leaf[6 * kCluster + kk];
        const float c1 = leaf[7 * kCluster + kk];
        const float b2x = leaf[8 * kCluster + kk];
        const float b2y = leaf[9 * kCluster + kk];
        const float b2z = leaf[10 * kCluster + kk];
        const float c2 = leaf[11 * kCluster + kk];
        // den == 0 (padding rows are all zero) -> t inf/nan -> no hit
        const float t =
            (k0 - (lox * nx + loy * ny + loz * nz)) /
            (ldx * nx + ldy * ny + ldz * nz);
        const float u = (lox * b1x + loy * b1y + loz * b1z - c1) +
                        t * (ldx * b1x + ldy * b1y + ldz * b1z);
        const float v = (lox * b2x + loy * b2y + loz * b2z - c2) +
                        t * (ldx * b2x + ldy * b2y + ldz * b2z);
        // strict t < best_t keeps the first-visited triangle on ties
        if (u >= 0.f && v >= 0.f && u + v <= 1.f && t >= mint && t < best_t) {
          best_t = t;
          best_u = u;
          best_v = v;
          best_p = base + kk + fid_delta;
        }
      }
      float g2 = best_t;
      gmax = best_t;
      block_reduce2<true>(gmax, g2, red, buf);
      // stop once every live lane has a hit; dead and padding lanes
      // (max_t < min_t) can never find one and must not block it
      if (kAnyHit && __syncthreads_and(best_p >= 0 || maxt < mint)) {
        sp = sp_base;
      }
    }
    if (kAnyHit && __syncthreads_and(best_p >= 0 || maxt < mint)) {
      sp_base = 0;
    }
    sp = sp_base;
  }

  p.out_t[i] = best_t;
  p.out_u[i] = best_u;
  p.out_v[i] = best_v;
  p.out_prim[i] = best_p;
}

}  // namespace

// closest (any_hit 0) or any hit over an instanced scene's tables
extern "C" int dense_v5i_trace(const float* tris, int slots,
                               const float* naabb, const int* nmeta,
                               int nodes, const float* inv, const int* imeta,
                               int insts, const float* org, const float* dir,
                               const float* min_t, const float* max_t,
                               int any_hit, int groups, float* out_t,
                               float* out_u, float* out_v, int* out_prim,
                               void* stream) {
  Params p = {};
  p.tris = tris;
  p.slots = slots;
  p.naabb = naabb;
  p.nmeta = nmeta;
  p.nodes = nodes;
  p.inv = inv;
  p.imeta = imeta;
  p.insts = insts;
  p.org = org;
  p.dir = dir;
  p.min_t = min_t;
  p.max_t = max_t;
  p.out_t = out_t;
  p.out_u = out_u;
  p.out_v = out_v;
  p.out_prim = out_prim;
  if (groups > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (any_hit) {
      v5i_kernel<true><<<groups, kGroup, 0, s>>>(p);
    } else {
      v5i_kernel<false><<<groups, kGroup, 0, s>>>(p);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

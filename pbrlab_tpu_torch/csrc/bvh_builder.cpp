// Native scene-build code of the port: Morton ordering + binned-SAH
// threaded BVH, a copy of the JAX package's native/builder.cpp.
//
// It stays a byte-for-byte copy of that file's code, built with the same
// flags, so that a large scene's BVH (and with it every slot id) is the
// JAX package's. Scene commit runs on the host; only flat arrays go to the
// device. pbrlab_tpu_torch/geometry/bvh.py is the numpy build for small
// scenes; this is the build for >= 4096 primitives.
//
// Exposed via a plain C ABI for ctypes, loaded by
// pbrlab_tpu_torch/geometry/native.py, which builds it at first use with
//   c++ -O3 -march=native -shared -fPIC bvh_builder.cpp -o build/...so

#include <algorithm>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <vector>

namespace {

inline uint64_t spread3(uint64_t x) {
  x = (x | (x << 16)) & 0x30000FFull;
  x = (x | (x << 8)) & 0x300F00Full;
  x = (x | (x << 4)) & 0x30C30C3ull;
  x = (x | (x << 2)) & 0x9249249ull;
  return x;
}

struct BuildCtx {
  const float* bmin;  // [n,3]
  const float* bmax;  // [n,3]
  int leaf_size;
  std::vector<float> node_bmin, node_bmax;
  std::vector<int32_t> skip, prim_offset;
  std::vector<int32_t> prim_ids;
};

constexpr int kBins = 16;

// Emit a subtree depth-first; returns node index. Nodes are threaded with
// skip links patched after the subtree is emitted (the layout contract of
// pbrlab_tpu.geometry.bvh.BVH).
int emit(BuildCtx& ctx, std::vector<int32_t>& ids, int lo, int hi) {
  const int my = static_cast<int>(ctx.skip.size());
  float bmn[3] = {FLT_MAX, FLT_MAX, FLT_MAX};
  float bmx[3] = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
  for (int i = lo; i < hi; ++i) {
    const int32_t p = ids[i];
    for (int a = 0; a < 3; ++a) {
      bmn[a] = std::min(bmn[a], ctx.bmin[3 * p + a]);
      bmx[a] = std::max(bmx[a], ctx.bmax[3 * p + a]);
    }
  }
  for (int a = 0; a < 3; ++a) {
    ctx.node_bmin.push_back(bmn[a]);
    ctx.node_bmax.push_back(bmx[a]);
  }
  ctx.skip.push_back(-1);
  ctx.prim_offset.push_back(-1);

  const int count = hi - lo;
  if (count <= ctx.leaf_size) {
    ctx.prim_offset[my] = static_cast<int32_t>(ctx.prim_ids.size());
    for (int i = lo; i < hi; ++i) ctx.prim_ids.push_back(ids[i]);
    for (int i = count; i < ctx.leaf_size; ++i) ctx.prim_ids.push_back(-1);
    ctx.skip[my] = static_cast<int32_t>(ctx.skip.size());
    return my;
  }

  // centroid bounds + widest axis
  float cmn[3] = {FLT_MAX, FLT_MAX, FLT_MAX};
  float cmx[3] = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
  for (int i = lo; i < hi; ++i) {
    const int32_t p = ids[i];
    for (int a = 0; a < 3; ++a) {
      const float c = 0.5f * (ctx.bmin[3 * p + a] + ctx.bmax[3 * p + a]);
      cmn[a] = std::min(cmn[a], c);
      cmx[a] = std::max(cmx[a], c);
    }
  }
  int axis = 0;
  float ext = cmx[0] - cmn[0];
  for (int a = 1; a < 3; ++a) {
    if (cmx[a] - cmn[a] > ext) {
      ext = cmx[a] - cmn[a];
      axis = a;
    }
  }

  int mid = -1;
  if (ext > 1e-12f) {
    // binned SAH
    struct Bin {
      int count = 0;
      float bmn[3] = {FLT_MAX, FLT_MAX, FLT_MAX};
      float bmx[3] = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
    };
    Bin bins[kBins];
    const float scale = kBins * (1.0f - 1e-6f) / ext;
    auto bin_of = [&](int32_t p) {
      const float c =
          0.5f * (ctx.bmin[3 * p + axis] + ctx.bmax[3 * p + axis]);
      int b = static_cast<int>((c - cmn[axis]) * scale);
      return std::min(std::max(b, 0), kBins - 1);
    };
    for (int i = lo; i < hi; ++i) {
      const int32_t p = ids[i];
      Bin& b = bins[bin_of(p)];
      b.count++;
      for (int a = 0; a < 3; ++a) {
        b.bmn[a] = std::min(b.bmn[a], ctx.bmin[3 * p + a]);
        b.bmx[a] = std::max(b.bmx[a], ctx.bmax[3 * p + a]);
      }
    }
    auto half_area = [](const float mn[3], const float mx[3]) {
      const float d0 = std::max(mx[0] - mn[0], 0.f);
      const float d1 = std::max(mx[1] - mn[1], 0.f);
      const float d2 = std::max(mx[2] - mn[2], 0.f);
      return d0 * d1 + d1 * d2 + d2 * d0;
    };
    float lmn[kBins][3], lmx[kBins][3], rmn[kBins][3], rmx[kBins][3];
    int lcnt[kBins], rcnt[kBins];
    {
      float accn[3] = {FLT_MAX, FLT_MAX, FLT_MAX};
      float accx[3] = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
      int acc = 0;
      for (int b = 0; b < kBins; ++b) {
        acc += bins[b].count;
        for (int a = 0; a < 3; ++a) {
          accn[a] = std::min(accn[a], bins[b].bmn[a]);
          accx[a] = std::max(accx[a], bins[b].bmx[a]);
        }
        lcnt[b] = acc;
        std::memcpy(lmn[b], accn, sizeof accn);
        std::memcpy(lmx[b], accx, sizeof accx);
      }
      std::memset(accn, 0, 0);  // re-init below
      for (int a = 0; a < 3; ++a) {
        accn[a] = FLT_MAX;
        accx[a] = -FLT_MAX;
      }
      acc = 0;
      for (int b = kBins - 1; b >= 0; --b) {
        acc += bins[b].count;
        for (int a = 0; a < 3; ++a) {
          accn[a] = std::min(accn[a], bins[b].bmn[a]);
          accx[a] = std::max(accx[a], bins[b].bmx[a]);
        }
        rcnt[b] = acc;
        std::memcpy(rmn[b], accn, sizeof accn);
        std::memcpy(rmx[b], accx, sizeof accx);
      }
    }
    float best_cost = FLT_MAX;
    int best_b = -1;
    for (int b = 0; b < kBins - 1; ++b) {
      if (lcnt[b] == 0 || rcnt[b + 1] == 0) continue;
      const float cost = lcnt[b] * half_area(lmn[b], lmx[b]) +
                         rcnt[b + 1] * half_area(rmn[b + 1], rmx[b + 1]);
      if (cost < best_cost) {
        best_cost = cost;
        best_b = b;
      }
    }
    if (best_b >= 0) {
      auto it = std::partition(ids.begin() + lo, ids.begin() + hi,
                               [&](int32_t p) { return bin_of(p) <= best_b; });
      mid = static_cast<int>(it - ids.begin());
      if (mid == lo || mid == hi) mid = -1;
    }
  }
  if (mid < 0) {
    // median split on the widest axis
    mid = lo + count / 2;
    std::nth_element(ids.begin() + lo, ids.begin() + mid, ids.begin() + hi,
                     [&](int32_t a, int32_t b) {
                       return ctx.bmin[3 * a + axis] + ctx.bmax[3 * a + axis] <
                              ctx.bmin[3 * b + axis] + ctx.bmax[3 * b + axis];
                     });
  }

  emit(ctx, ids, lo, mid);
  emit(ctx, ids, mid, hi);
  ctx.skip[my] = static_cast<int32_t>(ctx.skip.size());
  return my;
}

BuildCtx* g_last = nullptr;

}  // namespace

extern "C" {

// Morton order of n points [n,3] -> order_out [n] (indices).
void pbrlab_morton_order(const float* points, int64_t n, int32_t* order_out) {
  if (n <= 0) return;
  float lo[3] = {FLT_MAX, FLT_MAX, FLT_MAX};
  float hi[3] = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
  for (int64_t i = 0; i < n; ++i) {
    for (int a = 0; a < 3; ++a) {
      lo[a] = std::min(lo[a], points[3 * i + a]);
      hi[a] = std::max(hi[a], points[3 * i + a]);
    }
  }
  std::vector<uint64_t> keys(n);
  for (int64_t i = 0; i < n; ++i) {
    uint64_t code = 0;
    for (int a = 0; a < 3; ++a) {
      const float ext = std::max(hi[a] - lo[a], 1e-12f);
      uint64_t q = static_cast<uint64_t>(
          std::min(std::max((points[3 * i + a] - lo[a]) / ext * 1023.0f, 0.f),
                   1023.f));
      code |= spread3(q) << a;
    }
    keys[i] = code;
  }
  std::vector<int32_t> order(n);
  std::iota(order.begin(), order.end(), 0);
  std::stable_sort(order.begin(), order.end(),
                   [&](int32_t a, int32_t b) { return keys[a] < keys[b]; });
  std::memcpy(order_out, order.data(), n * sizeof(int32_t));
}

// Build the threaded BVH. Returns number of nodes; call pbrlab_bvh_read to
// copy the arrays out, then pbrlab_bvh_free.
int64_t pbrlab_bvh_build(const float* bmin, const float* bmax, int64_t n,
                         int32_t leaf_size, int64_t* n_prim_slots_out) {
  delete g_last;
  g_last = new BuildCtx();
  g_last->bmin = bmin;
  g_last->bmax = bmax;
  g_last->leaf_size = leaf_size;
  if (n == 0) {
    g_last->node_bmin = {0, 0, 0};
    g_last->node_bmax = {0, 0, 0};
    g_last->skip = {1};
    g_last->prim_offset = {0};
    g_last->prim_ids.assign(leaf_size, -1);
  } else {
    std::vector<int32_t> ids(n);
    std::iota(ids.begin(), ids.end(), 0);
    g_last->node_bmin.reserve(6 * n);
    g_last->node_bmax.reserve(6 * n);
    emit(*g_last, ids, 0, static_cast<int>(n));
  }
  *n_prim_slots_out = static_cast<int64_t>(g_last->prim_ids.size());
  return static_cast<int64_t>(g_last->skip.size());
}

void pbrlab_bvh_read(float* node_bmin, float* node_bmax, int32_t* skip,
                     int32_t* prim_offset, int32_t* prim_ids) {
  if (!g_last) return;
  std::memcpy(node_bmin, g_last->node_bmin.data(),
              g_last->node_bmin.size() * sizeof(float));
  std::memcpy(node_bmax, g_last->node_bmax.data(),
              g_last->node_bmax.size() * sizeof(float));
  std::memcpy(skip, g_last->skip.data(), g_last->skip.size() * sizeof(int32_t));
  std::memcpy(prim_offset, g_last->prim_offset.data(),
              g_last->prim_offset.size() * sizeof(int32_t));
  std::memcpy(prim_ids, g_last->prim_ids.data(),
              g_last->prim_ids.size() * sizeof(int32_t));
}

void pbrlab_bvh_free() {
  delete g_last;
  g_last = nullptr;
}
}

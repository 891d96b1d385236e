// Permutohedral lattice on the host: hash build, table export, raw
// filter and the dense-CRF mean field, with a plain C interface for
// ctypes (wseg_tpu_torch/ops/crf_native.py).
//
// The algorithm of Adams, Baek & Davis, "Fast High-Dimensional Filtering
// Using the Permutohedral Lattice" (EG 2010), as dense-CRF mean-field
// inference uses it (Krähenbühl & Koltun, NIPS 2011): the port's own copy
// of native/densecrf/{permutohedral.h,permutohedral.cc,densecrf.cc}, with
// the same arithmetic, plus the vertex-major (CSR) transpose of the splat
// table that the CUDA splat (csrc/crf_lattice.cu) reads.
//
// Compiled by the host C++ compiler (-O3 -fPIC -shared -std=c++17) on
// first use into build/kernels/ (wseg_tpu_torch/_build.py).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// Keys are d int16 lattice coordinates with |coord| < 2048 at the CRF
// feature scales; 12 bits per coordinate pack into one uint64 so the
// hash table is a flat open-addressing array.
inline uint64_t pack_key(const int16_t* k, int d) {
  uint64_t p = 0;
  for (int i = 0; i < d; ++i)
    p = (p << 12) | (static_cast<uint64_t>(k[i] + 2048) & 0xfff);
  return p;
}

inline uint64_t mix64(uint64_t x) {  // splitmix64 finaliser
  x += 0x9e3779b97f4a7c15ull;
  x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ull;
  x = (x ^ (x >> 27)) * 0x94d049bb133111ebull;
  return x ^ (x >> 31);
}

// Flat linear-probing map: packed key -> lattice id.
class FlatTable {
 public:
  explicit FlatTable(size_t expected) {
    size_t cap = 64;
    while (cap < expected * 2) cap <<= 1;
    mask_ = cap - 1;
    keys_.assign(cap, kEmpty);
    ids_.assign(cap, -1);
  }

  // Returns the id for key, inserting next_id if absent (insert=true).
  int32_t lookup(uint64_t key, int32_t next_id, bool insert) {
    size_t slot = mix64(key) & mask_;
    for (;;) {
      if (keys_[slot] == key) return ids_[slot];
      if (keys_[slot] == kEmpty) {
        if (!insert) return -1;
        if ((count_ + 1) * 2 > mask_) {
          grow();
          return lookup(key, next_id, true);
        }
        keys_[slot] = key;
        ids_[slot] = next_id;
        ++count_;
        return next_id;
      }
      slot = (slot + 1) & mask_;
    }
  }

 private:
  void grow() {
    std::vector<uint64_t> ok(std::move(keys_));
    std::vector<int32_t> oi(std::move(ids_));
    size_t cap = (mask_ + 1) * 2;
    mask_ = cap - 1;
    keys_.assign(cap, kEmpty);
    ids_.assign(cap, -1);
    for (size_t s = 0; s < ok.size(); ++s) {
      if (ok[s] == kEmpty) continue;
      size_t slot = mix64(ok[s]) & mask_;
      while (keys_[slot] != kEmpty) slot = (slot + 1) & mask_;
      keys_[slot] = ok[s];
      ids_[slot] = oi[s];
    }
  }

  static constexpr uint64_t kEmpty = ~0ull;
  size_t mask_;
  size_t count_ = 0;
  std::vector<uint64_t> keys_;
  std::vector<int32_t> ids_;
};

class Permutohedral {
 public:
  // features: N rows of d floats (row n at features[n*d ..]).
  void init(const float* features, int d, int N);
  // out[n*C+c] = sum_m k(f_n, f_m) in[m*C+c], self term included.
  void compute(float* out, const float* in, int C) const;

  int N_ = 0;  // positions
  int d_ = 0;  // feature dimension
  int M_ = 0;  // occupied lattice points
  std::vector<int32_t> offset_;          // N*(d+1) simplex vertex ids
  std::vector<float> barycentric_;       // N*(d+1) weights
  std::vector<int32_t> blur_neighbors_;  // (d+1)*M*2, missing = M
};

void Permutohedral::init(const float* features, int d, int N) {
  N_ = N;
  d_ = d;
  offset_.assign(static_cast<size_t>(N) * (d + 1), 0);
  barycentric_.assign(static_cast<size_t>(N) * (d + 1), 0.f);

  FlatTable table(static_cast<size_t>(N));
  std::vector<int16_t> keys;  // d coords per lattice point
  keys.reserve(static_cast<size_t>(N) * d);

  // elevation scale: the blur's variance is compensated so the filter
  // is a unit Gaussian in feature space
  std::vector<float> scale_factor(d);
  const float inv_std_dev = std::sqrt(2.0f / 3.0f) * (d + 1);
  for (int i = 0; i < d; ++i)
    scale_factor[i] =
        inv_std_dev / std::sqrt(static_cast<float>((i + 1) * (i + 2)));

  std::vector<float> elevated(d + 1);
  std::vector<float> rem0(d + 1);
  std::vector<int> rank(d + 1);
  std::vector<float> barycentric(d + 2);
  std::vector<int16_t> key(d);

  for (int n = 0; n < N; ++n) {
    const float* f = features + static_cast<size_t>(n) * d;

    // 1. embed into the hyperplane H_d: sum(elevated) == 0.  The fused
    // multiply-add is what an FMA-contracting build of the reference
    // (native/densecrf, -march=native) computes here; fusing it
    // explicitly gives the same tables without architecture flags.
    float sm = 0.f;
    for (int i = d; i > 0; --i) {
      float cf = f[i - 1] * scale_factor[i - 1];
      elevated[i] = std::fma(-static_cast<float>(i), cf, sm);
      sm += cf;
    }
    elevated[0] = sm;

    // 2. nearest zero-coloured lattice point (multiples of d+1)
    int sum = 0;
    const float down = 1.0f / (d + 1);
    for (int i = 0; i <= d; ++i) {
      float v = elevated[i] * down;
      float up_r = std::ceil(v) * (d + 1);
      float down_r = std::floor(v) * (d + 1);
      rem0[i] = (up_r - elevated[i] < elevated[i] - down_r) ? up_r : down_r;
      sum += static_cast<int>(rem0[i] * down);
    }

    // 3. rank the differential to find the enclosing simplex
    for (int i = 0; i <= d; ++i) rank[i] = 0;
    for (int i = 0; i < d; ++i) {
      float di = elevated[i] - rem0[i];
      for (int j = i + 1; j <= d; ++j) {
        float dj = elevated[j] - rem0[j];
        if (di < dj)
          ++rank[i];
        else
          ++rank[j];
      }
    }

    // 4. fix points whose coordinate sum is off the hyperplane
    for (int i = 0; i <= d; ++i) {
      rank[i] += sum;
      if (rank[i] < 0) {
        rank[i] += d + 1;
        rem0[i] += d + 1;
      } else if (rank[i] > d) {
        rank[i] -= d + 1;
        rem0[i] -= d + 1;
      }
    }

    // 5. barycentric coordinates of the simplex
    std::fill(barycentric.begin(), barycentric.end(), 0.f);
    for (int i = 0; i <= d; ++i) {
      float delta = (elevated[i] - rem0[i]) * down;
      barycentric[d - rank[i]] += delta;
      barycentric[d + 1 - rank[i]] -= delta;
    }
    barycentric[0] += 1.0f + barycentric[d + 1];

    // 6. register the d+1 simplex vertices in the lattice hash
    for (int remainder = 0; remainder <= d; ++remainder) {
      for (int i = 0; i < d; ++i) {
        float v = rem0[i] + remainder;
        if (rank[i] > d - remainder) v -= (d + 1);
        key[i] = static_cast<int16_t>(v);
      }
      const int32_t next = static_cast<int32_t>(keys.size() / d);
      const int32_t id =
          table.lookup(pack_key(key.data(), d), next, /*insert=*/true);
      if (id == next) keys.insert(keys.end(), key.begin(), key.end());
      offset_[static_cast<size_t>(n) * (d + 1) + remainder] = id;
      barycentric_[static_cast<size_t>(n) * (d + 1) + remainder] =
          barycentric[remainder];
    }
  }

  M_ = static_cast<int>(keys.size() / d);

  // 7. blur neighbours per axis: along axis j a key's neighbours are
  // key -/+ 1 in every coordinate except +/- d at coordinate j
  blur_neighbors_.assign(static_cast<size_t>(d + 1) * M_ * 2, M_);
  std::vector<int16_t> n1(d), n2(d);
  for (int j = 0; j <= d; ++j) {
    for (int i = 0; i < M_; ++i) {
      const int16_t* k = keys.data() + static_cast<size_t>(i) * d;
      for (int c = 0; c < d; ++c) {
        n1[c] = static_cast<int16_t>(k[c] - 1);
        n2[c] = static_cast<int16_t>(k[c] + 1);
      }
      if (j < d) {
        n1[j] = static_cast<int16_t>(k[j] + d);
        n2[j] = static_cast<int16_t>(k[j] - d);
      }
      const int32_t i1 = table.lookup(pack_key(n1.data(), d), -1, false);
      const int32_t i2 = table.lookup(pack_key(n2.data(), d), -1, false);
      blur_neighbors_[(static_cast<size_t>(j) * M_ + i) * 2 + 0] =
          (i1 >= 0) ? i1 : M_;
      blur_neighbors_[(static_cast<size_t>(j) * M_ + i) * 2 + 1] =
          (i2 >= 0) ? i2 : M_;
    }
  }
}

void Permutohedral::compute(float* out, const float* in, int C) const {
  // values for M_ lattice points + one zero slot for missing neighbours
  std::vector<float> values(static_cast<size_t>(M_ + 1) * C, 0.f);
  std::vector<float> new_values(static_cast<size_t>(M_ + 1) * C, 0.f);

  // splat
  for (int n = 0; n < N_; ++n) {
    for (int r = 0; r <= d_; ++r) {
      int32_t o = offset_[static_cast<size_t>(n) * (d_ + 1) + r];
      float w = barycentric_[static_cast<size_t>(n) * (d_ + 1) + r];
      float* dst = values.data() + static_cast<size_t>(o) * C;
      const float* src = in + static_cast<size_t>(n) * C;
      for (int c = 0; c < C; ++c) dst[c] += w * src[c];
    }
  }

  // blur along each lattice axis with the [1, 2, 1] kernel
  for (int j = 0; j <= d_; ++j) {
    for (int i = 0; i < M_; ++i) {
      const int32_t b1 =
          blur_neighbors_[(static_cast<size_t>(j) * M_ + i) * 2 + 0];
      const int32_t b2 =
          blur_neighbors_[(static_cast<size_t>(j) * M_ + i) * 2 + 1];
      const float* v0 = values.data() + static_cast<size_t>(i) * C;
      const float* v1 = values.data() + static_cast<size_t>(b1) * C;
      const float* v2 = values.data() + static_cast<size_t>(b2) * C;
      float* dst = new_values.data() + static_cast<size_t>(i) * C;
      for (int c = 0; c < C; ++c) dst[c] = v0[c] + 0.5f * (v1[c] + v2[c]);
    }
    std::swap(values, new_values);
  }

  // slice (alpha corrects the blur gain: 1 / (1 + 2^-d))
  const float alpha = 1.0f / (1.0f + std::pow(2.0f, -d_));
  std::memset(out, 0, static_cast<size_t>(N_) * C * sizeof(float));
  for (int n = 0; n < N_; ++n) {
    float* dst = out + static_cast<size_t>(n) * C;
    for (int r = 0; r <= d_; ++r) {
      int32_t o = offset_[static_cast<size_t>(n) * (d_ + 1) + r];
      float w = barycentric_[static_cast<size_t>(n) * (d_ + 1) + r];
      const float* src = values.data() + static_cast<size_t>(o) * C;
      for (int c = 0; c < C; ++c) dst[c] += alpha * w * src[c];
    }
  }
}

void filter_normalised(const Permutohedral& lat, int N, int C,
                       const std::vector<float>& norm, const float* in,
                       float* out, std::vector<float>& tmp) {
  // out = norm * K(norm * in)   (symmetric normalisation)
  tmp.resize(static_cast<size_t>(N) * C);
  for (int n = 0; n < N; ++n)
    for (int c = 0; c < C; ++c)
      tmp[static_cast<size_t>(n) * C + c] =
          in[static_cast<size_t>(n) * C + c] * norm[n];
  lat.compute(out, tmp.data(), C);
  for (int n = 0; n < N; ++n)
    for (int c = 0; c < C; ++c) out[static_cast<size_t>(n) * C + c] *= norm[n];
}

std::vector<float> kernel_norm(const Permutohedral& lat, int N) {
  std::vector<float> ones(N, 1.f), n(N);
  lat.compute(n.data(), ones.data(), 1);
  for (int i = 0; i < N; ++i) n[i] = 1.0f / std::sqrt(std::max(n[i], 1e-20f));
  return n;
}

}  // namespace

extern "C" {

// Dense-CRF mean field: img H*W*3 uint8 RGB, probs H*W*C float32 (HWC),
// result into out; unary -log(p), Gaussian (sxy, compat) + bilateral
// (sxy, srgb, compat) Potts pairwise with symmetric normalisation, t
// iterations.  Returns 0.
int wseg_densecrf_inference(const uint8_t* img, int H, int W, int C,
                            const float* probs, float* out, int t,
                            float sxy_gaussian, float compat_gaussian,
                            float sxy_bilateral, float srgb,
                            float compat_bilateral) {
  const int N = H * W;
  std::vector<float> feat_g(static_cast<size_t>(N) * 2);
  std::vector<float> feat_b(static_cast<size_t>(N) * 5);
  for (int y = 0; y < H; ++y) {
    for (int x = 0; x < W; ++x) {
      const int n = y * W + x;
      feat_g[n * 2 + 0] = x / sxy_gaussian;
      feat_g[n * 2 + 1] = y / sxy_gaussian;
      feat_b[n * 5 + 0] = x / sxy_bilateral;
      feat_b[n * 5 + 1] = y / sxy_bilateral;
      feat_b[n * 5 + 2] = img[n * 3 + 0] / srgb;
      feat_b[n * 5 + 3] = img[n * 3 + 1] / srgb;
      feat_b[n * 5 + 4] = img[n * 3 + 2] / srgb;
    }
  }

  Permutohedral lat_g, lat_b;
  lat_g.init(feat_g.data(), 2, N);
  lat_b.init(feat_b.data(), 5, N);
  std::vector<float> norm_g = kernel_norm(lat_g, N);
  std::vector<float> norm_b = kernel_norm(lat_b, N);

  std::vector<float> unary(static_cast<size_t>(N) * C);
  for (size_t i = 0; i < unary.size(); ++i)
    unary[i] = -std::log(std::max(probs[i], 1e-8f));

  std::vector<float> Q(probs, probs + static_cast<size_t>(N) * C);
  std::vector<float> msg_g(static_cast<size_t>(N) * C);
  std::vector<float> msg_b(static_cast<size_t>(N) * C);
  std::vector<float> tmp;

  for (int it = 0; it < t; ++it) {
    filter_normalised(lat_g, N, C, norm_g, Q.data(), msg_g.data(), tmp);
    filter_normalised(lat_b, N, C, norm_b, Q.data(), msg_b.data(), tmp);
    // Potts update + softmax, self term included
    for (int n = 0; n < N; ++n) {
      float mx = -1e30f;
      float* q = Q.data() + static_cast<size_t>(n) * C;
      const float* u = unary.data() + static_cast<size_t>(n) * C;
      const float* mg = msg_g.data() + static_cast<size_t>(n) * C;
      const float* mb = msg_b.data() + static_cast<size_t>(n) * C;
      for (int c = 0; c < C; ++c) {
        q[c] = -u[c] + compat_gaussian * mg[c] + compat_bilateral * mb[c];
        mx = std::max(mx, q[c]);
      }
      float s = 0.f;
      for (int c = 0; c < C; ++c) {
        q[c] = std::exp(q[c] - mx);
        s += q[c];
      }
      for (int c = 0; c < C; ++c) q[c] /= s;
    }
  }

  std::copy(Q.begin(), Q.end(), out);
  return 0;
}

// Lattice tables for the device filter.  build returns a handle and M;
// export copies the tables into caller buffers sized from M; free
// releases the handle.
void* wseg_permutohedral_build(const float* features, int d, int N,
                               int* M_out) {
  auto* lat = new Permutohedral();
  lat->init(features, d, N);
  *M_out = lat->M_;
  return lat;
}

// offsets: N*(d+1) int32, barycentric: N*(d+1) float,
// blur_neighbors: (d+1)*M*2 int32 (a missing neighbour is M).
int wseg_permutohedral_export(void* handle, int32_t* offsets,
                              float* barycentric, int32_t* blur_neighbors) {
  auto* lat = static_cast<Permutohedral*>(handle);
  std::copy(lat->offset_.begin(), lat->offset_.end(), offsets);
  std::copy(lat->barycentric_.begin(), lat->barycentric_.end(), barycentric);
  std::copy(lat->blur_neighbors_.begin(), lat->blur_neighbors_.end(),
            blur_neighbors);
  return 0;
}

// The splat table transposed to vertex-major order (CSR), by a counting
// sort: row_ptr (M+1) int32; entries (N*(d+1)) int32, each
// pixel*(d+1)+slot, ascending within a row; weights (N*(d+1)) float, the
// barycentric weight of each entry.  pixel_of_row (N) int32 maps feature
// row n to its pixel (for a window embedded in a larger canvas) and must
// be increasing; NULL means pixel n = row n.
int wseg_permutohedral_export_csr(void* handle, const int32_t* pixel_of_row,
                                  int32_t* row_ptr, int32_t* entries,
                                  float* weights) {
  auto* lat = static_cast<Permutohedral*>(handle);
  const int d1 = lat->d_ + 1;
  const size_t E = static_cast<size_t>(lat->N_) * d1;
  std::fill(row_ptr, row_ptr + lat->M_ + 1, 0);
  for (size_t e = 0; e < E; ++e) ++row_ptr[lat->offset_[e] + 1];
  for (int v = 0; v < lat->M_; ++v) row_ptr[v + 1] += row_ptr[v];
  std::vector<int32_t> fill(row_ptr, row_ptr + lat->M_);
  for (int n = 0; n < lat->N_; ++n) {
    const int32_t pix = pixel_of_row ? pixel_of_row[n] : n;
    for (int r = 0; r < d1; ++r) {
      const size_t e = static_cast<size_t>(n) * d1 + r;
      const int32_t k = fill[lat->offset_[e]]++;
      entries[k] = pix * d1 + r;
      weights[k] = lat->barycentric_[e];
    }
  }
  return 0;
}

void wseg_permutohedral_free(void* handle) {
  delete static_cast<Permutohedral*>(handle);
}

// Raw lattice filter: features N x d, values N x C -> out N x C.
int wseg_permutohedral_filter(const float* features, int d, int N,
                              const float* values, int C, float* out) {
  Permutohedral lat;
  lat.init(features, d, N);
  lat.compute(out, values, C);
  return 0;
}

}  // extern "C"

// Exact permutohedral lattice filter on Hopper (sm_90a), plain C
// interface: the four steps of one filter application of the exact
// dense CRF, float32 throughout.
//
//   lattice_weights  wn = w * norm[pixel], pixel-major and vertex-major
//   lattice_splat    lat[v, c] = sum_{e in row v} wn[e] * q[pix(e), c]
//   lattice_blur     out[v] = lat[v] + (lat[n1(v)] + lat[n2(v)]) / 2
//   lattice_slice    out[p, c] = alpha * sum_s wn[p, s] * lat[ids[p, s], c]
//
// Replaces the TPU kernels of wseg_tpu/ops/crf_mm.py: _ohgen_call
// (lattice_weights), _splat_call (lattice_splat) and _gather_call
// (lattice_blur and lattice_slice).  On the TPU, gather and scatter cost
// 4-17 ns per row, so crf_mm.py writes the filter as block matmuls
// against dense multi-hot planes (the splat/slice matrix S with the
// symmetric norm folded in, and one 3-hot matrix per blur axis), in bf16
// planes that emulate f32 on the MXU.  On Hopper a gather is cheap, so
// the same linear operators run directly over the sparse tables:
//
// * the splat/slice matrix S stays sparse: the (ids, w) table pixel-
//   major, (Np, d+1), for the slice, and its transpose vertex-major
//   (CSR: row_ptr (m+1), entries pixel*(d+1)+slot, weights) for the
//   splat, built on the host by a counting sort (csrc/
//   permutohedral_host.cc).  lattice_weights folds the norm into both,
//   once per image and lattice: S' = S diag(norm), so each filter is
//   S'^T B S' q with no per-pixel multiplies (crf_mm.py scale_oh);
// * the splat is a deterministic gather, one warp per lattice vertex
//   walking its CSR row in order (no float atomics): the lanes split
//   the channels (C=21: one lane each) or, for few channels (the norm
//   filter has C=1), the row's entries, summed by a fixed shuffle tree;
// * the blur reads the two neighbours of each vertex by index, from one
//   buffer into another (the caller double-buffers across the d+1
//   axes), and rewrites the zero slot (row m, where missing neighbours
//   and padded pixels point) as zero;
// * the slice gathers the d+1 vertex rows of each pixel.
//
// What bounds them: bytes.  Every step does 1-2 FLOP per float it
// moves.  At the flagship (384x512 canvas, 21 classes, bilateral d=5)
// a splat reads the 16.5 MB of q plus 9 MB of CSR and writes m x 84 B
// of lattice; a slice reads the lattice and 9.4 MB of tables and writes
// 16.5 MB.  The lattice rows a gather reads are 84 B each, mostly from
// L2 (the whole lattice is a few MB).  The splat's rows are skewed
// (flat colour maps thousands of pixels onto one vertex): one warp per
// vertex leaves such rows on one SM; the loop is unrolled 4 ways so
// their loads overlap.
//
// All tensors are contiguous; ids/entries/row_ptr/nbr are int32, the
// rest float32.  Each entry point launches on the caller's stream,
// allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;
constexpr int kWarpsPerBlock = kBlock / 32;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kBlock)
lattice_weights_kernel(const float* __restrict__ w_pix,
                       const float* __restrict__ w_csr,
                       const int* __restrict__ entries,
                       const float* __restrict__ norm,
                       long long n_pix_entries, long long n_csr, int d1,
                       float* __restrict__ wn_pix,
                       float* __restrict__ wn_csr) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i < n_pix_entries) {
    wn_pix[i] = w_pix[i] * norm[i / d1];
  } else if (i < n_pix_entries + n_csr) {
    const long long e = i - n_pix_entries;
    wn_csr[e] = w_csr[e] * norm[entries[e] / d1];
  }
}

// One warp per vertex v in [0, m]; v == m is the zero slot.  Lane =
// group * cp + channel, cp = 2^cp_log2 >= C, 32 / cp groups stride the
// row's entries.
__global__ void __launch_bounds__(kBlock)
lattice_splat_kernel(const int* __restrict__ row_ptr,
                     const int* __restrict__ entries,
                     const float* __restrict__ w_csr,
                     const float* __restrict__ q, int m, int C, int d1,
                     int cp_log2, float* __restrict__ lat) {
  const int v = blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  if (v > m) return;  // whole warps exit together
  const int lane = threadIdx.x & 31;
  const int cp = 1 << cp_log2;
  const int c = lane & (cp - 1);
  const int g = lane >> cp_log2;
  const int G = 32 >> cp_log2;
  const bool live = c < C;
  float acc = 0.0f;
  if (v < m) {
    const int end = row_ptr[v + 1];
    int e = row_ptr[v] + g;
    for (; e + 3 * G < end; e += 4 * G) {
      const int p0 = entries[e] / d1, p1 = entries[e + G] / d1;
      const int p2 = entries[e + 2 * G] / d1, p3 = entries[e + 3 * G] / d1;
      const float w0 = w_csr[e], w1 = w_csr[e + G];
      const float w2 = w_csr[e + 2 * G], w3 = w_csr[e + 3 * G];
      if (live) {
        const float q0 = __ldg(q + static_cast<size_t>(p0) * C + c);
        const float q1 = __ldg(q + static_cast<size_t>(p1) * C + c);
        const float q2 = __ldg(q + static_cast<size_t>(p2) * C + c);
        const float q3 = __ldg(q + static_cast<size_t>(p3) * C + c);
        acc += w0 * q0;
        acc += w1 * q1;
        acc += w2 * q2;
        acc += w3 * q3;
      }
    }
    for (; e < end; e += G) {
      const int p = entries[e] / d1;
      if (live) acc += w_csr[e] * __ldg(q + static_cast<size_t>(p) * C + c);
    }
  }
  for (int off = cp; off < 32; off <<= 1)
    acc += __shfl_xor_sync(kFull, acc, off);
  if (g == 0 && live) lat[static_cast<size_t>(v) * C + c] = acc;
}

__global__ void __launch_bounds__(kBlock)
lattice_blur_kernel(const float* __restrict__ lat,
                    const int* __restrict__ nbr, int m, int C,
                    float* __restrict__ out) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= static_cast<long long>(m + 1) * C) return;
  const int v = static_cast<int>(i / C);
  const int c = static_cast<int>(i - static_cast<long long>(v) * C);
  if (v == m) {
    out[i] = 0.0f;
    return;
  }
  const int n1 = nbr[2 * static_cast<size_t>(v)];
  const int n2 = nbr[2 * static_cast<size_t>(v) + 1];
  out[i] = lat[i] + 0.5f * (lat[static_cast<size_t>(n1) * C + c] +
                            lat[static_cast<size_t>(n2) * C + c]);
}

__global__ void __launch_bounds__(kBlock)
lattice_slice_kernel(const float* __restrict__ lat,
                     const int* __restrict__ ids,
                     const float* __restrict__ wn, int n_pix, int C, int d1,
                     float alpha, float* __restrict__ out) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= static_cast<long long>(n_pix) * C) return;
  const int p = static_cast<int>(i / C);
  const int c = static_cast<int>(i - static_cast<long long>(p) * C);
  const int* ip = ids + static_cast<size_t>(p) * d1;
  const float* wp = wn + static_cast<size_t>(p) * d1;
  float acc = 0.0f;
  for (int s = 0; s < d1; ++s)
    acc += wp[s] * __ldg(lat + static_cast<size_t>(ip[s]) * C + c);
  out[i] = alpha * acc;
}

unsigned blocks_for(long long n) {
  return static_cast<unsigned>((n + kBlock - 1) / kBlock);
}

constexpr long long kMaxBlocks = 2147483647LL;

}  // namespace

extern "C" int wseg_lattice_weights(const void* w_pix, const void* w_csr,
                                    const void* entries, const void* norm,
                                    long long n_pix_entries, long long n_csr,
                                    int d1, void* wn_pix, void* wn_csr,
                                    void* stream) {
  const long long n = n_pix_entries + n_csr;
  if (n_pix_entries < 0 || n_csr < 0 || d1 <= 0 ||
      (n + kBlock - 1) / kBlock > kMaxBlocks) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  lattice_weights_kernel<<<blocks_for(n), kBlock, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w_pix), static_cast<const float*>(w_csr),
      static_cast<const int*>(entries), static_cast<const float*>(norm),
      n_pix_entries, n_csr, d1, static_cast<float*>(wn_pix),
      static_cast<float*>(wn_csr));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int wseg_lattice_splat(const void* row_ptr, const void* entries,
                                  const void* w_csr, const void* q, int m,
                                  int C, int d1, void* lat, void* stream) {
  if (m < 0 || C <= 0 || C > 32 || d1 <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int cp_log2 = 0;
  while ((1 << cp_log2) < C) ++cp_log2;
  const unsigned grid = (m + kWarpsPerBlock) / kWarpsPerBlock;  // m+1 warps
  lattice_splat_kernel<<<grid, kBlock, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(row_ptr), static_cast<const int*>(entries),
      static_cast<const float*>(w_csr), static_cast<const float*>(q), m, C,
      d1, cp_log2, static_cast<float*>(lat));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int wseg_lattice_blur(const void* lat, const void* nbr, int m,
                                 int C, void* out, void* stream) {
  if (m < 0 || C <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long n = static_cast<long long>(m + 1) * C;
  if ((n + kBlock - 1) / kBlock > kMaxBlocks) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  lattice_blur_kernel<<<blocks_for(n), kBlock, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lat), static_cast<const int*>(nbr), m, C,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int wseg_lattice_slice(const void* lat, const void* ids,
                                  const void* wn, int n_pix, int C, int d1,
                                  float alpha, void* out, void* stream) {
  const long long n = static_cast<long long>(n_pix) * C;
  if (n_pix < 0 || C <= 0 || d1 <= 0 ||
      (n + kBlock - 1) / kBlock > kMaxBlocks) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  lattice_slice_kernel<<<blocks_for(n), kBlock, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lat), static_cast<const int*>(ids),
      static_cast<const float*>(wn), n_pix, C, d1, alpha,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// Dense-CRF Gaussian blur on Hopper (sm_90a), plain C interface.
//
//   out = correlate1d(correlate1d(x, k, axis=H), k, axis=W)
//
// with zero fill outside the plane, over 2r+1 taps k, on every (b, c)
// plane of a channels-major (B, C, H, W) float32 tensor.
//
// Replaces the TPU kernel wseg_tpu/ops/crf_pallas.py::
// gauss_blur_pallas_cm (_gauss_kernel).  That kernel reads a zero-padded
// copy of the input and rolls it through VMEM once per tap and axis,
// because Mosaic shifts only by rotating whole vregs.  Here one thread
// block owns one 32x32 output tile of one plane: it loads the tile and
// its r-halo into shared memory (zeros outside the plane, so no padded
// copy is ever made), runs the H pass into a second shared buffer of
// 32 x (32 + 2r) and the W pass from there into the output.  Taps come
// by value as kernel arguments; nothing is uploaded per call.
//
// What bounds it: bytes.  The compulsory traffic is one read and one
// write of the tensor: at (8, 21, 384, 512), r = 6, 2 x 132.1 MB =
// 264 MB, 79 us at 3.35 TB/s, against 2 passes x 13 taps x 2 ops x 33M
// pixels = 1.72 GFLOP = 26 us at the 67 TFLOP/s float32 peak; at
// (8, 21, 192, 256), r = 3, 66 MB = 20 us.  The design reads each input
// element from device memory once per tile that covers it (the halo
// re-reads, (32 + 2r)^2 / 32^2 = 1.9x at r = 6, hit L2 because
// neighbouring tiles run together) and writes each output once, against
// 2 (2r + 1) reads and writes of the tensor for the slice-sum it
// replaces.  Planes smaller than their halo (H or W < 2r + 1) and C = 1
// need nothing special: every load is bounds-checked.
//
// Launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;            // output tile, kTile x kTile
constexpr int kMaxR = 16;            // largest radius (33 taps)
constexpr int kThreads = 256;
constexpr int kMaxSpan = kTile + 2 * kMaxR;

struct Taps {
  float k[2 * kMaxR + 1];
};

__global__ void __launch_bounds__(kThreads)
gauss_blur_kernel(const float* __restrict__ x, float* __restrict__ out,
                  Taps taps, int r, int H, int W, int tiles_x,
                  int tiles_y) {
  __shared__ float s_in[kMaxSpan * kMaxSpan];  // (32 + 2r)^2 used
  __shared__ float s_h[kTile * kMaxSpan];      // 32 x (32 + 2r) used
  __shared__ float s_k[2 * kMaxR + 1];

  const int tile = blockIdx.x;
  const int tx0 = (tile % tiles_x) * kTile;
  const int ty0 = ((tile / tiles_x) % tiles_y) * kTile;
  const size_t plane = static_cast<size_t>(tile / tiles_x / tiles_y);
  const size_t hw = static_cast<size_t>(H) * W;
  const float* src = x + plane * hw;
  const int span = kTile + 2 * r;  // both the halo rows and columns
  const int n_taps = 2 * r + 1;

  if (threadIdx.x < 2 * kMaxR + 1) s_k[threadIdx.x] = taps.k[threadIdx.x];
  // tile + halo, zero outside the plane
  for (int i = threadIdx.x; i < span * span; i += kThreads) {
    const int yy = ty0 - r + i / span;
    const int xx = tx0 - r + i % span;
    s_in[i] = (yy >= 0 && yy < H && xx >= 0 && xx < W)
                  ? __ldg(src + static_cast<size_t>(yy) * W + xx)
                  : 0.0f;
  }
  __syncthreads();

  // H pass: rows of the tile, every column of the halo
  for (int i = threadIdx.x; i < kTile * span; i += kThreads) {
    const int ty = i / span;
    const int tx = i % span;
    float acc = 0.0f;
    for (int k = 0; k < n_taps; ++k) acc += s_k[k] * s_in[(ty + k) * span + tx];
    s_h[ty * span + tx] = acc;
  }
  __syncthreads();

  // W pass into the output
  float* dst = out + plane * hw;
  for (int i = threadIdx.x; i < kTile * kTile; i += kThreads) {
    const int ty = i / kTile;
    const int tx = i % kTile;
    const int y = ty0 + ty;
    const int xo = tx0 + tx;
    if (y >= H || xo >= W) continue;
    float acc = 0.0f;
    for (int k = 0; k < n_taps; ++k) acc += s_k[k] * s_h[ty * span + tx + k];
    dst[static_cast<size_t>(y) * W + xo] = acc;
  }
}

}  // namespace

extern "C" int wseg_crf_gauss_max_radius() { return kMaxR; }

extern "C" int wseg_crf_gauss_blur(const void* x, void* out,
                                   const float* k1d, int r, int planes,
                                   int H, int W, void* stream) {
  if (r < 0 || r > kMaxR || planes <= 0 || H <= 0 || W <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Taps taps;
  for (int k = 0; k < 2 * kMaxR + 1; ++k) taps.k[k] = k <= 2 * r ? k1d[k] : 0.0f;
  const int tiles_x = (W + kTile - 1) / kTile;
  const int tiles_y = (H + kTile - 1) / kTile;
  const long long blocks = static_cast<long long>(tiles_x) * tiles_y * planes;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  gauss_blur_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), taps, r, H, W,
      tiles_x, tiles_y);
  return static_cast<int>(cudaGetLastError());
}

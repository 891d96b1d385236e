// Dense-CRF bilateral message on Hopper (sm_90a), plain C interface.
//
//   out[b, c](y, x) = sum_k w[b, k](y, x) * q[b, c](y + dy_k, x + dx_k)
//
// with zero fill outside the image, over T displacement taps.
//
// Replaces the TPU kernel wseg_tpu/ops/crf_pallas.py::
// bilateral_message_pallas_cm (_bilateral_kernel).  That kernel rolls a
// zero-padded copy of q through VMEM, grouped by column offset, because
// Mosaic can only rotate whole lanes.  Here it is a plain gather: one
// thread per output pixel (b, y, x) walks the tap table, loads its bf16
// weight once per tap, and accumulates the C channels of q at the
// displaced pixel into registers.  A bounds check replaces the padded
// copy, so q is never copied.
//
// What bounds it: bytes.  At the flagship (S=8 slots, C=21, 192x256,
// T=80) one call reads 33 MB of q (f32) and 63 MB of weights (bf16)
// and writes 33 MB, for ~1.3 GFLOP, far below the card's FLOP/byte
// balance.  Weights and outputs stream once, coalesced along x.  Each q
// value is re-read by up to T taps; a block covers one row segment of
// one slot, so the taps' rows (within +-pad of it) are shared by the
// neighbouring blocks in flight and are served from L1/L2, not HBM.
//
// q is float32 (the CRF applies its message dtype before the call),
// w is bfloat16, out is float32, all contiguous (B, ., H, W).  The tap
// table is int32 (T, 2) = (dy, dx) in device memory.  Launches on the
// caller's stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxC = 32;      // channels held in registers per thread
constexpr int kMaxTaps = 1024; // tap table staged in shared memory
constexpr int kBlock = 128;    // threads per block, along x

__global__ void __launch_bounds__(kBlock)
bilateral_message_kernel(const float* __restrict__ q,
                         const __nv_bfloat16* __restrict__ w,
                         const int* __restrict__ taps,
                         float* __restrict__ out,
                         int C, int T, int H, int W) {
  __shared__ int s_dy[kMaxTaps];
  __shared__ int s_dx[kMaxTaps];
  for (int k = threadIdx.x; k < T; k += blockDim.x) {
    s_dy[k] = taps[2 * k];
    s_dx[k] = taps[2 * k + 1];
  }
  __syncthreads();

  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  const int b = blockIdx.z;
  if (x >= W) return;

  const size_t hw = static_cast<size_t>(H) * W;
  const float* qb = q + static_cast<size_t>(b) * C * hw;
  const __nv_bfloat16* wp =
      w + static_cast<size_t>(b) * T * hw + static_cast<size_t>(y) * W + x;

  float acc[kMaxC];
#pragma unroll
  for (int c = 0; c < kMaxC; ++c) acc[c] = 0.0f;

  for (int k = 0; k < T; ++k) {
    const int yy = y + s_dy[k];
    const int xx = x + s_dx[k];
    if (yy < 0 || yy >= H || xx < 0 || xx >= W) continue;
    const float wk = __bfloat162float(wp[static_cast<size_t>(k) * hw]);
    const float* qp = qb + static_cast<size_t>(yy) * W + xx;
#pragma unroll
    for (int c = 0; c < kMaxC; ++c) {
      if (c < C) acc[c] += wk * __ldg(qp + static_cast<size_t>(c) * hw);
    }
  }

  float* op = out + static_cast<size_t>(b) * C * hw +
              static_cast<size_t>(y) * W + x;
#pragma unroll
  for (int c = 0; c < kMaxC; ++c) {
    if (c < C) op[static_cast<size_t>(c) * hw] = acc[c];
  }
}

}  // namespace

extern "C" int wseg_crf_bilateral_max_channels() { return kMaxC; }
extern "C" int wseg_crf_bilateral_max_taps() { return kMaxTaps; }

extern "C" int wseg_crf_bilateral_message(const void* q, const void* w,
                                          const void* taps, void* out,
                                          int B, int C, int T, int H, int W,
                                          void* stream) {
  if (B <= 0 || C <= 0 || C > kMaxC || T <= 0 || T > kMaxTaps ||
      H <= 0 || H > 65535 || W <= 0 || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((W + kBlock - 1) / kBlock, H, B);
  bilateral_message_kernel<<<grid, kBlock, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const __nv_bfloat16*>(w),
      static_cast<const int*>(taps), static_cast<float*>(out), C, T, H, W);
  return static_cast<int>(cudaGetLastError());
}

// PAMR (pixel-adaptive mask refinement) on Hopper (sm_90a), plain C
// interface: the affinity kernel and the propagation kernel.  Forward
// only: PAMR runs on stop-gradient masks (the model detaches its input),
// and the TPU kernels have no backward either.
//
// Taps: for each dilation d, the 8 neighbours (dy, dx) * d in row-major
// 3x3 order with the centre left out (wseg_tpu/ops/pamr.py _OFFSETS), so
// T = 8 * D taps.  Edge replication equals clamping the coordinates,
// since every offset is at most pad = max(dilations).
//
// 1. pamr_affinity_kernel replaces wseg_tpu/ops/pamr_pallas.py::
//    pamr_affinity_pallas (_affinity_kernel).  The TPU kernel rolls an
//    edge-padded copy of the guide through VMEM twice per tap (Mosaic
//    rotates whole lanes).  Here one thread owns one output pixel
//    (b, y, x): it reads the 3 guide channels at the 9 * D clamped taps
//    (centre once per dilation), keeps per-channel sums in registers,
//    takes sigma per channel with the two-pass Bessel-corrected variance
//    of the lax path (wseg_tpu/ops/pamr.py:82-85, not the Pallas
//    kernel's one-pass form), forms the T logits
//    -mean_K |c - n| / (1e-8 + 0.1 sigma) in registers and softmaxes
//    them there.  Output is channels-major (B, T, H, W), the layout the
//    propagation kernel reads.
//    What bounds it: latency.  At the flagship (B=8, 48x48, D=6) it
//    reads 0.22 MB and writes 3.5 MB, about 1 us of HBM time; the
//    guide's re-reads (3 passes x 54 taps) hit L1.  18,432 threads
//    are 144 blocks, about one per SM.
//
// 2. pamr_propagate_kernel replaces pamr_pallas.py::
//    pamr_propagate_pallas (_propagate_kernel): num_iter Jacobi steps
//    m <- sum_t aff_t * shift_t(m), all in ONE launch.  One block per
//    (batch, channel) plane keeps the plane in shared memory, double-
//    buffered (2 * H * W * 4 bytes: 18 KB at 48x48), and iterates with
//    __syncthreads(); clamped indexing replaces the TPU kernel's
//    re-padded copy.  It reads aff from global memory each iteration:
//    the whole of it (3.5 MB at the flagship) stays in the 50 MB L2.
//    This is the "(batch, channel) grid with the plane in shared memory"
//    of the roadmap.  Of the TPU designs in tools/bench_pamr.py it is
//    closest to propagate_fold (B8: one plane per grid step, all
//    iterations in-kernel); the dx-first grouping (B9) and the
//    shifts-as-selector-matmuls form (B10) answer Mosaic's costly lane
//    rotates, which a gather from shared memory does not have.
//    What bounds it: at the flagship 8*21*48*48*48*10 = 186 M
//    multiply-adds against 6.6 MB of compulsory traffic, i.e. neither
//    HBM nor the FMA rate: the aff re-reads from L2 (0.74 GB per call)
//    and the 168-block grid (about one wave on 132 SMs) bound it.
//    Planes above the shared-memory limit (~170^2) are refused; the
//    wrapper raises with the limit.
//
// All tensors float32, contiguous, channels-major.  Each launcher runs
// on the caller's stream, allocates nothing and returns
// cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kMaxDil = 8;              // dilations per call
constexpr int kMaxTaps = 8 * kMaxDil;   // 64 taps
constexpr int kK = 3;                   // guide channels (RGB)
constexpr int kAffBlock = 128;          // threads per block, along x
constexpr int kPropBlock = 256;         // threads per (b, c) plane

struct Dilations {
  int n;
  int d[kMaxDil];
};

__device__ __forceinline__ int clampi(int v, int hi) {
  return v < 0 ? 0 : (v > hi ? hi : v);
}

// neighbour j (0..7) of the 3x3 row-major scan without its centre
__device__ __forceinline__ int off_y(int j) { return (j < 4 ? j : j + 1) / 3 - 1; }
__device__ __forceinline__ int off_x(int j) { return (j < 4 ? j : j + 1) % 3 - 1; }

__global__ void __launch_bounds__(kAffBlock)
pamr_affinity_kernel(const float* __restrict__ im, float* __restrict__ aff,
                     Dilations dil, int H, int W) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  const int b = blockIdx.z;
  if (x >= W) return;

  const size_t hw = static_cast<size_t>(H) * W;
  const float* img = im + static_cast<size_t>(b) * kK * hw;
  const int T = 8 * dil.n;
  const float n9 = 9.0f * dil.n;

  float c[kK];
#pragma unroll
  for (int k = 0; k < kK; ++k) c[k] = img[k * hw + static_cast<size_t>(y) * W + x];

  // pass 1: per-channel mean over the 9 * D taps
  float s[kK] = {0.0f, 0.0f, 0.0f};
  for (int i = 0; i < dil.n; ++i) {
    const int d = dil.d[i];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const size_t p = static_cast<size_t>(clampi(y + off_y(j) * d, H - 1)) * W +
                       clampi(x + off_x(j) * d, W - 1);
#pragma unroll
      for (int k = 0; k < kK; ++k) s[k] += __ldg(img + k * hw + p);
    }
#pragma unroll
    for (int k = 0; k < kK; ++k) s[k] += c[k];
  }
  float mean[kK];
#pragma unroll
  for (int k = 0; k < kK; ++k) mean[k] = s[k] / n9;

  // pass 2: Bessel-corrected variance about that mean
  float q[kK] = {0.0f, 0.0f, 0.0f};
  for (int i = 0; i < dil.n; ++i) {
    const int d = dil.d[i];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const size_t p = static_cast<size_t>(clampi(y + off_y(j) * d, H - 1)) * W +
                       clampi(x + off_x(j) * d, W - 1);
#pragma unroll
      for (int k = 0; k < kK; ++k) {
        const float e = __ldg(img + k * hw + p) - mean[k];
        q[k] += e * e;
      }
    }
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      const float e = c[k] - mean[k];
      q[k] += e * e;
    }
  }
  float den[kK];
#pragma unroll
  for (int k = 0; k < kK; ++k) den[k] = 1e-8f + 0.1f * sqrtf(q[k] / (n9 - 1.0f));

  // logits, then the softmax over the T taps, all in registers
  float logit[kMaxTaps];
  float mx = __int_as_float(0xff800000);  // -inf
#pragma unroll
  for (int t = 0; t < kMaxTaps; ++t) {
    if (t < T) {
      const int d = dil.d[t / 8];
      const int j = t % 8;
      const size_t p = static_cast<size_t>(clampi(y + off_y(j) * d, H - 1)) * W +
                       clampi(x + off_x(j) * d, W - 1);
      float a = 0.0f;
#pragma unroll
      for (int k = 0; k < kK; ++k) a += -fabsf(c[k] - __ldg(img + k * hw + p)) / den[k];
      a = a / static_cast<float>(kK);
      logit[t] = a;
      mx = fmaxf(mx, a);
    }
  }
  float tot = 0.0f;
#pragma unroll
  for (int t = 0; t < kMaxTaps; ++t) {
    if (t < T) {
      logit[t] = expf(logit[t] - mx);
      tot += logit[t];
    }
  }
  float* out = aff + static_cast<size_t>(b) * T * hw + static_cast<size_t>(y) * W + x;
#pragma unroll
  for (int t = 0; t < kMaxTaps; ++t) {
    if (t < T) out[static_cast<size_t>(t) * hw] = logit[t] / tot;
  }
}

__global__ void __launch_bounds__(kPropBlock)
pamr_propagate_kernel(const float* __restrict__ aff,
                      const float* __restrict__ mask,
                      float* __restrict__ out, Dilations dil, int C, int H,
                      int W, int num_iter) {
  extern __shared__ float planes[];  // 2 x (H * W)
  __shared__ int s_dy[kMaxTaps];
  __shared__ int s_dx[kMaxTaps];

  const int plane = blockIdx.x;  // b * C + c
  const int b = plane / C;
  const int hw = H * W;
  const int T = 8 * dil.n;
  for (int t = threadIdx.x; t < T; t += blockDim.x) {
    s_dy[t] = off_y(t % 8) * dil.d[t / 8];
    s_dx[t] = off_x(t % 8) * dil.d[t / 8];
  }
  float* cur = planes;
  float* nxt = planes + hw;
  const float* src = mask + static_cast<size_t>(plane) * hw;
  for (int p = threadIdx.x; p < hw; p += blockDim.x) cur[p] = src[p];
  __syncthreads();

  const float* a = aff + static_cast<size_t>(b) * T * hw;
  for (int it = 0; it < num_iter; ++it) {
    for (int p = threadIdx.x; p < hw; p += blockDim.x) {
      const int y = p / W;
      const int x = p - y * W;
      float acc = 0.0f;
      for (int t = 0; t < T; ++t) {
        const int yy = clampi(y + s_dy[t], H - 1);
        const int xx = clampi(x + s_dx[t], W - 1);
        acc += __ldg(a + static_cast<size_t>(t) * hw + p) * cur[yy * W + xx];
      }
      nxt[p] = acc;
    }
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  float* dst = out + static_cast<size_t>(plane) * hw;
  for (int p = threadIdx.x; p < hw; p += blockDim.x) dst[p] = cur[p];
}

bool fill_dilations(const int* d, int n, Dilations* dil) {
  if (n <= 0 || n > kMaxDil) return false;
  dil->n = n;
  for (int i = 0; i < kMaxDil; ++i) dil->d[i] = i < n ? d[i] : 0;
  for (int i = 0; i < n; ++i) {
    if (d[i] <= 0) return false;
  }
  return true;
}

}  // namespace

extern "C" int wseg_pamr_max_dilations() { return kMaxDil; }

// largest H * W plane the propagation kernel takes on the current device
extern "C" int wseg_pamr_propagate_max_plane() {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess) {
    return 0;
  }
  const int static_bytes = 2 * kMaxTaps * static_cast<int>(sizeof(int));
  return (optin - static_bytes) / (2 * static_cast<int>(sizeof(float)));
}

extern "C" int wseg_pamr_affinity(const void* im, void* aff,
                                  const int* dilations, int n_dil, int B,
                                  int H, int W, void* stream) {
  Dilations dil;
  if (!fill_dilations(dilations, n_dil, &dil) || B <= 0 || B > 65535 ||
      H <= 0 || H > 65535 || W <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((W + kAffBlock - 1) / kAffBlock, H, B);
  pamr_affinity_kernel<<<grid, kAffBlock, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(im), static_cast<float*>(aff), dil, H, W);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int wseg_pamr_propagate(const void* aff, const void* mask,
                                   void* out, const int* dilations,
                                   int n_dil, int B, int C, int H, int W,
                                   int num_iter, void* stream) {
  Dilations dil;
  if (!fill_dilations(dilations, n_dil, &dil) || B <= 0 || C <= 0 ||
      H <= 0 || W <= 0 || num_iter < 0 ||
      static_cast<long long>(H) * W > wseg_pamr_propagate_max_plane()) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = 2 * static_cast<size_t>(H) * W * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        pamr_propagate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  pamr_propagate_kernel<<<B * C, kPropBlock, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(aff), static_cast<const float*>(mask),
      static_cast<float*>(out), dil, C, H, W, num_iter);
  return static_cast<int>(cudaGetLastError());
}

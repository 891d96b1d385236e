// Dense-CRF Gaussian blur on Hopper (sm_90a), plain C interface.
//
//   out = correlate1d(correlate1d(x * mask, k, axis=H), k, axis=W)
//
// with zero fill outside the plane, over 2r+1 taps k, on every (b, c)
// plane of a channels-major (B, C, H, W) float32 tensor.  The mask is
// optional, (B, 1, H, W) float32, broadcast over C.
//
// Replaces the TPU kernel wseg_tpu/ops/crf_pallas.py::
// gauss_blur_pallas_cm (_gauss_kernel).  That kernel reads a zero-padded
// copy of the input and rolls it through VMEM once per tap and axis,
// because Mosaic shifts only by rotating whole vregs; its caller
// multiplies by the mask in a pass of its own.
//
// What bounds it: bytes.  The compulsory traffic is one read of x, one
// of the mask and one write of out: at (8, 21, 384, 512), r = 6, 2 x
// 132.1 MB + 6.3 MB = 270 MB, 81 us at 3.35 TB/s, against 2 passes x 13
// taps x 2 ops x 33M pixels = 1.72 GFLOP = 26 us at the 67 TFLOP/s
// float32 peak.
//
// The design, a block per (plane, band of BW output columns, segment of
// SH output rows), and the cause of lost time that each part removes:
//
// - The block walks down its segment's SH + 2r input rows.  Each thread
//   owns one column of the band's span (BW + 2 R4 columns, R4 = r
//   rounded up to 4) and keeps the 2r+1 rows of its H-pass window in
//   registers, so each H tap is one FMA on registers, not a shared load
//   of the tap and one of the value.  The radius is a template argument
//   (a switch over 0..16): the taps are constant-bank operands of the
//   FMAs, and the window is a ring whose slots are static because the
//   row loop is unrolled by its length 2r+1.  No division in any tap
//   loop.
// - A group of 2r+1 H-pass rows is written over the staged input rows
//   it was computed from (each thread its own column, so in place);
//   after a barrier each thread computes 4 consecutive W-pass outputs
//   from a register window of 4 + 2r values, read as aligned 16-byte
//   shared loads (no bank conflict), and stores them with one 16-byte
//   store where W % 4 == 0.  Each thread's copy unit and W-pass quad
//   are fixed for the block, so no copy or output divides.
// - Input rows (and mask rows) reach shared memory by cp.async, 16
//   bytes a thread where W % 4 == 0, zero-filled outside the plane (no
//   bounds-checked scalar loads, no padded copy).  A ring of 3 stages
//   of 2r+1 rows keeps two groups in flight while the block computes a
//   third.  Each input element is read once from device memory, plus
//   the 2 R4 halo columns of a band and the 2r halo rows of a segment,
//   which neighbouring blocks read at about the same time (L2 hits).
// - The mask multiply happens on the H pass's read of the staged row,
//   so the caller's separate multiply (one more read and write of the
//   tensor and one more launch) is gone.  x * mask is rounded as the
//   plain version rounds it.
// - The host plan (ops/crf_gauss.py::gauss_plan) alone picks BW and SH:
//   no segment shorter than HALO_SHARE x 2r rows, and at least WAVES
//   waves at the blocks an SM that wseg_crf_gauss_occupancy reports
//   where segments that long allow it.  The entry only checks them.
//
// Sum order: the H pass first, then the W pass, each over taps in index
// order, as the plain version: they agree to FMA contraction.
//
// Launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kMaxR = 16;          // largest radius (33 taps)
constexpr int kMaxThreads = 160;   // 128-column band + 2 x 16 halo
constexpr int kStages = 3;         // input row groups in the ring
constexpr int kMaxSmem = 232448;   // dynamic shared memory of a block

struct Taps {
  float k[2 * kMaxR + 1];
};

// The launch's geometry, chosen on the host (gauss_plan); the entry
// checks it and derives the grid.
struct Geo {
  int C, H, W;
  int bw;       // output columns of a band, 32, 64 or 128
  int sh;       // output rows of a segment
  int span;     // staged columns: bw + 2 R4
  int bands;    // ceil(W / bw)
  int segs;     // ceil(H / sh)
  int vec;      // 16-byte copies and stores (W % 4 == 0, aligned)
};

__host__ __device__ constexpr int round4(int r) { return (r + 3) / 4 * 4; }

// the kernel's blocks an SM: fewer registers for the small radii
__host__ __device__ constexpr int min_blocks(int r) {
  return r <= 8 ? 6 : 3;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;  // 0: zero fill, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// A thread's share of staging a row group, fixed for the block: the
// copy unit (16 or 4 bytes) at span column `col` of rows r0, r0 + step,
// ... (no division per copy).
struct Stager {
  int col;      // span column of the thread's copy unit
  int r0;       // first row of the group it copies, or >= rows for none
  int step;     // rows copied by the block per pass
  bool col_ok;  // the unit lies inside the plane
};

__device__ __forceinline__ Stager make_stager(const Geo& g, int xa) {
  const int unit = g.vec ? 4 : 1;
  const int units = g.span / unit;  // copy units of a row
  Stager st;
  st.step = blockDim.x / units;     // the span never exceeds the block
  st.r0 = threadIdx.x / units;
  st.col = (threadIdx.x - st.r0 * units) * unit;
  if (st.r0 >= st.step) st.r0 = 1 << 30;  // the leftover threads copy none
  const int x = xa + st.col;
  st.col_ok = x >= 0 && x < g.W;
  return st;
}

// Copy input rows i0 .. i0 + rows - 1 of the segment (input row i is
// plane row y_top + i) from `x` and, when `m` is set, from `m` into
// `dx` and `dm` (rows x span floats each), zeros outside the plane and
// past the segment's last input row `i_end`.
__device__ __forceinline__ void stage_rows(float* dx, float* dm,
                                           const float* x, const float* m,
                                           const Geo& g, const Stager& st,
                                           int rows, int i0, int i_end,
                                           int y_top, int xa) {
  for (int row = st.r0; row < rows; row += st.step) {
    const int i = i0 + row;
    const int y = y_top + i;
    const bool ok = st.col_ok && i < i_end && y >= 0 && y < g.H;
    const size_t off = ok ? static_cast<size_t>(y) * g.W + xa + st.col : 0;
    const int s = row * g.span + st.col;
    if (g.vec) {
      cp_async16(dx + s, x + off, ok);
      if (m != nullptr) cp_async16(dm + s, m + off, ok);
    } else {
      cp_async4(dx + s, x + off, ok);
      if (m != nullptr) cp_async4(dm + s, m + off, ok);
    }
  }
}

template <int R>
__global__ void __launch_bounds__(kMaxThreads, min_blocks(R))
gauss_band_kernel(const float* __restrict__ x,
                  const float* __restrict__ mask, float* __restrict__ out,
                  Taps taps, Geo g) {
  constexpr int NW = 2 * R + 1;   // taps, window rows, rows per group
  constexpr int R4 = round4(R);
  constexpr int NQ = (R4 + R + 4 + 3) / 4;  // float4s of a W window
  extern __shared__ __align__(16) float smem[];
  const int group = NW * g.span;  // floats of one staged row group
  // kStages groups of x, then kStages of the mask when it is given.
  // The H pass writes its rows over the x group it has just read.
  float* s_x = smem;
  float* s_m = s_x + kStages * group;

  const int band = blockIdx.x % g.bands;
  const int rest = blockIdx.x / g.bands;
  const int seg = rest % g.segs;
  const int plane = rest / g.segs;
  const int x0 = band * g.bw;
  const int xa = x0 - R4;           // first staged column
  const int y0 = seg * g.sh;
  const int sh = min(g.sh, g.H - y0);  // this segment's output rows
  const int y_top = y0 - R;         // input row of segment row 0
  const int i_end = sh + 2 * R;     // input rows the segment reads
  const size_t hw = static_cast<size_t>(g.H) * g.W;
  const float* xp = x + plane * hw;
  const float* mp = mask != nullptr ? mask + (plane / g.C) * hw : nullptr;
  float* op = out + plane * hw;
  const int iters = (sh + NW - 1) / NW;
  const int tid = threadIdx.x;
  const Stager stager = make_stager(g, xa);

  // chunk 0: the 2r rows before the first output's window completes;
  // chunk c >= 1: input rows 2r + (c - 1) NW .. + NW - 1, for group c - 1
  auto issue = [&](int c) {
    if (c <= iters) {
      const int st = c % kStages;
      const int rows = c == 0 ? 2 * R : NW;
      const int i0 = c == 0 ? 0 : 2 * R + (c - 1) * NW;
      stage_rows(s_x + st * group, s_m + st * group, xp, mp, g, stager,
                 rows, i0, i_end, y_top, xa);
    }
    cp_async_commit();  // an empty group keeps the counts in step
  };

  issue(0);
  issue(1);
  cp_async_wait_one();
  __syncthreads();

  const bool col = tid < g.span;
  float ring[NW];
  // input row i sits in slot i % NW
#pragma unroll
  for (int i = 0; i < 2 * R; ++i) {
    float v = 0.0f;
    if (col) {
      v = s_x[i * g.span + tid];
      if (mp != nullptr) v *= s_m[i * g.span + tid];
    }
    ring[i] = v;
  }
  ring[2 * R] = 0.0f;

  // the W pass's tasks: 4 outputs at quad q of rows jr0, jr0 + jstep, ..
  const int quads = g.bw >> 2;
  const int jstep = blockDim.x / quads;
  const int jr0 = tid / quads;
  const int q = tid - jr0 * quads;
  const int xo = x0 + 4 * q;
  for (int t = 0; t < iters; ++t) {
    issue(t + 2);  // its stage was last read before the barrier below
    cp_async_wait_one();
    __syncthreads();
    const int st = (t + 1) % kStages;
    float* sx = s_x + st * group;
    const float* sm = s_m + st * group;
    const int rows = min(NW, sh - t * NW);  // output rows of this group
    if (col) {
#pragma unroll
      for (int s = 0; s < NW; ++s) {
        if (s < rows) {
          float v = sx[s * g.span + tid];
          if (mp != nullptr) v *= sm[s * g.span + tid];
          ring[(2 * R + s) % NW] = v;  // input row 2r + t NW + s
          // output row t NW + s reads input rows t NW + s .. + 2r
          float acc = 0.0f;
#pragma unroll
          for (int k = 0; k < NW; ++k) {
            acc = fmaf(taps.k[k], ring[(s + k) % NW], acc);
          }
          sx[s * g.span + tid] = acc;  // over the value just read
        }
      }
    }
    __syncthreads();
    // W pass: 4 outputs of one row a task, their window at span column
    // 4q + R4 - r of the H row
    for (int jr = jr0; jr < rows && xo < g.W; jr += jstep) {
      const float4* hrow =
          reinterpret_cast<const float4*>(sx + jr * g.span) + q;
      float win[4 * NQ];
#pragma unroll
      for (int u = 0; u < NQ; ++u) {
        const float4 h = hrow[u];
        win[4 * u] = h.x;
        win[4 * u + 1] = h.y;
        win[4 * u + 2] = h.z;
        win[4 * u + 3] = h.w;
      }
      float o[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        float acc = 0.0f;
#pragma unroll
        for (int k = 0; k < NW; ++k) {
          acc = fmaf(taps.k[k], win[R4 - R + m + k], acc);
        }
        o[m] = acc;
      }
      float* dst = op + static_cast<size_t>(y0 + t * NW + jr) * g.W + xo;
      if (g.vec) {
        *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
      } else {
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          if (xo + m < g.W) dst[m] = o[m];
        }
      }
    }
  }
}

int smem_bytes(int r, int bw, bool masked) {
  const int groups = kStages * (masked ? 2 : 1);
  return static_cast<int>(sizeof(float)) * (2 * r + 1) *
         (bw + 2 * round4(r)) * groups;
}

template <int R>
int launch(const float* x, const float* mask, float* out, const Taps& taps,
           const Geo& g, int blocks, int threads, int smem,
           cudaStream_t stream) {
  auto kernel = gauss_band_kernel<R>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<blocks, threads, smem, stream>>>(x, mask, out, taps, g);
  return static_cast<int>(cudaGetLastError());
}

template <int R>
int occupancy(int threads, int smem) {
  auto kernel = gauss_band_kernel<R>;
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  }
  int blocks = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                        threads, smem);
  }
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

#define WSEG_RADII(X)                                                     \
  X(0) X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(11) X(12)     \
  X(13) X(14) X(15) X(16)

}  // namespace

// The limits the host plan must keep, in this order: {largest radius,
// threads per block, stages of the input ring, dynamic shared memory
// bytes}.  Writes them to out (room for at least 4) and returns their
// count.
extern "C" int wseg_crf_gauss_limits(int* out) {
  const int limits[] = {kMaxR, kMaxThreads, kStages, kMaxSmem};
  const int n = static_cast<int>(sizeof(limits) / sizeof(limits[0]));
  for (int e = 0; e < n; ++e) out[e] = limits[e];
  return n;
}

// Blocks of the radius-r instance an SM of the current device holds at
// `threads` threads and `smem` bytes of dynamic shared memory (the host
// plan's occupancy), or minus a CUDA error.
extern "C" int wseg_crf_gauss_occupancy(int r, int threads, int smem) {
  if (threads <= 0 || threads > kMaxThreads || smem < 0 || smem > kMaxSmem) {
    return -static_cast<int>(cudaErrorInvalidValue);
  }
  switch (r) {
#define WSEG_OCCUPANCY(n) \
  case n:                 \
    return occupancy<n>(threads, smem);
    WSEG_RADII(WSEG_OCCUPANCY)
#undef WSEG_OCCUPANCY
  }
  return -static_cast<int>(cudaErrorInvalidValue);
}

// x, out (B, C, H, W) float32; mask (B, 1, H, W) float32 or null; k1d
// 2r+1 host floats; plan: host ints {bw, sh, threads, smem, vec}.
// Returns cudaErrorInvalidValue for a plan the kernel cannot run or
// whose threads or shared memory differ from the layout it describes.
extern "C" int wseg_crf_gauss_blur(const void* x, const void* mask,
                                   void* out, const float* k1d, int r,
                                   int B, int C, int H, int W,
                                   const int* plan, void* stream) {
  if (r < 0 || r > kMaxR || B <= 0 || C <= 0 || H <= 0 || W <= 0 ||
      plan == nullptr || k1d == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int bw = plan[0], sh = plan[1], threads = plan[2], smem = plan[3];
  const int vec = plan[4];
  const int span = bw + 2 * round4(r);
  if ((bw != 32 && bw != 64 && bw != 128) || sh <= 0 ||
      threads != (span + 31) / 32 * 32 || threads > kMaxThreads ||
      smem != smem_bytes(r, bw, mask != nullptr) || smem > kMaxSmem ||
      (vec != 0 && vec != 1) || (vec && W % 4 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Geo g{C, H, W, bw, sh, span, (W + bw - 1) / bw, (H + sh - 1) / sh, vec};
  const long long blocks =
      static_cast<long long>(B) * C * g.bands * g.segs;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  Taps taps;
  for (int k = 0; k < 2 * kMaxR + 1; ++k) {
    taps.k[k] = k <= 2 * r ? k1d[k] : 0.0f;
  }
  const float* xf = static_cast<const float*>(x);
  const float* mf = static_cast<const float*>(mask);
  float* of = static_cast<float*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (r) {
#define WSEG_LAUNCH(n) \
  case n:              \
    return launch<n>(xf, mf, of, taps, g, static_cast<int>(blocks), \
                     threads, smem, st);
    WSEG_RADII(WSEG_LAUNCH)
#undef WSEG_LAUNCH
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Dense-CRF bilateral message on Hopper (sm_90a), plain C interface.
//
//   out[b, c](y, x) = sum_k w[b, k](y, x) * q[b, c](y + dy_k, x + dx_k)
//
// with zero fill outside the image, over T displacement taps.
//
// Replaces the TPU kernel wseg_tpu/ops/crf_pallas.py::
// bilateral_message_pallas_cm (_bilateral_kernel).  That kernel rolls a
// zero-padded copy of q through VMEM, grouped by column offset, because
// Mosaic can only rotate whole lanes.
//
// What bounds it.  The compulsory traffic at the flagship (8 slots,
// C = 21, 192x256, the 80 taps of a 9x9 grid of pitch 20) is 33 MB of q
// (f32), the 40 MB of bf16 weights whose tap lands inside the image and
// 33 MB out: 31.6 us at 3.35 TB/s.
// A gather that reads q at the displaced pixel once per tap (the first
// port of this kernel) moves each q value through the cache up to 80
// times, 2.6 GB a call, and is paced by L2 at ~10x its bound.  Here
// every operand of the multiply-adds comes from shared memory:
//
// - Output row y reads only q rows y' = y + dy with dy a multiple of the
//   taps' row pitch P (the gcd of their |dy|; 20 at the flagship).  So
//   the rows of one residue class rho (y = rho + j P) are closed under
//   the taps.  A block owns one (slot, class, band of J class rows,
//   128-column segment, group of G channels).  It stages the class rows
//   its band reaches (J + dy-reach / P rows, the whole class of 9-10 rows
//   at the flagship) over the segment's columns plus the dx reach, for
//   its G channels, in dynamic shared memory, with 16-byte loads where W
//   is a multiple of 4.  q is read from device memory once per block.
// - A thread owns one column x and the band's J output rows for the G
//   channels (J x G accumulators in registers).  It walks the staged
//   rows i (descending) and the distinct dx (descending); one
//   shared-memory read of q per channel at (i, x + dx) feeds every
//   output row j whose tap (dy, dx) has dy = (i - j) P, each with its own
//   weight, applied to the G channels from registers.
// - Weights stream through a two-stage ring in shared memory.  A step
//   is (staged row i, chunk of D dx values); its D x J slots each hold
//   the 128-column weight row of one output row j and the tap (dy, dx)
//   with dy = (i - j) P, or zeros where there is none, so the inner loop
//   has no branch and reads each weight at a fixed offset.  The next
//   step's rows are copied with cp.async (16 bytes a thread where W is a
//   multiple of 8) while the block computes this one, so no multiply-add
//   waits on device memory.  Each weight is read once per block.
// - Each output's taps arrive in (dy desc, dx desc) order: the tap order
//   of the fast CRF's negated grid, so there the float sums are the
//   plain version's.  Repeated taps go to further layers, walked after.
//
// What bounds it now is instruction throughput, not bytes: at the
// flagship each thread runs ~5.7k FMAs, with a shared load and a bf16
// convert per weight and two block barriers per ring step.  74 KB of
// shared memory a block gives 3 blocks (12 warps) an SM and 2.4 waves
// of 960 blocks.  It takes ~5x its bound at C = 21 and ~2.4x at the
// C = 1 norm filter (12.8 us), where the weight stream is nearly all
// its work.
//
// q is float32 (the CRF applies its message dtype before the call) and
// finite, w is bfloat16, out is float32, all contiguous (B, ., H, W).
// The plan (ops/crf_bilateral.py::band_plan, which alone picks the
// launch geometry within the limits below) comes as host ints and an
// int32 device table [distinct dx (ndx) | tap of each cell, -1 for none
// (layers x ndx x ndy)].  Launches on the caller's stream, allocates
// nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxC = 32;        // channels a call may have
constexpr int kMaxTaps = 1024;   // taps a call may have
constexpr int kMaxGroup = 8;     // channels per block
constexpr int kMaxRows = 10;     // output rows per thread (band height)
constexpr int kBlock = 128;      // threads per block, one column each
constexpr int kParts = kBlock * 2 / 16;  // 16-byte parts of a weight row
constexpr int kSlotsPerThread = 4;       // weight-row parts a thread copies
constexpr int kMaxSlots = kSlotsPerThread * kBlock / kParts;  // per stage
constexpr int kMaxSmem = 232448; // dynamic shared memory a block may use

// The launch's geometry, chosen on the host (band_plan) within the
// limits above; the entry checks it and derives only the grid.
struct Plan {
  int P;        // row pitch of the taps
  int dy_lo;    // lowest dy / P
  int ndy;      // dy / P spans [dy_lo, dy_lo + ndy)
  int ndx;      // distinct dx values
  int dx_lo;    // lowest dx
  int dx_hi;    // highest dx
  int J;        // output rows per band
  int JT;       // output rows a thread holds (template), >= J
  int G;        // channels per block
  int S;        // staged q rows per band
  int SW;       // staged q row stride in floats, a multiple of 4
  int D;        // dx values per step, D x JT <= kMaxSlots
  int L;        // layers of taps
  int qvec;     // 16-byte q loads
  int wvec;     // 16-byte cp.async weight copies
  int smem;     // dynamic shared memory bytes
  int bands;    // bands per class
  int groups;   // channel groups
  int xsegs;    // column segments
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

template <int G, int JT>
__global__ void __launch_bounds__(kBlock)
bilateral_band_kernel(const float* __restrict__ q,
                      const __nv_bfloat16* __restrict__ w,
                      const int* __restrict__ table,
                      float* __restrict__ out, Plan p, int C, int T, int H,
                      int W) {
  extern __shared__ __align__(16) float smem[];
  float* s_q = smem;  // G x S x SW
  const int slots = p.D * JT;  // weight rows per ring stage: (dx, row)
  __nv_bfloat16* s_w =
      reinterpret_cast<__nv_bfloat16*>(smem + G * p.S * p.SW);
  int* s_dx = reinterpret_cast<int*>(s_w + 2 * slots * kBlock);
  int* s_cell = s_dx + p.ndx;  // L x ndx x ndy

  int idx = blockIdx.x;
  const int g = idx % p.groups;
  idx /= p.groups;
  const int seg = idx % p.xsegs;
  idx /= p.xsegs;
  const int band = idx % p.bands;
  idx /= p.bands;
  const int rho = idx % p.P;
  const int b = idx / p.P;
  const int n = (H - rho + p.P - 1) / p.P;  // rows of class rho
  const int j0 = band * p.J;
  if (j0 >= n) return;
  const int jn = min(n - j0, p.J);
  // the class rows the band's taps reach
  const int i_lo = max(0, j0 + p.dy_lo);
  const int i_hi = min(n, j0 + jn + p.dy_lo + p.ndy - 1);
  const int nrows = max(0, i_hi - i_lo);
  const int c0 = g * G;
  const int gc = min(G, C - c0);
  const int x0 = seg * kBlock;
  const size_t hw = static_cast<size_t>(H) * W;

  const int ntab = p.ndx + p.L * p.ndx * p.ndy;
  for (int e = threadIdx.x; e < ntab; e += kBlock) s_dx[e] = table[e];
  __syncthreads();

  // steps: layer, staged row i descending, chunk of D dx values
  const int nch = (p.ndx + p.D - 1) / p.D;
  const int nsteps = p.L * nrows * nch;
  const __nv_bfloat16* wb = w + static_cast<size_t>(b) * T * hw;
  const int part = threadIdx.x % kParts;
  const int xc = x0 + part * 8;  // first column of this thread's part
  const int wrow0 = (rho + j0 * p.P) * W + xc;

  // copy the weight rows of step (l, i, chunk) into ring stage buf: slot
  // (dd, jj) holds the row of output jj and the tap of cell (dx d0 + dd,
  // dy (i - j0 - jj) P), zeros where there is none
  auto stage_weights = [&](int buf, int l, int i, int chunk) {
    const int d0 = chunk * p.D;
    __nv_bfloat16* dst = s_w + buf * slots * kBlock + part * 8;
#pragma unroll
    for (int m = 0; m < kSlotsPerThread; ++m) {
      const int slot = threadIdx.x / kParts + m * (kBlock / kParts);
      if (slot >= slots) break;
      const int dd = slot / JT;
      const int jj = slot % JT;
      const int r = i - j0 - p.dy_lo - jj;
      int k = -1;
      if (d0 + dd < p.ndx && jj < jn &&
          static_cast<unsigned>(r) < static_cast<unsigned>(p.ndy)) {
        k = s_cell[(l * p.ndx + d0 + dd) * p.ndy + r];
      }
      __nv_bfloat16* sp = dst + slot * kBlock;
      if (k < 0 || xc >= W) {
        *reinterpret_cast<uint4*>(sp) = make_uint4(0, 0, 0, 0);
        continue;
      }
      const __nv_bfloat16* gp = wb + static_cast<size_t>(k) * hw + wrow0 +
                                static_cast<size_t>(jj) * p.P * W;
      if (p.wvec) {
        cp_async16(sp, gp);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          sp[e] = xc + e < W ? gp[e] : __float2bfloat16(0.0f);
        }
      }
    }
  };

  if (nsteps > 0) stage_weights(0, 0, i_hi - 1, 0);
  cp_async_commit();

  // the columns the segment's taps reach, widened to multiples of 4
  const int xs = max(0, x0 + p.dx_lo) & ~3;
  int xe = min(W, x0 + kBlock + p.dx_hi);
  if (p.qvec) xe = min(W, (xe + 3) & ~3);
  const int width = max(0, xe - xs);
  const float* qb = q + (static_cast<size_t>(b) * C + c0) * hw;
  if (p.qvec) {
    const int w4 = width >> 2;
    const int total = gc * nrows * w4;
    for (int e = threadIdx.x; e < total; e += kBlock) {
      const int col = e % w4;
      const int r = (e / w4) % nrows;
      const int c = e / w4 / nrows;
      const size_t y = rho + static_cast<size_t>(i_lo + r) * p.P;
      const float4 v = __ldg(reinterpret_cast<const float4*>(
          qb + c * hw + y * W + xs) + col);
      *reinterpret_cast<float4*>(s_q + (c * p.S + r) * p.SW + 4 * col) = v;
    }
  } else {
    const int total = gc * nrows * width;
    for (int e = threadIdx.x; e < total; e += kBlock) {
      const int col = e % width;
      const int r = (e / width) % nrows;
      const int c = e / width / nrows;
      const size_t y = rho + static_cast<size_t>(i_lo + r) * p.P;
      s_q[(c * p.S + r) * p.SW + col] = __ldg(qb + c * hw + y * W + xs + col);
    }
  }

  const int x = x0 + threadIdx.x;
  const bool in = x < W;
  float acc[JT][G];
#pragma unroll
  for (int jj = 0; jj < JT; ++jj) {
#pragma unroll
    for (int c = 0; c < G; ++c) acc[jj][c] = 0.0f;
  }
  const int cstride = p.S * p.SW;

  int l = 0, i = i_hi - 1, chunk = 0;
  for (int s = 0; s < nsteps; ++s) {
    int nl = l, ni = i, nc = chunk + 1;  // the next step
    if (nc == nch) {
      nc = 0;
      if (--ni < i_lo) {
        ni = i_hi - 1;
        ++nl;
      }
    }
    if (s + 1 < nsteps) stage_weights((s + 1) & 1, nl, ni, nc);
    cp_async_commit();
    cp_async_wait_one();  // step s's copies have landed
    __syncthreads();
    const int d0 = chunk * p.D;
    const int nd = min(p.D, p.ndx - d0);
    const float* srow = s_q + (i - i_lo) * p.SW;
    const __nv_bfloat16* wrow = s_w + (s & 1) * slots * kBlock + threadIdx.x;
    for (int dd = 0; dd < nd; ++dd) {
      const int xx = x + s_dx[d0 + dd];
      if (!in || xx < 0 || xx >= W) continue;
      float qv[G];
#pragma unroll
      for (int c = 0; c < G; ++c) {
        qv[c] = c < gc ? srow[c * cstride + xx - xs] : 0.0f;
      }
      const __nv_bfloat16* wd = wrow + dd * JT * kBlock;
#pragma unroll
      for (int jj = 0; jj < JT; ++jj) {
        const float wk = __bfloat162float(wd[jj * kBlock]);
#pragma unroll
        for (int c = 0; c < G; ++c) acc[jj][c] = fmaf(wk, qv[c], acc[jj][c]);
      }
    }
    __syncthreads();  // stage s & 1 is refilled by step s + 2
    l = nl;
    i = ni;
    chunk = nc;
  }

  if (!in) return;
  float* ob = out + (static_cast<size_t>(b) * C + c0) * hw +
              static_cast<size_t>(rho + j0 * p.P) * W + x;
  const size_t pw = static_cast<size_t>(p.P) * W;
#pragma unroll
  for (int jj = 0; jj < JT; ++jj) {
    if (jj < jn) {
#pragma unroll
      for (int c = 0; c < G; ++c) {
        if (c < gc) ob[c * hw + jj * pw] = acc[jj][c];
      }
    }
  }
}

template <int G, int JT>
int launch(const Plan& p, int blocks, const float* q,
           const __nv_bfloat16* w, const int* table, float* out, int C,
           int T, int H, int W, cudaStream_t stream) {
  auto kernel = bilateral_band_kernel<G, JT>;
  if (p.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<blocks, kBlock, p.smem, stream>>>(q, w, table, out, p, C, T, H,
                                             W);
  return static_cast<int>(cudaGetLastError());
}

// the built instances: 2 rows a thread for one or two channels, kMaxRows
// for any group
int launch_any(const Plan& p, int blocks, const float* q,
               const __nv_bfloat16* w, const int* table, float* out, int C,
               int T, int H, int W, cudaStream_t stream) {
  if (p.JT == 2 && p.G == 1) {
    return launch<1, 2>(p, blocks, q, w, table, out, C, T, H, W, stream);
  }
  if (p.JT == 2 && p.G == 2) {
    return launch<2, 2>(p, blocks, q, w, table, out, C, T, H, W, stream);
  }
  if (p.JT != kMaxRows) return static_cast<int>(cudaErrorInvalidValue);
  switch (p.G) {
#define WSEG_GROUP(g)                                                      \
  case g:                                                                  \
    return launch<g, kMaxRows>(p, blocks, q, w, table, out, C, T, H, W,   \
                               stream);
    WSEG_GROUP(1) WSEG_GROUP(2) WSEG_GROUP(3) WSEG_GROUP(4)
    WSEG_GROUP(5) WSEG_GROUP(6) WSEG_GROUP(7) WSEG_GROUP(8)
#undef WSEG_GROUP
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// The limits the host plan must keep, in this order: {channels, taps,
// threads per block, channels per block, rows a thread, weight-ring
// slots, dynamic shared memory bytes}.  Writes them to out (room for
// at least 7) and returns their count.
extern "C" int wseg_crf_bilateral_limits(int* out) {
  const int limits[] = {kMaxC,    kMaxTaps,  kBlock,  kMaxGroup,
                        kMaxRows, kMaxSlots, kMaxSmem};
  const int n = static_cast<int>(sizeof(limits) / sizeof(limits[0]));
  for (int e = 0; e < n; ++e) out[e] = limits[e];
  return n;
}

// plan: host ints {P, dy_lo, ndy, ndx, dx_lo, dx_hi, J, JT, G, S, SW, D,
// L, qvec, wvec, smem}.  Returns cudaErrorInvalidValue for a plan outside
// the limits or whose smem is short of the layout it describes.
extern "C" int wseg_crf_bilateral_message(const void* q, const void* w,
                                          const void* table, void* out,
                                          int B, int C, int T, int H, int W,
                                          const int* plan, void* stream) {
  if (B <= 0 || C <= 0 || C > kMaxC || T <= 0 || T > kMaxTaps ||
      H <= 0 || W <= 0 || plan == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Plan p{plan[0],  plan[1],  plan[2],  plan[3],  plan[4],  plan[5],
         plan[6],  plan[7],  plan[8],  plan[9],  plan[10], plan[11],
         plan[12], plan[13], plan[14], plan[15], 0,        0,
         0};
  if (p.P <= 0 || p.ndy <= 0 || p.ndx < 0 || p.J <= 0 || p.J > p.JT ||
      p.G <= 0 || p.G > kMaxGroup || p.G > C || p.S <= 0 || p.SW <= 0 ||
      p.SW % 4 != 0 || p.D <= 0 || p.D * p.JT > kMaxSlots || p.L < 0 ||
      (p.qvec && W % 4 != 0) || (p.wvec && W % 8 != 0) || p.smem <= 0 ||
      p.smem > kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the kernel's layout: staged q | two ring stages | dx and cell table
  const size_t layout =
      sizeof(float) * static_cast<size_t>(p.G) * p.S * p.SW +
      sizeof(__nv_bfloat16) * 2 * static_cast<size_t>(p.D) * p.JT *
          kBlock +
      sizeof(int) * (p.ndx + static_cast<size_t>(p.L) * p.ndx * p.ndy);
  const int nq = (H + p.P - 1) / p.P;
  p.bands = (nq + p.J - 1) / p.J;
  p.groups = (C + p.G - 1) / p.G;
  p.xsegs = (W + kBlock - 1) / kBlock;
  const long long blocks = static_cast<long long>(B) * p.P * p.bands *
                           p.xsegs * p.groups;
  if (layout > static_cast<size_t>(p.smem) || blocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_any(p, static_cast<int>(blocks),
                    static_cast<const float*>(q),
                    static_cast<const __nv_bfloat16*>(w),
                    static_cast<const int*>(table), static_cast<float*>(out),
                    C, T, H, W, static_cast<cudaStream_t>(stream));
}

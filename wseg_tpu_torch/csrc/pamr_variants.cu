// The PAMR propagation variants of the kernel lab on Hopper (sm_90a),
// plain C interface: fold, dxfirst and mxu.
//
// Each computes num_iter Jacobi steps of the propagation
//
//   m <- sum_t aff_t * shift_t(m)          (edge-replicated shifts)
//
// in ONE launch, the function of csrc/pamr.cu's pamr_propagate_kernel,
// and differs from it in the order of the sum, in what the block
// holds, and in how the shifts are done: each answers one question the
// TPU lab asked, put to this card.  Taps are 8 per dilation d, the
// row-major 3x3 neighbours without the centre times d; edge replication
// is coordinate clamping.  The caller hands the taps in summation order
// (the "plan": (dy, dx, t) per tap, then the group starts), so the
// grouping lives in one place, wseg_tpu_torch/ops/pamr_variants.py.
//
// 1. pamr_fold_kernel replaces tools/bench_pamr.py::propagate_fold
//    (_propagate_kernel_fold).  On the TPU, folding moved block_b batch
//    items per lane rotate.  Here the lever is that one load of a
//    pixel's affinity serves every plane the block holds: a block holds
//    NB (batch, channel) planes of ONE image (the affinities are per
//    image), a last partial block allowed, in shared memory as S (float
//    or bfloat16), single-buffered: each thread keeps the step's NB x 9
//    float32 accumulators of its pixels in registers, and writes them
//    back (rounded to S) after a barrier.  Sum order: the dy groups
//    (sorted dy, then tap order), as the TPU kernel.
// 2. pamr_dxfirst_kernel replaces bench_pamr.py::propagate_dxfirst.  A
//    TPU lane rotate is the counterpart of a column shift across a
//    warp's lanes; here each dx group's column-shifted window of a plane
//    is staged once into shared memory (one pass, clamped), and the
//    group's dy taps read it as row offsets.  Sum order: the dx groups
//    (sorted dx, then tap order).  One window buffer is reused plane by
//    plane, so NB + 1 planes of S fit shared memory at the lab's shapes.
// 3. pamr_mxu_kernel replaces bench_pamr.py::propagate_mxu.  For each
//    dy group, the dy-shifted rows of the block's planes (M = NB * H
//    rows by Wp = W + 2 pad padded columns) times the 0/1 selector
//    (Wp x g W: column j of tap window gi is 1 at k = pad + dx_gi + j)
//    go through mma.sync m16n8k16 in bf16 with float32 accumulation;
//    the selector fragments are made in registers, and of the Wp / 16
//    k-tiles only the one or two that hold a 1 for an n-tile are
//    issued.  Each product is multiplied by aff and accumulated in
//    registers (the step's accumulators of a warp's 16 x 8 tiles).
//    PASSES = 1 is the TPU's DEFAULT (the read rounded to bf16); 3
//    splits each float32 value into hi + mid + lo bf16 parts, which the
//    one-hot product returns exactly.  Unlike the TPU kernel, whose
//    selector windows are 128 wide, it is right at any W.  It does some
//    16-32 multiply-adds per shifted read where the propagation needs
//    one: work the design adds.
//
// What bounds the function (all three): at (8, 48, 48, 21), 48 taps,
// 10 steps, 2 x 186M = 372 MFLOP, 5.5 us at the 67 TFLOP/s float32
// peak, against 6.6 MB of compulsory traffic (2.0 us); 1.49 GFLOP at
// (8, 96, 96, 21).  The designs keep the planes in shared memory for
// all steps and read aff (3.5 MB at the flagship) from L2 each step, as
// pamr_propagate_kernel does; the grid is B * ceil(C / NB) blocks, so a
// larger NB buys fewer affinity loads with fewer blocks in flight.
//
// Limits (the wrapper checks them first and names them): NB <= 4 for
// fold and dxfirst, H * W <= 9216 pixels (9 per thread, accumulators in
// registers), NB (+ 1) planes within the shared-memory opt-in; for mxu
// at most 256 tiles of 16 x 8 and NB float32 planes in shared memory.
// All tensors channels-major: aff (B, T, H, W) float32, mask and out
// (B, C, H, W) float32, contiguous.  Each launcher runs on the caller's
// stream, allocates nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxTaps = 64;             // 8 dilations
constexpr int kMaxBlock = 4;             // planes per block, fold/dxfirst
constexpr int kThreads = 1024;           // fold/dxfirst
constexpr int kMaxPix = 9;               // pixels per thread
constexpr int kMmaThreads = 512;         // mxu: 16 warps
constexpr int kMmaWarps = kMmaThreads / 32;
constexpr int kMaxTilesPerWarp = 16;     // mxu: 256 tiles of 16 x 8

struct Plan {
  int n;                   // taps
  int groups;
  int dy[kMaxTaps], dx[kMaxTaps], t[kMaxTaps];
  int start[kMaxTaps + 1]; // group g is [start[g], start[g + 1])
};

struct SharedPlan {
  int dy[kMaxTaps], dx[kMaxTaps], t[kMaxTaps];
  int start[kMaxTaps + 1];
};

constexpr int kStaticBytes = static_cast<int>(sizeof(SharedPlan));

__device__ __forceinline__ void stage_plan(const Plan& plan, SharedPlan* s) {
  for (int k = threadIdx.x; k < kMaxTaps; k += blockDim.x) {
    s->dy[k] = plan.dy[k];
    s->dx[k] = plan.dx[k];
    s->t[k] = plan.t[k];
  }
  for (int g = threadIdx.x; g <= kMaxTaps; g += blockDim.x) {
    s->start[g] = plan.start[g];
  }
}

__device__ __forceinline__ int clampi(int v, int hi) {
  return v < 0 ? 0 : (v > hi ? hi : v);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename S>
__device__ __forceinline__ S from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// The block's NB planes of image b, channels c0.., into shared memory
// (zeros past the last channel) and each thread's pixel coordinates.
template <typename S, int NB>
__device__ __forceinline__ void load_planes(const float* __restrict__ mask,
                                            S* planes, int* yx, int b,
                                            int c0, int C, int H, int W) {
  const int hw = H * W;
#pragma unroll
  for (int n = 0; n < NB; ++n) {
    const bool valid = c0 + n < C;
    const float* src = mask + (static_cast<size_t>(b) * C + c0 + n) * hw;
    for (int p = threadIdx.x; p < hw; p += blockDim.x) {
      planes[n * hw + p] = from_f32<S>(valid ? src[p] : 0.0f);
    }
  }
#pragma unroll
  for (int j = 0; j < kMaxPix; ++j) {
    const int p = threadIdx.x + j * kThreads;
    const int y = p / W;
    yx[j] = (y << 16) | (p - y * W);
  }
}

template <typename S, int NB>
__device__ __forceinline__ void store_planes(float* __restrict__ out,
                                             const S* planes, int b, int c0,
                                             int C, int hw) {
#pragma unroll
  for (int n = 0; n < NB; ++n) {
    if (c0 + n >= C) continue;
    float* dst = out + (static_cast<size_t>(b) * C + c0 + n) * hw;
    for (int p = threadIdx.x; p < hw; p += blockDim.x) {
      dst[p] = to_f32(planes[n * hw + p]);
    }
  }
}

template <typename S, int NB>
__device__ __forceinline__ void write_back(S* planes,
                                           const float (&acc)[kMaxPix][NB],
                                           int hw) {
#pragma unroll
  for (int j = 0; j < kMaxPix; ++j) {
    const int p = threadIdx.x + j * kThreads;
    if (p < hw) {
#pragma unroll
      for (int n = 0; n < NB; ++n) planes[n * hw + p] = from_f32<S>(acc[j][n]);
    }
  }
}

template <typename S, int NB>
__global__ void __launch_bounds__(kThreads, 1)
pamr_fold_kernel(const float* __restrict__ aff, const float* __restrict__ mask,
                 float* __restrict__ out, Plan plan, int C, int H, int W,
                 int num_iter, int cblocks) {
  extern __shared__ __align__(16) unsigned char smem[];
  S* planes = reinterpret_cast<S*>(smem);
  __shared__ SharedPlan sp;
  stage_plan(plan, &sp);

  const int b = blockIdx.x / cblocks;
  const int c0 = (blockIdx.x % cblocks) * NB;
  const int hw = H * W;
  const int T = plan.n;
  int yx[kMaxPix];
  load_planes<S, NB>(mask, planes, yx, b, c0, C, H, W);
  __syncthreads();

  const float* a_img = aff + static_cast<size_t>(b) * T * hw;
  for (int it = 0; it < num_iter; ++it) {
    float acc[kMaxPix][NB];
#pragma unroll
    for (int j = 0; j < kMaxPix; ++j) {
#pragma unroll
      for (int n = 0; n < NB; ++n) acc[j][n] = 0.0f;
    }
    for (int k = 0; k < T; ++k) {
      const int dy = sp.dy[k];
      const int dx = sp.dx[k];
      const float* ap = a_img + static_cast<size_t>(sp.t[k]) * hw;
#pragma unroll
      for (int j = 0; j < kMaxPix; ++j) {
        const int p = threadIdx.x + j * kThreads;
        if (p < hw) {
          const int q = clampi((yx[j] >> 16) + dy, H - 1) * W +
                        clampi((yx[j] & 0xffff) + dx, W - 1);
          const float a = __ldg(ap + p);  // one load for all NB planes
#pragma unroll
          for (int n = 0; n < NB; ++n) acc[j][n] += a * to_f32(planes[n * hw + q]);
        }
      }
    }
    __syncthreads();
    write_back<S, NB>(planes, acc, hw);
    __syncthreads();
  }
  store_planes<S, NB>(out, planes, b, c0, C, hw);
}

template <typename S, int NB>
__global__ void __launch_bounds__(kThreads, 1)
pamr_dxfirst_kernel(const float* __restrict__ aff,
                    const float* __restrict__ mask, float* __restrict__ out,
                    Plan plan, int C, int H, int W, int num_iter,
                    int cblocks) {
  extern __shared__ __align__(16) unsigned char smem[];
  S* planes = reinterpret_cast<S*>(smem);
  const int hw = H * W;
  S* win = planes + NB * hw;  // one column-shifted window
  __shared__ SharedPlan sp;
  stage_plan(plan, &sp);

  const int b = blockIdx.x / cblocks;
  const int c0 = (blockIdx.x % cblocks) * NB;
  int yx[kMaxPix];
  load_planes<S, NB>(mask, planes, yx, b, c0, C, H, W);
  __syncthreads();  // the plan is read before the first window's barrier

  const float* a_img = aff + static_cast<size_t>(b) * plan.n * hw;
  for (int it = 0; it < num_iter; ++it) {
    float acc[kMaxPix][NB];
#pragma unroll
    for (int j = 0; j < kMaxPix; ++j) {
#pragma unroll
      for (int n = 0; n < NB; ++n) acc[j][n] = 0.0f;
    }
    for (int g = 0; g < plan.groups; ++g) {
      const int dx = sp.dx[sp.start[g]];
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        __syncthreads();  // the previous window's readers are done
#pragma unroll
        for (int j = 0; j < kMaxPix; ++j) {
          const int p = threadIdx.x + j * kThreads;
          if (p < hw) {
            win[p] = planes[n * hw + (yx[j] >> 16) * W +
                            clampi((yx[j] & 0xffff) + dx, W - 1)];
          }
        }
        __syncthreads();
        for (int k = sp.start[g]; k < sp.start[g + 1]; ++k) {
          const int dy = sp.dy[k];
          const float* ap = a_img + static_cast<size_t>(sp.t[k]) * hw;
#pragma unroll
          for (int j = 0; j < kMaxPix; ++j) {
            const int p = threadIdx.x + j * kThreads;
            if (p < hw) {
              const int q = clampi((yx[j] >> 16) + dy, H - 1) * W + (yx[j] & 0xffff);
              acc[j][n] += __ldg(ap + p) * to_f32(win[q]);
            }
          }
        }
      }
    }
    __syncthreads();
    write_back<S, NB>(planes, acc, hw);
  }
  __syncthreads();
  store_planes<S, NB>(out, planes, b, c0, C, hw);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi)))
          << 16);
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, float32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int PASSES>
__global__ void __launch_bounds__(kMmaThreads, 1)
pamr_mxu_kernel(const float* __restrict__ aff, const float* __restrict__ mask,
                float* __restrict__ out, Plan plan, int C, int H, int W,
                int num_iter, int nb, int cblocks, int pad) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* planes = reinterpret_cast<float*>(smem);
  __shared__ SharedPlan sp;
  stage_plan(plan, &sp);

  const int b = blockIdx.x / cblocks;
  const int c0 = (blockIdx.x % cblocks) * nb;
  const int hw = H * W;
  for (int n = 0; n < nb; ++n) {
    const bool valid = c0 + n < C;
    const float* src = mask + (static_cast<size_t>(b) * C + c0 + n) * hw;
    for (int p = threadIdx.x; p < hw; p += kMmaThreads) {
      planes[n * hw + p] = valid ? src[p] : 0.0f;
    }
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gid = lane >> 2;  // fragment row group
  const int tig = lane & 3;   // thread in group
  const int M = nb * H;       // rows of the product: (plane, y)
  const int n_tiles_n = (W + 7) / 8;
  const int n_tiles = ((M + 15) / 16) * n_tiles_n;
  const int wp = W + 2 * pad;
  const float* a_img = aff + static_cast<size_t>(b) * plan.n * hw;
  const uint32_t one = 0x3f80u;  // bf16 1.0

  for (int it = 0; it < num_iter; ++it) {
    float acc[kMaxTilesPerWarp][4];
#pragma unroll
    for (int i = 0; i < kMaxTilesPerWarp; ++i) {
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][q] = 0.0f;
    }
    for (int g = 0; g < plan.groups; ++g) {
      const int dy = sp.dy[sp.start[g]];
#pragma unroll
      for (int i = 0; i < kMaxTilesPerWarp; ++i) {
        const int tile = warp + i * kMmaWarps;
        if (tile >= n_tiles) continue;
        const int m0 = (tile / n_tiles_n) * 16;
        const int j0 = (tile % n_tiles_n) * 8;
        // the dy-shifted source rows of this lane's two fragment rows
        int y_of[2], base[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = m0 + gid + 8 * h;
          base[h] = -1;
          y_of[h] = 0;
          if (r < M) {
            const int n = r / H;
            y_of[h] = r - n * H;
            base[h] = n * hw + clampi(y_of[h] + dy, H - 1) * W;
          }
        }
        for (int k = sp.start[g]; k < sp.start[g + 1]; ++k) {
          const int klo = pad + sp.dx[k] + j0;  // selected column of n = 0
          const int ksel = klo + gid;           // ... of this lane's n
          const bool col_ok = j0 + gid < W;
          float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          for (int kt = klo >> 4; kt <= (klo + 7) >> 4; ++kt) {
            const int ka = kt * 16 + 2 * tig;  // A cols ka, ka+1, ka+8, ka+9
            float v[8];
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              const int kk = ka + (e & 1) + ((e >> 2) << 3);
              const int h = (e >> 1) & 1;
              v[e] = (base[h] >= 0 && kk < wp)
                         ? planes[base[h] + clampi(kk - pad, W - 1)]
                         : 0.0f;
            }
            const uint32_t b0 =
                (col_ok && ka == ksel ? one : 0u) |
                ((col_ok && ka + 1 == ksel ? one : 0u) << 16);
            const uint32_t b1 =
                (col_ok && ka + 8 == ksel ? one : 0u) |
                ((col_ok && ka + 9 == ksel ? one : 0u) << 16);
#pragma unroll
            for (int pass = 0; pass < PASSES; ++pass) {
              uint32_t a[4];
              // a0: (row g, ka..), a1: (row g+8, ka..), a2: (row g, ka+8..),
              // a3: (row g+8, ka+8..)
              a[0] = pack_bf16(v[0], v[1]);
              a[1] = pack_bf16(v[2], v[3]);
              a[2] = pack_bf16(v[4], v[5]);
              a[3] = pack_bf16(v[6], v[7]);
              mma_bf16(c, a, b0, b1);
              if (PASSES > 1) {
#pragma unroll
                for (int e = 0; e < 8; ++e) {
                  v[e] -= __bfloat162float(__float2bfloat16_rn(v[e]));
                }
              }
            }
          }
          // c0, c1: (row g, cols j0 + 2 tig, +1); c2, c3: (row g + 8, ...)
          const float* ap = a_img + static_cast<size_t>(sp.t[k]) * hw;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int h = q >> 1;
            const int j = j0 + 2 * tig + (q & 1);
            if (base[h] >= 0 && j < W) {
              acc[i][q] += __ldg(ap + y_of[h] * W + j) * c[q];
            }
          }
        }
      }
    }
    __syncthreads();  // every read of this step is done
#pragma unroll
    for (int i = 0; i < kMaxTilesPerWarp; ++i) {
      const int tile = warp + i * kMmaWarps;
      if (tile >= n_tiles) continue;
      const int m0 = (tile / n_tiles_n) * 16;
      const int j0 = (tile % n_tiles_n) * 8;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = m0 + gid + 8 * (q >> 1);
        const int j = j0 + 2 * tig + (q & 1);
        if (r < M && j < W) {
          const int n = r / H;
          planes[n * hw + (r - n * H) * W + j] = acc[i][q];
        }
      }
    }
    __syncthreads();
  }
  for (int n = 0; n < nb; ++n) {
    if (c0 + n >= C) continue;
    float* dst = out + (static_cast<size_t>(b) * C + c0 + n) * hw;
    for (int p = threadIdx.x; p < hw; p += kMmaThreads) dst[p] = planes[n * hw + p];
  }
}

bool fill_plan(const int* rows, int n_taps, int n_groups, Plan* plan) {
  if (n_taps <= 0 || n_taps > kMaxTaps || n_groups <= 0 ||
      n_groups > n_taps) {
    return false;
  }
  plan->n = n_taps;
  plan->groups = n_groups;
  for (int k = 0; k < kMaxTaps; ++k) {
    const bool in = k < n_taps;
    plan->dy[k] = in ? rows[3 * k] : 0;
    plan->dx[k] = in ? rows[3 * k + 1] : 0;
    plan->t[k] = in ? rows[3 * k + 2] : 0;
    if (in && (plan->t[k] < 0 || plan->t[k] >= n_taps)) return false;
  }
  for (int g = 0; g <= kMaxTaps; ++g) {
    plan->start[g] = g <= n_groups ? rows[3 * n_taps + g] : n_taps;
  }
  return plan->start[0] == 0 && plan->start[n_groups] == n_taps;
}

int smem_optin() {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess) {
    return 0;
  }
  return optin - kStaticBytes;
}

template <bool kDxFirst, typename S, int NB>
int launch_simt(const void* aff, const void* mask, void* out, const Plan& plan,
                int B, int C, int H, int W, int num_iter, cudaStream_t stream) {
  const int cblocks = (C + NB - 1) / NB;
  const size_t smem = static_cast<size_t>(NB + (kDxFirst ? 1 : 0)) * H * W *
                      sizeof(S);
  auto kernel = kDxFirst ? &pamr_dxfirst_kernel<S, NB> : &pamr_fold_kernel<S, NB>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<B * cblocks, kThreads, smem, stream>>>(
      static_cast<const float*>(aff), static_cast<const float*>(mask),
      static_cast<float*>(out), plan, C, H, W, num_iter, cblocks);
  return static_cast<int>(cudaGetLastError());
}

template <bool kDxFirst, typename S>
int dispatch_block(int block, const void* aff, const void* mask, void* out,
                   const Plan& plan, int B, int C, int H, int W, int num_iter,
                   cudaStream_t stream) {
  switch (block) {
    case 1: return launch_simt<kDxFirst, S, 1>(aff, mask, out, plan, B, C, H, W, num_iter, stream);
    case 2: return launch_simt<kDxFirst, S, 2>(aff, mask, out, plan, B, C, H, W, num_iter, stream);
    case 3: return launch_simt<kDxFirst, S, 3>(aff, mask, out, plan, B, C, H, W, num_iter, stream);
    case 4: return launch_simt<kDxFirst, S, 4>(aff, mask, out, plan, B, C, H, W, num_iter, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <bool kDxFirst>
int run_simt(const void* aff, const void* mask, void* out, const int* plan_rows,
            int n_taps, int n_groups, int B, int C, int H, int W,
            int num_iter, int block, int bf16_store, void* stream) {
  Plan plan;
  const size_t elem = bf16_store ? 2 : 4;
  if (!fill_plan(plan_rows, n_taps, n_groups, &plan) || B <= 0 || C <= 0 ||
      H <= 0 || W <= 0 || num_iter < 0 || block < 1 || block > kMaxBlock ||
      H * W > kThreads * kMaxPix || W > 0xffff ||
      static_cast<long long>(block + (kDxFirst ? 1 : 0)) * H * W * elem >
          smem_optin()) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16_store
             ? dispatch_block<kDxFirst, __nv_bfloat16>(block, aff, mask, out, plan,
                                                       B, C, H, W, num_iter, s)
             : dispatch_block<kDxFirst, float>(block, aff, mask, out, plan, B,
                                               C, H, W, num_iter, s);
}

}  // namespace

extern "C" int wseg_pamr_max_dilations() { return kMaxTaps / 8; }
extern "C" int wseg_pamr_variant_max_block() { return kMaxBlock; }
extern "C" int wseg_pamr_variant_max_pixels() { return kThreads * kMaxPix; }
extern "C" int wseg_pamr_mxu_max_tiles() { return kMmaWarps * kMaxTilesPerWarp; }
// dynamic shared memory a block of these kernels may take on this device
extern "C" int wseg_pamr_variant_smem() { return smem_optin(); }

extern "C" int wseg_pamr_fold(const void* aff, const void* mask, void* out,
                              const int* plan, int n_taps, int n_groups,
                              int B, int C, int H, int W, int num_iter,
                              int block, int bf16_store, void* stream) {
  return run_simt<false>(aff, mask, out, plan, n_taps, n_groups, B, C, H, W,
                        num_iter, block, bf16_store, stream);
}

extern "C" int wseg_pamr_dxfirst(const void* aff, const void* mask, void* out,
                                 const int* plan, int n_taps, int n_groups,
                                 int B, int C, int H, int W, int num_iter,
                                 int block, int bf16_store, void* stream) {
  return run_simt<true>(aff, mask, out, plan, n_taps, n_groups, B, C, H, W,
                       num_iter, block, bf16_store, stream);
}

extern "C" int wseg_pamr_mxu(const void* aff, const void* mask, void* out,
                             const int* plan_rows, int n_taps, int n_groups,
                             int B, int C, int H, int W, int num_iter,
                             int block, int pad, int passes, void* stream) {
  Plan plan;
  const int tiles = ((block * H + 15) / 16) * ((W + 7) / 8);
  if (!fill_plan(plan_rows, n_taps, n_groups, &plan) || B <= 0 || C <= 0 ||
      H <= 0 || W <= 0 || num_iter < 0 || block < 1 || pad < 0 ||
      (passes != 1 && passes != 3) || tiles > kMmaWarps * kMaxTilesPerWarp ||
      static_cast<long long>(block) * H * W * 4 > smem_optin()) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int cblocks = (C + block - 1) / block;
  const size_t smem = static_cast<size_t>(block) * H * W * sizeof(float);
  auto kernel = passes == 3 ? &pamr_mxu_kernel<3> : &pamr_mxu_kernel<1>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<B * cblocks, kMmaThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(aff), static_cast<const float*>(mask),
      static_cast<float*>(out), plan, C, H, W, num_iter, block, cblocks, pad);
  return static_cast<int>(cudaGetLastError());
}

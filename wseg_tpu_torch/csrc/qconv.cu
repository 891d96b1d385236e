// w8a8 convolution of the int8 serving mode on Hopper (sm_90a), plain C
// interface: an activation-quantize kernel and an int8 tensor-core
// implicit-GEMM conv.
//
// Replaces no Pallas kernel.  The JAX package's QuantConv
// (wseg_tpu/models/backbones/common.py, NET.DTYPE int8) leaves XLA to
// fuse quantize -> int8 x int8 -> int32 conv -> dequantize into one
// program; PyTorch has no CUDA int8 convolution, so the port writes both
// halves by hand.  Their arithmetic is QuantConv's, operation for
// operation, so the outputs are bit-equal to the plain versions in
// ops/qconv.py (and to JAX's):
//
//   dynamic:  sx[b] = max(max |x[b]|, 1e-12) / 127      (per image)
//             xq    = clip(rint(x / sx[b]), -127, 127)
//             y     = f32(acc) * (sx[b] * sw[o])
//   static:   xq    = clip(rint(x / sc[c]), -127, 127)  (per channel)
//             y     = f32(acc) * sw[o]
//   then      y + bias[o] (float32), rounded once to bfloat16.
//
// Every division is __fdiv_rn, every multiply and add __fmul_rn /
// __fadd_rn (no FMA contraction), rint rounds half to even (jnp.round,
// torch.round), and the file must not be built with -use_fast_math.
//
// quantize_act: x bfloat16 (B, C, H, W) with any strides (the model's
// activations are channels_last, so the NHWC relayout is a plain read)
// -> xq int8 (B, H, W, Cp), Cp = C rounded up to 32, zero-filled.
// Dynamic mode launches twice: a per-image |x| max (a grid-stride
// block reduction, then atomicMax on the float's bits, exact because
// the values are non-negative) and the quantize pass, which also writes
// sx.  Static mode is the quantize pass alone with the caller's sc.
// What bounds it: bytes (one bf16 read, twice in dynamic mode, and one
// int8 write).
//
// qconv_s8: implicit GEMM, M = B * Ho * Wo output pixels, N = Cout,
// K = kh * kw * Cp.  A block computes a 128 x 128 tile of (pixel, cout)
// with 8 warps of 64 x 32, each mma.sync.m16n8k32 s8 x s8 -> s32.  K
// moves 32 bytes (one tap's 32 channels) a step through a 3-stage
// cp.async ring: the A rows are gathered from xq at (ho * stride - pad
// + ky * dil, wo * stride - pad + kx * dil), zero-filled outside the
// image, the B rows are wq packed (Cout, kh, kw, Cp) by the wrapper
// once per weight set.  Shared rows are 48 bytes, so the fragment loads
// (8 rows x 4 words a warp) hit 32 distinct banks.  The epilogue
// dequantizes and writes bf16 NHWC (the channels_last layout of the
// logical NCHW output) two channels a store, or with `acc_out` the int32
// sums themselves.
// int32 cannot overflow: 9 * 4096 * 127^2 < 2^31.
// What bounds it: int8 operations at 1,979 TOPS for the backbone's
// wide convs, bytes for the narrow ones.  This first design reaches
// the tensor cores through mma.sync, not wgmma and TMA (ROADMAP B12).
//
// Launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kCpAlign = 32;   // Cp: channels padded to a multiple of this
constexpr int kBM = 128;       // output pixels of a block tile
constexpr int kBN = 128;       // output channels of a block tile
constexpr int kBK = 32;        // K bytes a pipeline step
constexpr int kStages = 3;     // cp.async ring depth
constexpr int kRow = kBK + 16; // shared row pitch: conflict-free fragments
constexpr int kThreads = 256;  // 8 warps: 2 along M x 4 along N
constexpr int kQThreads = 256; // quantize and |x| max blocks
constexpr int kMaxAbsBlocks = 2048;

struct Geom {
  int B, H, W, Cp, Cout, kh, kw, stride, pad, dil, Ho, Wo;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;  // 0: zero fill, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// max |x| over each image's `per_image` contiguous elements, into the
// bits of amax_bits[b] (zeroed by the caller); grid (blocks, B)
__global__ void __launch_bounds__(kQThreads)
absmax_kernel(const __nv_bfloat16* __restrict__ x, long long per_image,
              long long image_stride, int vec,
              unsigned* __restrict__ amax_bits) {
  const __nv_bfloat16* xb = x + blockIdx.y * image_stride;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  float m = 0.0f;
  if (vec) {
    const uint4* v = reinterpret_cast<const uint4*>(xb);
    const long long n8 = per_image / 8;
    for (long long i = first; i < n8; i += step) {
      const uint4 u = v[i];
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(h[j]);
        m = fmaxf(m, fmaxf(fabsf(f.x), fabsf(f.y)));
      }
    }
  } else {
    for (long long i = first; i < per_image; i += step) {
      m = fmaxf(m, fabsf(__bfloat162float(xb[i])));
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  }
  __shared__ float warp_max[kQThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_max[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < kQThreads / 32 ? warp_max[lane] : 0.0f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    }
    if (lane == 0) atomicMax(amax_bits + blockIdx.y, __float_as_uint(m));
  }
}

// one thread a 16-channel group of one pixel: xq[b, h, w, c0:c0+16];
// per image (amax_bits) or per channel (sc) scales.  kVec: the 16
// channels are contiguous and 16-byte aligned in x (channels_last, C a
// multiple of 16), read as two 16-byte loads.
template <bool kVec>
__global__ void __launch_bounds__(kQThreads)
quantize_kernel(const __nv_bfloat16* __restrict__ x, long long sB,
                long long sC, long long sH, long long sW, int C, int H,
                int W, int Cp, const unsigned* __restrict__ amax_bits,
                const float* __restrict__ sc, float* __restrict__ sx_out,
                int8_t* __restrict__ xq, long long total) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int groups = Cp / 16;
  const int c0 = static_cast<int>(i % groups) * 16;
  const long long p = i / groups;
  const int w = static_cast<int>(p % W);
  const long long t = p / W;
  const int h = static_cast<int>(t % H);
  const int b = static_cast<int>(t / H);
  float s_img = 0.0f;
  if (amax_bits != nullptr) {
    s_img = __fdiv_rn(fmaxf(__uint_as_float(amax_bits[b]), 1e-12f), 127.0f);
    if (c0 == 0 && h == 0 && w == 0) sx_out[b] = s_img;
  }
  const __nv_bfloat16* xp = x + b * sB + h * sH + w * sW;
  float f[16];
  if (kVec) {
    if (c0 < C) {
      const uint4* v = reinterpret_cast<const uint4*>(xp + c0);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const uint4 raw = v[u];
        const __nv_bfloat162* h2 =
            reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 p2 = __bfloat1622float2(h2[j]);
          f[u * 8 + 2 * j] = p2.x;
          f[u * 8 + 2 * j + 1] = p2.y;
        }
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      f[j] = c0 + j < C ? __bfloat162float(xp[(c0 + j) * sC]) : 0.0f;
    }
  }
  alignas(16) int8_t q[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int c = c0 + j;
    float r = 0.0f;
    if (c < C) {
      const float s = amax_bits != nullptr ? s_img : sc[c];
      r = fminf(fmaxf(rintf(__fdiv_rn(f[j], s)), -127.0f), 127.0f);
    }
    q[j] = static_cast<int8_t>(static_cast<int>(r));
  }
  *reinterpret_cast<int4*>(xq + i * 16) = *reinterpret_cast<const int4*>(q);
}

__global__ void __launch_bounds__(kThreads)
qconv_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ wq,
             const float* __restrict__ sx, const float* __restrict__ sw,
             const float* __restrict__ bias,
             __nv_bfloat16* __restrict__ out, int* __restrict__ acc_out,
             Geom g) {
  __shared__ __align__(16) int8_t As[kStages][kBM][kRow];
  __shared__ __align__(16) int8_t Bs[kStages][kBN][kRow];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warp_m = warp >> 2, warp_n = warp & 3;
  const long long M = static_cast<long long>(g.B) * g.Ho * g.Wo;
  const long long m0 = static_cast<long long>(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * kBN;
  const int K = g.kh * g.kw * g.Cp;
  const int nk = K / kBK;

  // this thread's 16-byte copy slot, the same row of both tiles
  const int lrow = tid >> 1, lhalf = (tid & 1) * 16;
  const long long am = m0 + lrow;
  const bool a_valid = am < M;
  int hi0 = 0, wi0 = 0;
  const int8_t* a_img = xq;
  if (a_valid) {
    const int wo = static_cast<int>(am % g.Wo);
    const long long t = am / g.Wo;
    const int ho = static_cast<int>(t % g.Ho);
    const long long b = t / g.Ho;
    hi0 = ho * g.stride - g.pad;
    wi0 = wo * g.stride - g.pad;
    a_img = xq + b * g.H * g.W * g.Cp;
  }
  const bool b_valid = n0 + lrow < g.Cout;
  const int8_t* b_row =
      wq + static_cast<long long>(b_valid ? n0 + lrow : 0) * K;

  auto load = [&](int stage, int kt) {
    const int k0 = kt * kBK;
    const int tap = k0 / g.Cp;
    const int c = k0 - tap * g.Cp;
    const int ky = tap / g.kw, kx = tap - ky * g.kw;
    const int hi = hi0 + ky * g.dil, wi = wi0 + kx * g.dil;
    const bool ok =
        a_valid && hi >= 0 && hi < g.H && wi >= 0 && wi < g.W;
    const int8_t* src =
        ok ? a_img + (static_cast<long long>(hi) * g.W + wi) * g.Cp + c +
                 lhalf
           : xq;
    cp_async16(&As[stage][lrow][lhalf], src, ok);
    cp_async16(&Bs[stage][lrow][lhalf], b_valid ? b_row + k0 + lhalf : wq,
               b_valid);
  };

  int acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  const int g8 = lane >> 2, t4 = (lane & 3) * 4;
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int nxt = kt + kStages - 1;
    if (nxt < nk) load(nxt % kStages, nxt);
    cp_async_commit();
    const int st = kt % kStages;
    uint32_t a[4][4], b[4][2];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      const int r = warp_m * 64 + mt * 16 + g8;
      a[mt][0] = ld32(&As[st][r][t4]);
      a[mt][1] = ld32(&As[st][r + 8][t4]);
      a[mt][2] = ld32(&As[st][r][16 + t4]);
      a[mt][3] = ld32(&As[st][r + 8][16 + t4]);
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int r = warp_n * 32 + nt * 8 + g8;
      b[nt][0] = ld32(&Bs[st][r][t4]);
      b[nt][1] = ld32(&Bs[st][r][16 + t4]);
    }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) mma_s8(acc[mt][nt], a[mt], b[nt]);
  }
  cp_async_wait<0>();

  // accumulator (mt, nt, e): row g8 + 8 * (e / 2), column 2 * (lane % 4)
  // + e % 2 of the warp's 16 x 8 tile (mt, nt)
  const long long hw = static_cast<long long>(g.Ho) * g.Wo;
  const int t2 = (lane & 3) * 2;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long m = m0 + warp_m * 64 + mt * 16 + g8 + half * 8;
      if (m >= M) continue;
      const float sxb = sx != nullptr ? sx[m / hw] : 0.0f;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int n = n0 + warp_n * 32 + nt * 8 + t2;
        if (n >= g.Cout) continue;
        const long long o = m * g.Cout + n;  // even where Cout is
        const bool pair = n + 1 < g.Cout && (g.Cout & 1) == 0;
        const int v0 = acc[mt][nt][half * 2];
        const int v1 = acc[mt][nt][half * 2 + 1];
        if (acc_out != nullptr) {
          if (pair) {
            *reinterpret_cast<int2*>(acc_out + o) = make_int2(v0, v1);
          } else {
            acc_out[o] = v0;
            if (n + 1 < g.Cout) acc_out[o + 1] = v1;
          }
          continue;
        }
        const int n1 = n + 1 < g.Cout ? n + 1 : n;
        const float s0 = sx != nullptr ? __fmul_rn(sxb, sw[n]) : sw[n];
        const float s1 = sx != nullptr ? __fmul_rn(sxb, sw[n1]) : sw[n1];
        float y0 = __fmul_rn(__int2float_rn(v0), s0);
        float y1 = __fmul_rn(__int2float_rn(v1), s1);
        if (bias != nullptr) {
          y0 = __fadd_rn(y0, bias[n]);
          y1 = __fadd_rn(y1, bias[n1]);
        }
        if (pair) {
          *reinterpret_cast<__nv_bfloat162*>(out + o) =
              __halves2bfloat162(__float2bfloat16_rn(y0),
                                 __float2bfloat16_rn(y1));
        } else {
          out[o] = __float2bfloat16_rn(y0);
          if (n + 1 < g.Cout) out[o + 1] = __float2bfloat16_rn(y1);
        }
      }
    }
  }
}

}  // namespace

// The kernels' fixed geometry: {Cp alignment, tile M, tile N, threads}
// (ops/qconv.py's LIMITS; change both together).
extern "C" int wseg_qconv_limits(int* out) {
  const int limits[] = {kCpAlign, kBM, kBN, kThreads};
  const int n = static_cast<int>(sizeof(limits) / sizeof(limits[0]));
  for (int e = 0; e < n; ++e) out[e] = limits[e];
  return n;
}

// x bf16 (B, C, H, W) at element strides (sB, sC, sH, sW) -> xq int8
// (B, H, W, Cp).  Static mode: sc (C) float32, amax_bits and sx null.
// Dynamic mode: sc null, amax_bits (B) zeroed, sx (B) float32 out; the
// |x| max reads each image's C*H*W elements as one run from x + b*sB
// (the wrapper passes a dense NCHW or channels_last tensor), 16 bytes
// at a time where `vec`.
extern "C" int wseg_quantize_act(const void* x, long long sB, long long sC,
                                 long long sH, long long sW, int B, int C,
                                 int H, int W, int Cp, const float* sc,
                                 void* amax_bits, float* sx, void* xq,
                                 int vec, void* stream) {
  if (x == nullptr || xq == nullptr || B <= 0 || C <= 0 || H <= 0 ||
      W <= 0 || Cp < C || Cp % kCpAlign != 0 ||
      (sc == nullptr) == (amax_bits == nullptr) ||
      (amax_bits != nullptr && sx == nullptr) ||
      reinterpret_cast<uintptr_t>(xq) % 16 != 0 ||
      (vec && reinterpret_cast<uintptr_t>(x) % 16 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  unsigned* bits = static_cast<unsigned*>(amax_bits);
  if (bits != nullptr) {
    const long long per_image = static_cast<long long>(C) * H * W;
    if (vec && (per_image % 8 != 0 || sB % 8 != 0)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const long long items = vec ? per_image / 8 : per_image;
    long long nb = (items + kQThreads * 8 - 1) / (kQThreads * 8);
    nb = nb < 1 ? 1 : (nb > kMaxAbsBlocks ? kMaxAbsBlocks : nb);
    absmax_kernel<<<dim3(static_cast<unsigned>(nb), B), kQThreads, 0, s>>>(
        xb, per_image, sB, vec, bits);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long total = static_cast<long long>(B) * H * W * (Cp / 16);
  const long long blocks = (total + kQThreads - 1) / kQThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  // 16-byte loads where each 16-channel group is contiguous and aligned
  const bool cvec = sC == 1 && C % 16 == 0 && sB % 8 == 0 && sH % 8 == 0 &&
                    sW % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (cvec) {
    quantize_kernel<true><<<static_cast<unsigned>(blocks), kQThreads, 0, s>>>(
        xb, sB, sC, sH, sW, C, H, W, Cp, bits, sc, sx,
        static_cast<int8_t*>(xq), total);
  } else {
    quantize_kernel<false><<<static_cast<unsigned>(blocks), kQThreads, 0,
                             s>>>(xb, sB, sC, sH, sW, C, H, W, Cp, bits, sc,
                                  sx, static_cast<int8_t*>(xq), total);
  }
  return static_cast<int>(cudaGetLastError());
}

// xq int8 (B, H, W, Cp), wq int8 (Cout, kh, kw, Cp), sx (B) float32 or
// null (static mode), sw (Cout) float32, bias (Cout) float32 or null ->
// out bf16 (B, Ho, Wo, Cout), or with acc_out the int32 sums there
// (out then unused).  Square stride, padding and dilation.
extern "C" int wseg_qconv_s8(const void* xq, const void* wq, const float* sx,
                             const float* sw, const float* bias, void* out,
                             void* acc_out, int B, int H, int W, int Cp,
                             int Cout, int kh, int kw, int stride, int pad,
                             int dil, int Ho, int Wo, void* stream) {
  if (xq == nullptr || wq == nullptr || sw == nullptr ||
      (out == nullptr && acc_out == nullptr) || B <= 0 || H <= 0 ||
      W <= 0 || Cp <= 0 || Cp % kCpAlign != 0 || Cout <= 0 || kh <= 0 ||
      kw <= 0 || stride <= 0 || pad < 0 || dil <= 0 ||
      Ho != (H + 2 * pad - dil * (kh - 1) - 1) / stride + 1 ||
      Wo != (W + 2 * pad - dil * (kw - 1) - 1) / stride + 1 || Ho <= 0 ||
      Wo <= 0 || reinterpret_cast<uintptr_t>(xq) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(wq) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long M = static_cast<long long>(B) * Ho * Wo;
  const long long mb = (M + kBM - 1) / kBM;
  const int nb = (Cout + kBN - 1) / kBN;
  if (mb > 0x7fffffffLL || nb > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Geom g{B, H, W, Cp, Cout, kh, kw, stride, pad, dil, Ho, Wo};
  qconv_kernel<<<dim3(static_cast<unsigned>(mb), nb), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(xq), static_cast<const int8_t*>(wq), sx, sw,
      bias, static_cast<__nv_bfloat16*>(out), static_cast<int*>(acc_out), g);
  return static_cast<int>(cudaGetLastError());
}

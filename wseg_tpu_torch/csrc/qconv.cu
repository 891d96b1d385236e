// w8a8 convolution of the int8 serving mode on Hopper (sm_90a), plain C
// interface: an activation-quantize kernel and an int8 implicit-GEMM conv
// on wgmma.
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
// Every division is exact (see quantize_act), every multiply and add
// __fmul_rn / __fadd_rn (no FMA contraction), rint rounds half to even
// (jnp.round, torch.round), and the file must not be built with
// -use_fast_math.
//
// quantize_act: x bfloat16 (B, C, H, W) with any strides (the model's
// activations are channels_last, so the NHWC relayout is a plain read)
// -> xq int8 (B, H, W, Cp), Cp = C rounded up to 32, zero-filled.  What
// bounds it: bytes, one bf16 read and one int8 write.  One launch in
// both modes.  A block owns a fixed run of each image's pixels; a thread
// takes 16 channels of a pixel (two 16-byte loads on channels_last
// inputs, one 16-byte store), keeps one channel group where the groups
// divide the block (static mode's RN(1/sc) then sit in registers), and
// indexes in 32 bits; 64 registers, four blocks an SM, keep enough loads
// in flight.  Dynamic mode needs an image's |x| max before its first
// code: the blocks of an image reduce their runs, publish the maxima
// (atomicMax on the float's bits, exact for non-negative values) and an
// arrival count, wait for the image's last block, and quantize the same
// runs again from L2 (the reads mark their lines evict_last, the second
// read and the xq stores evict_first), so each input byte comes from
// device memory once while the image fits.  Per-image counters rather
// than a grid barrier: the co-resident grid (a cooperative launch sized
// by the occupancy calculator) splits into `slots` groups that walk the
// images, so while one group waits for an image's last block, another
// reads; the host plan (ops/qconv.py quantize_slots) keeps about 26 MB of
// images in flight, the best of 1-16 at each input of the flagship
// bucket.  A whole image staged in shared memory (one bulk copy, both
// passes there) measured slower: an image's wait then idles every SM.
// The division: x * RN(1/s) rounded to an integer equals rint(RN(x / s))
// unless the product lies within 2^-12 of a half-integer (its error is
// below 2^-22 at the codes that survive the clip), and only those values
// take __fdiv_rn; the plain versions divide, and
// tests/test_torch_qconv_kernels.py checks the rule against IEEE
// division over every finite bfloat16 value at many scales.
//
// qconv_s8: implicit GEMM, M = B * Ho * Wo output pixels, N = Cout,
// K = kh * kw * Cp, both operands K-major int8 as wgmma takes them: xq
// (pixels x Cp) and wq (Cout x kh*kw*Cp, packed by the wrapper once per
// weight set).  What bounds it: int8 operations at 1,979 TOPS on the
// wide convs, the bf16 output's bytes on the 1x1 stride-2 ones.  A
// persistent block per SM walks (M, N) tiles of 128 pixels x BN
// channels (BN 64, 128 or 256, host plan), N fastest, so the N tiles of
// one input patch run on neighbouring blocks and share it in L2.  The
// M tile is a patch of Mh x Mw output pixels of one image, so one TMA
// load per tap fetches its A rows: a 4-D tensor map over xq (Cp, W, H,
// B) with element strides (1, stride, stride, 1), the box (BK, Mw *
// stride, Mh * stride, 1) at (c, wo0 * stride - pad + kx * dil, ho0 *
// stride - pad + ky * dil, b); TMA zero-fills what falls outside the
// image, negative coordinates included, which is the conv's padding at
// any dilation (a tiled map per tap rather than TMA's im2col mode: the
// patch keeps an M tile inside one image, so a tile has one sx).  B is
// a 2-D map over wq.  A ring stage holds 128 bytes of K as 128/BK
// chunks of one tap each (BK = 128, 64 or 32 by Cp, swizzled 128, 64
// or 32 bytes to match; a short last stage loads boxes wholly outside
// the tensors, zeros, so every wgmma issues unconditionally), as many
// stages as fit in the 227 KB of shared memory (4 at BN 256, 6 below),
// guarded by full and empty mbarriers.  The ring's depth is what the
// TMA latency asks for: a fourth stage at BN 256 took the flagship
// bucket's convs from 10.49 to 9.74 ms (NVIDIA H100 80GB HBM3, 700.00
// W), where clusters of two blocks sharing each B stage by multicast,
// which halve the weights' L2 traffic, were 6% slower.  One producer
// thread issues the loads; two consumer warpgroups (setmaxnreg 232
// against the producer's 40) each run wgmma.mma_async
// m64nBNk32.s32.s8.s8 on their 64 rows from shared memory, keeping one
// stage's group in flight.  The epilogue keeps the plain arithmetic
// (__fmul_rn(__int2float_rn(acc), sx[b] * sw[o]), __fadd_rn of the
// bias, one rounding to bf16), stages the bf16 rows 128 channels at a
// time in 128-byte swizzled shared memory (conflict-free) and leaves by
// TMA stores, which clip the ragged Ho, Wo and Cout edges and run while
// the warpgroup starts its next tile; the producer already filled that
// tile's ring during the epilogue.  Cout not a multiple of 8 (no
// 16-byte row pitch for TMA) and `acc_out` (the int32 check) store from
// registers.  int32 cannot overflow: 9 * 4096 * 127^2 < 2^31.
//
// Launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError().  Every mbarrier and arrival wait traps after about
// five seconds, so a fault shows as a launch failure and not a hang.

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from
                   // cudaGetDriverEntryPointByVersion, so no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kCpAlign = 32;      // Cp: channels padded to a multiple of this
constexpr int kBM = 128;          // output pixels of a tile
constexpr int kStageK = 128;      // K bytes a ring stage
constexpr int kThreads = 384;     // consumer warpgroups 0-1, producer 2
constexpr int kMaxStages = 6;
constexpr int kStageCols = 128;   // output channels staged at a time
constexpr int kSmemLimit = 232448;  // dynamic shared memory of a block
constexpr int kQThreads = 256;    // quantize blocks
constexpr int kMaxStaticC = 12288;  // static RN(1/sc) in shared memory
constexpr float kTieTol = 2.44140625e-4f;  // 2^-12
constexpr long long kHangCycles = 10000000000LL;  // ~5 s at 1.98 GHz

struct Geom {
  int B, H, W, Cp, Cout, kh, kw, stride, pad, dil, Ho, Wo;
  int bk, mh, mw, stages;              // the host plan
  int tiles_w, tiles_h, tiles_n, tiles;  // patches across, down; N tiles
  int cpb, chunks, nks;  // BK chunks a tap, a tile; ring stages a tile
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// until the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try(bar, parity)) {
    if (clock64() - t0 > kHangCycles) __trap();
  }
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::
          "r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.tile.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// the committed stores have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// generic-proxy shared memory writes -> visible to TMA
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void st_shared_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma issue and wait
template <int R>
__device__ __forceinline__ void fence_acc(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// wgmma shared-memory descriptor of a K-major tile: 8-row groups of
// `bk`-byte rows (stride 8 * bk bytes), swizzled as TMA's
// CU_TENSOR_MAP_SWIZZLE_{bk}B laid them out (the tile 1024-byte aligned)
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, int bk,
                                              uint64_t layout) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) | (1ull << 16) |
         (static_cast<uint64_t>((8 * bk) >> 4) << 32) | layout;
}

// d[64 x N] (+)= A[64 x 32] * B[N x 32]^T, s8 x s8 -> s32; accumulator
// element i of a thread: row (warp % 4) * 16 + lane / 4 + 8 * ((i / 2) % 2),
// column (i / 4) * 8 + (lane % 4) * 2 + i % 2
template <int N>
__device__ __forceinline__ void wgmma(int (&d)[N / 2], uint64_t a,
                                      uint64_t b, int accumulate);

template <>
__device__ __forceinline__ void wgmma<64>(int (&d)[32], uint64_t a,
                                          uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma<128>(int (&d)[64], uint64_t a,
                                          uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma<256>(int (&d)[128], uint64_t a,
                                          uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]),
        "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]),
        "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]),
        "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
        "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]),
        "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]),
        "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void decode_tile(const Geom& g, int bn, int t,
                                            int& b, int& ho0, int& wo0,
                                            int& n0) {
  const int mt = t / g.tiles_n;
  n0 = (t - mt * g.tiles_n) * bn;
  const int r = mt / g.tiles_w;
  wo0 = (mt - r * g.tiles_w) * g.mw;
  b = r / g.tiles_h;
  ho0 = (r - b * g.tiles_h) * g.mh;
}

template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
qconv_kernel(const __grid_constant__ CUtensorMap map_a,
             const __grid_constant__ CUtensorMap map_b,
             const __grid_constant__ CUtensorMap map_out,
             const float* __restrict__ sx, const float* __restrict__ sw,
             const float* __restrict__ bias,
             __nv_bfloat16* __restrict__ out, int* __restrict__ acc_out,
             int tma_store, Geom g) {
  extern __shared__ uint8_t smem_raw[];
  constexpr int kStageA = kBM * kStageK;
  constexpr int kStageB = BN * kStageK;
  const uint32_t ring_a = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t ring_b = ring_a + g.stages * kStageA;
  constexpr int kStaged = BN < kStageCols ? BN : kStageCols;
  const uint32_t staging = ring_b + g.stages * kStageB;  // 128 x kStaged
  const uint32_t full = staging + kBM * kStaged * 2;  // full[s], empty[s]
  const uint32_t empty = full + 8 * kMaxStages;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < g.stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);  // the consumers' eight warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {
    // producer warpgroup: one thread issues every TMA load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp == 8 && lane == 0) {
      const int per_stage = kStageK / g.bk;
      const uint32_t chunk_tx = (kBM + BN) * g.bk;
      int it = 0;
      for (int t = blockIdx.x; t < g.tiles; t += gridDim.x) {
        int b, ho0, wo0, n0;
        decode_tile(g, BN, t, b, ho0, wo0, n0);
        const int hi0 = ho0 * g.stride - g.pad, wi0 = wo0 * g.stride - g.pad;
        for (int ks = 0; ks < g.nks; ++ks, ++it) {
          const int s = it % g.stages;
          mbar_wait(empty + 8 * s, ((it / g.stages) & 1) ^ 1);
          mbar_expect_tx(full + 8 * s, per_stage * chunk_tx);
          for (int q = 0; q < per_stage; ++q) {
            // chunks past the tile's K load boxes wholly outside the
            // tensors: zeros, so every stage runs all its products
            const int j = ks * per_stage + q;
            int c = g.Cp, wi = wi0, hi = hi0;
            if (j < g.chunks) {
              const int tap = j / g.cpb;
              const int ky = tap / g.kw, kx = tap - ky * g.kw;
              c = (j - tap * g.cpb) * g.bk;
              wi += kx * g.dil;
              hi += ky * g.dil;
            }
            tma_load_4d(ring_a + s * kStageA + q * kBM * g.bk, &map_a,
                        full + 8 * s, c, wi, hi, b);
            tma_load_2d(ring_b + s * kStageB + q * BN * g.bk, &map_b,
                        full + 8 * s, j * g.bk, n0);
          }
        }
      }
    }
  } else {
    // consumer warpgroup cw: the tile's rows cw * 64 .. cw * 64 + 63
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int cw = warp >> 2;
    const uint64_t layout = g.bk == 128 ? (1ull << 62)
                            : g.bk == 64 ? (2ull << 62)
                                         : (3ull << 62);
    const int row_w = (warp & 3) * 16 + (lane >> 2);  // + 8 * half
    const int col_t = (lane & 3) * 2;                 // + 8 * j
    const uint32_t stage_rows = staging + cw * 64 * kStaged * 2;
    const bool leader = (tid & 127) == 0;
    int acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    int it = 0;
    for (int t = blockIdx.x; t < g.tiles; t += gridDim.x) {
      int b, ho0, wo0, n0;
      decode_tile(g, BN, t, b, ho0, wo0, n0);
      int prev = 0;
      for (int ks = 0; ks < g.nks; ++ks, ++it) {
        const int s = it % g.stages;
        mbar_wait(full + 8 * s, (it / g.stages) & 1);
        fence_acc(acc);
        wgmma_fence();
#pragma unroll
        for (int st = 0; st < kStageK / 32; ++st) {
          const int q = (st * 32) / g.bk, kin = st * 32 - q * g.bk;
          const uint32_t a = ring_a + s * kStageA + q * kBM * g.bk +
                             cw * 64 * g.bk + kin;
          const uint32_t bb = ring_b + s * kStageB + q * BN * g.bk + kin;
          wgmma<BN>(acc, smem_desc(a, g.bk, layout),
                    smem_desc(bb, g.bk, layout), (ks | st) != 0);
        }
        wgmma_commit();
        wgmma_wait<1>();  // the previous stage's products are done
        fence_acc(acc);
        if (ks > 0 && lane == 0) mbar_arrive(empty + 8 * prev);
        prev = s;
      }
      wgmma_wait<0>();
      fence_acc(acc);
      if (lane == 0) mbar_arrive(empty + 8 * prev);

      const float sxb = sx != nullptr ? sx[b] : 0.0f;
      if (tma_store) {
        // kStageCols channels at a time (BN 256: two passes, so that the
        // ring keeps a fourth stage)
        constexpr int kCols = BN < kStageCols ? BN : kStageCols;
#pragma unroll
        for (int pass = 0; pass < BN / kCols; ++pass) {
          if (leader) bulk_wait_read();  // the staged rows are out
          named_sync(1 + cw, 128);
#pragma unroll
          for (int jj = 0; jj < kCols / 8; ++jj) {
            const int j = pass * (kCols / 8) + jj;
            const int col = j * 8 + col_t;
            const int n = min(n0 + col, g.Cout - 2);  // TMA clips n >= Cout
            const float s0 = sx != nullptr ? __fmul_rn(sxb, sw[n]) : sw[n];
            const float s1 =
                sx != nullptr ? __fmul_rn(sxb, sw[n + 1]) : sw[n + 1];
            const float b0 = bias != nullptr ? bias[n] : 0.0f;
            const float b1 = bias != nullptr ? bias[n + 1] : 0.0f;
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              float y0 = __fmul_rn(__int2float_rn(acc[4 * j + 2 * half]), s0);
              float y1 =
                  __fmul_rn(__int2float_rn(acc[4 * j + 2 * half + 1]), s1);
              if (bias != nullptr) {
                y0 = __fadd_rn(y0, b0);
                y1 = __fadd_rn(y1, b1);
              }
              const __nv_bfloat162 v = __halves2bfloat162(
                  __float2bfloat16_rn(y0), __float2bfloat16_rn(y1));
              const int row = row_w + 8 * half;
              const int c64 = col & 63;
              st_shared_u32(stage_rows + ((col % kCols) >> 6) * 8192 +
                                row * 128 +
                                ((((c64 >> 3) ^ (row & 7))) << 4) +
                                (c64 & 7) * 2,
                            *reinterpret_cast<const uint32_t*>(&v));
            }
          }
          fence_proxy_async();
          named_sync(1 + cw, 128);
          if (leader) {
            const int r0 = cw * 64;
#pragma unroll
            for (int sub = 0; sub < kCols / 64; ++sub) {
              tma_store_4d(&map_out, stage_rows + sub * 8192,
                           n0 + pass * kCols + sub * 64, wo0 + r0 % g.mw,
                           ho0 + r0 / g.mw, b);
            }
            bulk_commit();
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int n = n0 + j * 8 + col_t;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int r = cw * 64 + row_w + 8 * half;
            const int ho = ho0 + r / g.mw, wo = wo0 + r % g.mw;
            if (ho >= g.Ho || wo >= g.Wo) continue;
            const long long o =
                ((static_cast<long long>(b) * g.Ho + ho) * g.Wo + wo) *
                    g.Cout + n;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              if (n + e >= g.Cout) continue;
              const int v = acc[4 * j + 2 * half + e];
              if (acc_out != nullptr) {
                acc_out[o + e] = v;
                continue;
              }
              const float sc = sx != nullptr ? __fmul_rn(sxb, sw[n + e])
                                             : sw[n + e];
              float y = __fmul_rn(__int2float_rn(v), sc);
              if (bias != nullptr) y = __fadd_rn(y, bias[n + e]);
              out[o + e] = __float2bfloat16_rn(y);
            }
          }
        }
      }
    }
    if (tma_store && leader) bulk_wait();
  }
}

// code of one value: rint(x / s) clipped to +-127, from x * RN(1/s)
// unless that product lies within 2^-12 of a half-integer (s is read
// only then)
__device__ __forceinline__ int quant_code(float v, float inv,
                                          const float* s) {
  const float r = __fmul_rn(v, inv);
  float q = rintf(r);
  if (fabsf(__fsub_rn(r, q)) > 0.5f - kTieTol) q = rintf(__fdiv_rn(v, *s));
  return static_cast<int>(fminf(fmaxf(q, -127.0f), 127.0f));
}

struct QGeom {
  long long sB, sC, sH, sW;  // x's element strides
  int B, C, W, HW, Cp;
  int slots, per;  // image groups; blocks a group
};

// L2 eviction policies: the |x| max's reads stay for the quantize's
// second read, which leaves first, as do the xq stores
__device__ __forceinline__ uint64_t l2_policy(bool keep) {
  uint64_t p;
  if (keep) {
    asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n"
                 : "=l"(p));
  } else {
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
                 : "=l"(p));
  }
  return p;
}

__device__ __forceinline__ uint4 ld_hint(const void* p, uint64_t policy) {
  uint4 v;
  asm volatile(
      "ld.global.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p), "l"(policy));
  return v;
}

__device__ __forceinline__ void st_hint(void* p, const uint4& v,
                                        uint64_t policy) {
  asm volatile(
      "st.global.L2::cache_hint.v4.u32 [%0], {%1, %2, %3, %4}, %5;\n" ::"l"(
          p),
      "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "l"(policy)
      : "memory");
}

__device__ __forceinline__ void bf16x8(const uint4& u, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 p = __bfloat1622float2(h[j]);
    f[2 * j] = p.x;
    f[2 * j + 1] = p.y;
  }
}

// channels c0 .. c0 + 15 of pixel p (zeros past C)
template <bool kVec>
__device__ __forceinline__ void load16(const __nv_bfloat16* xb,
                                       const QGeom& g, int p, int c0,
                                       float (&f)[16], uint64_t policy) {
  if (kVec) {
    if (c0 < g.C) {
      const uint4* v = reinterpret_cast<const uint4*>(
          xb + static_cast<long long>(p) * g.C + c0);
      const uint4 u0 = ld_hint(v, policy), u1 = ld_hint(v + 1, policy);
      bf16x8(u0, f);
      bf16x8(u1, f + 8);
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j) f[j] = 0.0f;
    }
  } else {
    const int h = p / g.W, w = p - h * g.W;
    const __nv_bfloat16* xp = xb + h * g.sH + w * g.sW;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      f[j] = c0 + j < g.C ? __bfloat162float(xp[(c0 + j) * g.sC]) : 0.0f;
    }
  }
}

// the 16 codes of f into 16 bytes at dst; inv and s per channel
// (static: inv[e], s[e]) or one per image (dynamic: inv[0], s[0])
template <bool kPerChannel>
__device__ __forceinline__ void store16(int8_t* dst, const float (&f)[16],
                                        int c0, int C, const float* inv,
                                        const float* s, uint64_t policy) {
  uint32_t w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    uint32_t word = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int e = 4 * k + j;
      int code = 0;
      if (c0 + e < C) {
        code = kPerChannel ? quant_code(f[e], inv[e], s + e)
                           : quant_code(f[e], inv[0], s);
      }
      word |= (static_cast<uint32_t>(code) & 0xFFu) << (8 * j);
    }
    w[k] = word;
  }
  st_hint(dst, make_uint4(w[0], w[1], w[2], w[3]), policy);
}

// One image's |x| max across the blocks of a launch: each block adds
// its run's maximum and arrives; returns RN(max(max, 1e-12) / 127) to
// every thread once the image's `per` blocks have arrived (rank 0 also
// writes it to sx_out[b]).
template <int kThreadsN>
__device__ __forceinline__ float image_scale(float m, int b, int per,
                                             int rank, int B,
                                             unsigned* sync, float* sx_out,
                                             float* warp_max,
                                             float* img_scale) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  }
  if ((tid & 31) == 0) warp_max[tid >> 5] = m;
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < kThreadsN / 32; ++w) m = fmaxf(m, warp_max[w]);
    atomicMax(sync + b, __float_as_uint(m));
    __threadfence();
    atomicAdd(sync + B + b, 1u);
    const long long t0 = clock64();
    unsigned n;
    while (true) {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
                   : "=r"(n)
                   : "l"(sync + B + b)
                   : "memory");
      if (n >= static_cast<unsigned>(per)) break;
      if (clock64() - t0 > kHangCycles) __trap();
    }
    const float amax =
        __uint_as_float(*reinterpret_cast<volatile unsigned*>(sync + b));
    const float sb = __fdiv_rn(fmaxf(amax, 1e-12f), 127.0f);
    img_scale[0] = sb;
    img_scale[1] = __frcp_rn(sb);
    if (rank == 0) sx_out[b] = sb;
  }
  __syncthreads();
  return img_scale[0];
}

// kVec: x is dense channels_last with C a multiple of 16 (a pixel's
// channels one 16-byte aligned run).  Block `rank` of group `slot` owns
// pixels [p0, p1) of the images slot, slot + slots, ...  Where the 16-
// channel groups of a pixel divide the block, a thread keeps one group
// (its static RN(1/sc) in registers) and steps over pixels; otherwise it
// walks (pixel, group) items.  64 registers a thread: four blocks an SM
// keep enough loads in flight.
template <bool kDyn, bool kVec>
__global__ void __launch_bounds__(kQThreads, 4)
quantize_kernel(const __nv_bfloat16* __restrict__ x, QGeom g,
                const float* __restrict__ sc, unsigned* __restrict__ sync,
                float* __restrict__ sx_out, int8_t* __restrict__ xq) {
  extern __shared__ float inv_sc[];  // static, not fixed: RN(1/sc[c])
  __shared__ float warp_max[kQThreads / 32];
  __shared__ float img_scale[2];
  const int tid = threadIdx.x;
  const int slot = blockIdx.x / g.per, rank = blockIdx.x - slot * g.per;
  const int gout = g.Cp / 16;
  const bool fixed = kQThreads % gout == 0;
  const int pstep = fixed ? kQThreads / gout : 0;
  const int c0f = fixed ? (tid % gout) * 16 : 0;
  const uint64_t keep = l2_policy(true), leave = l2_policy(false);
  float inv16[16];  // static, fixed: this thread's channels
  if (!kDyn) {
    if (fixed) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        inv16[j] = __frcp_rn(sc[c0f + j < g.C ? c0f + j : 0]);
      }
    } else {
      for (int c = tid; c < g.C; c += kQThreads) inv_sc[c] = __frcp_rn(sc[c]);
      __syncthreads();
    }
  }
  const int p0 = static_cast<int>(static_cast<long long>(rank) * g.HW / g.per);
  const int p1 =
      static_cast<int>(static_cast<long long>(rank + 1) * g.HW / g.per);
  for (int b = slot; b < g.B; b += g.slots) {
    const __nv_bfloat16* xb = x + b * g.sB;
    int8_t* qb = xq + static_cast<long long>(b) * g.HW * g.Cp;
    float s = 0.0f, inv = 0.0f;
    if (kDyn) {
      float m = 0.0f;
      if (kVec) {
        const uint4* v = reinterpret_cast<const uint4*>(xb);
        const int e1 = p1 * (g.C / 8);
#pragma unroll 4
        for (int i = p0 * (g.C / 8) + tid; i < e1; i += kQThreads) {
          float f[8];
          bf16x8(ld_hint(v + i, keep), f);
#pragma unroll
          for (int j = 0; j < 8; ++j) m = fmaxf(m, fabsf(f[j]));
        }
      } else {
        for (int i = p0 * g.C + tid; i < p1 * g.C; i += kQThreads) {
          const int p = i / g.C, c = i - p * g.C;
          const int h = p / g.W, w = p - h * g.W;
          m = fmaxf(m, fabsf(__bfloat162float(
                           xb[c * g.sC + h * g.sH + w * g.sW])));
        }
      }
      s = image_scale<kQThreads>(m, b, g.per, rank, g.B, sync, sx_out,
                                 warp_max, img_scale);
      inv = img_scale[1];
    }
    if (fixed) {
      for (int p = p0 + tid / gout; p < p1; p += pstep) {
        float f[16];
        load16<kVec>(xb, g, p, c0f, f, leave);
        int8_t* d = qb + static_cast<long long>(p) * g.Cp + c0f;
        if (kDyn) {
          store16<false>(d, f, c0f, g.C, &inv, &s, leave);
        } else {
          store16<true>(d, f, c0f, g.C, inv16, sc + c0f, leave);
        }
      }
    } else {
      const int e1 = p1 * gout;
      for (int i = p0 * gout + tid; i < e1; i += kQThreads) {
        const int p = i / gout;
        const int c0 = (i - p * gout) * 16;
        float f[16];
        load16<kVec>(xb, g, p, c0, f, leave);
        int8_t* d = qb + static_cast<long long>(p) * g.Cp + c0;
        if (kDyn) {
          store16<false>(d, f, c0, g.C, &inv, &s, leave);
        } else {
          const int cc = c0 < g.C ? c0 : 0;  // pad groups read no scale
          store16<true>(d, f, c0, g.C, inv_sc + cc, sc + cc,
                        leave);
        }
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault,
                                         &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

CUtensorMapSwizzle swizzle_of(int bytes) {
  return bytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
         : bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                       : CU_TENSOR_MAP_SWIZZLE_32B;
}

// row-major tensor of `rank` dims, innermost first; strides in bytes of
// dims 1..rank-1
bool encode(CUtensorMap* map, CUtensorMapDataType type, int rank,
            const void* base, const cuuint64_t* dims,
            const cuuint64_t* strides, const cuuint32_t* box,
            const cuuint32_t* elem, CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encode_tiled();
  return fn != nullptr &&
         fn(map, type, static_cast<cuuint32_t>(rank), const_cast<void*>(base),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess) {
    return 0;
  }
  return n;
}

int qconv_smem(int bn, int stages) {
  return 1024 + stages * (kBM + bn) * kStageK +
         kBM * (bn < kStageCols ? bn : kStageCols) * 2 + 2 * kMaxStages * 8;
}

template <int BN>
cudaError_t launch_qconv(const CUtensorMap& ma, const CUtensorMap& mb,
                         const CUtensorMap& mo, const float* sx,
                         const float* sw, const float* bias,
                         __nv_bfloat16* out, int* acc_out, int tma_store,
                         const Geom& g, int grid, cudaStream_t s) {
  static bool ready = false;
  if (!ready) {
    const cudaError_t e = cudaFuncSetAttribute(
        qconv_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemLimit);
    if (e != cudaSuccess) return e;
    ready = true;
  }
  qconv_kernel<BN><<<grid, kThreads, qconv_smem(BN, g.stages), s>>>(
      ma, mb, mo, sx, sw, bias, out, acc_out, tma_store, g);
  return cudaGetLastError();
}

template <bool kDyn, bool kVec>
cudaError_t launch_quantize(const __nv_bfloat16* x, QGeom g, const float* sc,
                            unsigned* sync, float* sx, int8_t* xq,
                            cudaStream_t s) {
  // blocks a SM, once per instance (the grid must be co-resident)
  static int per_sm = 0;
  const size_t smem = kDyn ? 0 : 4 * static_cast<size_t>(g.C);
  if (per_sm == 0) {
    cudaError_t e = cudaFuncSetAttribute(
        quantize_kernel<kDyn, kVec>,
        cudaFuncAttributePreferredSharedMemoryCarveout,
        kDyn ? 0 : static_cast<int>(cudaSharedmemCarveoutDefault));
    if (e != cudaSuccess) return e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, quantize_kernel<kDyn, kVec>, kQThreads,
        kDyn ? 0 : 4 * kMaxStaticC);
    if (e != cudaSuccess) return e;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
  }
  const int blocks = per_sm * sm_count();
  if (g.slots > blocks) g.slots = blocks;  // images wait their turn
  g.per = blocks / g.slots;
  if (g.per < 1) return cudaErrorInvalidValue;
  const dim3 grid(g.per * g.slots), block(kQThreads);
  if (!kDyn) {
    quantize_kernel<kDyn, kVec><<<grid, block, smem, s>>>(x, g, sc, sync, sx,
                                                          xq);
    return cudaGetLastError();
  }
  void* args[] = {&x, &g, &sc, &sync, &sx, &xq};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(quantize_kernel<kDyn, kVec>), grid, block,
      args, smem, s);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

// The kernels' fixed geometry: {Cp alignment, tile pixels, K bytes a
// stage, threads, ring stages at most, shared memory bytes at most}
// (ops/qconv.py's LIMITS; change both together).
extern "C" int wseg_qconv_limits(int* out) {
  const int limits[] = {kCpAlign, kBM,        kStageK,
                        kThreads, kMaxStages, kSmemLimit};
  const int n = static_cast<int>(sizeof(limits) / sizeof(limits[0]));
  for (int e = 0; e < n; ++e) out[e] = limits[e];
  return n;
}

// x bf16 (B, C, H, W) at element strides (sB, sC, sH, sW) -> xq int8
// (B, H, W, Cp).  Static mode: sc (C) float32, sync and sx null.
// Dynamic mode: sc null, sync (2B) uint32 zeroed (|x| max bits, then
// arrival counts), sx (B) float32 out.  `slots`: images in flight
// (ops/qconv.py quantize_slots).
extern "C" int wseg_quantize_act(const void* x, long long sB, long long sC,
                                 long long sH, long long sW, int B, int C,
                                 int H, int W, int Cp, const float* sc,
                                 void* sync, float* sx, void* xq, int slots,
                                 void* stream) {
  const long long hw = static_cast<long long>(H) * W;
  if (x == nullptr || xq == nullptr || B <= 0 || C <= 0 || H <= 0 ||
      W <= 0 || Cp < C || Cp % kCpAlign != 0 || slots < 1 || slots > B ||
      (sc == nullptr) == (sync == nullptr) ||
      (sync != nullptr && sx == nullptr) ||
      (sc != nullptr && C > kMaxStaticC) ||
      hw * (Cp / 16) > 0x7fffffffLL || hw * C > 0x7fffffffLL ||
      reinterpret_cast<uintptr_t>(xq) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  QGeom g{sB, sC, sH, sW, B, C, W, static_cast<int>(hw), Cp, slots, 0};
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  // dense channels_last with 16-byte aligned 16-channel groups
  const bool vec = sC == 1 && sW == C && sH == static_cast<long long>(W) * C &&
                   C % 16 == 0 && sB % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned* sy = static_cast<unsigned*>(sync);
  int8_t* q = static_cast<int8_t*>(xq);
  cudaError_t e;
  if (sync != nullptr) {
    e = vec ? launch_quantize<true, true>(xb, g, sc, sy, sx, q, s)
            : launch_quantize<true, false>(xb, g, sc, sy, sx, q, s);
  } else {
    e = vec ? launch_quantize<false, true>(xb, g, sc, sy, sx, q, s)
            : launch_quantize<false, false>(xb, g, sc, sy, sx, q, s);
  }
  return static_cast<int>(e);
}

// xq int8 (B, H, W, Cp), wq int8 (Cout, kh, kw, Cp), sx (B) float32 or
// null (static mode), sw (Cout) float32, bias (Cout) float32 or null ->
// out bf16 (B, Ho, Wo, Cout), or with acc_out the int32 sums there
// (out then unused).  Square stride, padding and dilation.  The plan
// (ops/qconv.py qconv_plan): tile channels bn, chunk bytes bk, patch mh
// x mw, ring stages; checked here, chosen there.
extern "C" int wseg_qconv_s8(const void* xq, const void* wq, const float* sx,
                             const float* sw, const float* bias, void* out,
                             void* acc_out, int B, int H, int W, int Cp,
                             int Cout, int kh, int kw, int stride, int pad,
                             int dil, int Ho, int Wo, int bn, int bk, int mh,
                             int mw, int stages, void* stream) {
  if (xq == nullptr || wq == nullptr || sw == nullptr ||
      (out == nullptr && acc_out == nullptr) || B <= 0 || H <= 0 ||
      W <= 0 || Cp <= 0 || Cp % kCpAlign != 0 || Cout <= 0 || kh <= 0 ||
      kw <= 0 || stride <= 0 || stride > 8 || pad < 0 || dil <= 0 ||
      Ho != (H + 2 * pad - dil * (kh - 1) - 1) / stride + 1 ||
      Wo != (W + 2 * pad - dil * (kw - 1) - 1) / stride + 1 || Ho <= 0 ||
      Wo <= 0 || reinterpret_cast<uintptr_t>(xq) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(wq) % 16 != 0 ||
      (bn != 64 && bn != 128 && bn != 256) ||
      (bk != 32 && bk != 64 && bk != 128) || Cp % bk != 0 ||
      mh * mw != kBM || mw < 8 || (mw & (mw - 1)) != 0 ||
      mw * stride > 256 || mh * stride > 256 || stages < 2 ||
      stages > kMaxStages || qconv_smem(bn, stages) > kSmemLimit) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Geom g{};
  g.B = B; g.H = H; g.W = W; g.Cp = Cp; g.Cout = Cout; g.kh = kh; g.kw = kw;
  g.stride = stride; g.pad = pad; g.dil = dil; g.Ho = Ho; g.Wo = Wo;
  g.bk = bk; g.mh = mh; g.mw = mw; g.stages = stages;
  g.tiles_w = (Wo + mw - 1) / mw;
  g.tiles_h = (Ho + mh - 1) / mh;
  g.tiles_n = (Cout + bn - 1) / bn;
  const long long tiles =
      static_cast<long long>(B) * g.tiles_h * g.tiles_w * g.tiles_n;
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  g.tiles = static_cast<int>(tiles);
  g.cpb = Cp / bk;
  g.chunks = kh * kw * g.cpb;
  g.nks = (g.chunks * bk + kStageK - 1) / kStageK;

  const CUtensorMapSwizzle swz = swizzle_of(bk);
  CUtensorMap ma, mb, mo;
  {
    const cuuint64_t dims[4] = {static_cast<cuuint64_t>(Cp),
                                static_cast<cuuint64_t>(W),
                                static_cast<cuuint64_t>(H),
                                static_cast<cuuint64_t>(B)};
    const cuuint64_t strides[3] = {
        static_cast<cuuint64_t>(Cp), static_cast<cuuint64_t>(W) * Cp,
        static_cast<cuuint64_t>(H) * W * Cp};
    const cuuint32_t box[4] = {static_cast<cuuint32_t>(bk),
                               static_cast<cuuint32_t>(mw * stride),
                               static_cast<cuuint32_t>(mh * stride), 1};
    const cuuint32_t elem[4] = {1, static_cast<cuuint32_t>(stride),
                                static_cast<cuuint32_t>(stride), 1};
    if (!encode(&ma, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, xq, dims, strides, box,
                elem, swz)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  {
    const int K = kh * kw * Cp;
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K),
                                static_cast<cuuint64_t>(Cout)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(K)};
    const cuuint32_t box[2] = {static_cast<cuuint32_t>(bk),
                               static_cast<cuuint32_t>(bn)};
    const cuuint32_t elem[2] = {1, 1};
    if (!encode(&mb, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, wq, dims, strides, box,
                elem, swz)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  // bf16 rows leave through TMA where their pitch is a multiple of 16 B
  const int tma_store = acc_out == nullptr && Cout % 8 == 0;
  mo = ma;  // unused unless tma_store
  if (tma_store) {
    const cuuint64_t dims[4] = {static_cast<cuuint64_t>(Cout),
                                static_cast<cuuint64_t>(Wo),
                                static_cast<cuuint64_t>(Ho),
                                static_cast<cuuint64_t>(B)};
    const cuuint64_t strides[3] = {
        static_cast<cuuint64_t>(Cout) * 2,
        static_cast<cuuint64_t>(Wo) * Cout * 2,
        static_cast<cuuint64_t>(Ho) * Wo * Cout * 2};
    // a consumer warpgroup's 64 rows: 64 / w patch rows of w columns
    const int w = mw < 64 ? mw : 64;
    const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(w),
                               static_cast<cuuint32_t>(64 / w), 1};
    const cuuint32_t elem[4] = {1, 1, 1, 1};
    if (!encode(&mo, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, out, dims, strides,
                box, elem, CU_TENSOR_MAP_SWIZZLE_128B)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const int sms = sm_count();
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  const int grid = g.tiles < sms ? g.tiles : sms;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  int* a = static_cast<int*>(acc_out);
  cudaError_t e;
  if (bn == 64) {
    e = launch_qconv<64>(ma, mb, mo, sx, sw, bias, o, a, tma_store, g, grid, s);
  } else if (bn == 128) {
    e = launch_qconv<128>(ma, mb, mo, sx, sw, bias, o, a, tma_store, g, grid,
                          s);
  } else {
    e = launch_qconv<256>(ma, mb, mo, sx, sw, bias, o, a, tma_store, g, grid,
                          s);
  }
  return static_cast<int>(e);
}

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
//    rotates whole lanes).  Per output pixel (b, y, x) it takes sigma
//    per guide channel over the 9 * D clamped taps (centre once per
//    dilation) with the two-pass Bessel-corrected variance of the lax
//    path (wseg_tpu/ops/pamr.py:82-85, not the Pallas kernel's one-pass
//    form), the T logits -mean_K |c - n| / (1e-8 + 0.1 sigma) and their
//    softmax.  Output is channels-major (B, T, H, W), the layout the
//    propagation kernel reads.
//    What bounds it: latency and parallelism, not bytes.  At the
//    flagship (B=8, 48x48, D=6) it reads 0.22 MB and writes 3.5 MB,
//    1.1 us at the HBM rate; its ~26 MFLOP take 0.4 us.  The port's
//    first kernel (one thread a pixel, a grid (ceil(W / 128), H, B) of
//    128-thread blocks: 384 blocks of 48 live lanes each, 62.5% of the
//    lanes idle) took 28.9 us: 18,432 threads, about one live warp a
//    scheduler, each walking three dependent passes of 54-162 global
//    loads with the clamped addresses recomputed in every pass.  This
//    design:
//    - a CTA owns a tile of `cols` pixels of one image row and stages
//      the guide's window (the tile and its clamped +-max(d) halo,
//      three planes) in shared memory by cp.async, every copy of a
//      thread in flight at once, 16-byte copies where the window is
//      whole rows of an aligned guide; every tap is read from there;
//    - 4 lanes share a pixel: lane g takes neighbours g and g + 4 of
//      every dilation, clamps their row and column once per dilation
//      and keeps the 3 channel values of its taps in registers, so the
//      mean, the variance and the logits read shared memory once; the
//      mean, variance, max and sum are combined by xor shuffles
//      (commutative, so every lane of a group holds the same bits);
//    - the softmax values go to a shared tile (T planes at a pitch that
//      spreads a warp's 8 pixels and 4 taps over the 32 banks), then
//      out[b, t, y, x] is written along x, 16-byte stores where the
//      tile is a whole row of an aligned plane.
//    The host plan (ops/pamr_cuda.py::affinity_plan) picks the columns
//    of a tile (the fewest column tiles whose pixels fit a CTA's 512
//    threads and whose window fits shared memory) and the threads; the
//    C entry only checks it.  At the flagship: 384 CTAs of 192 threads,
//    73,728 lanes (4x the first kernel's live threads), all resident at
//    once.  The floor of this design is one CTA's chain (the window's
//    round trip, the dependent sums, shuffles, divisions and
//    exponentials, the barrier, the write-out) plus the launch, since
//    every CTA runs in the one wave: 8 lanes a pixel (8.2 us) and two
//    rows a CTA (11.0 us) were no faster than this launch (8.1 us), and
//    staging only the 13 rows the taps reach was slower (9.4 us).  A
//    window that does not fit shared memory is refused: with one column
//    a tile it holds (1 + 2 max(d))^2 pixels of three planes, so a
//    largest dilation above about 68 on a plane of more than 137 rows
//    and columns (the main path's dilations reach 24).  (Times in this note:
//    NVIDIA H100 80GB HBM3 at a 700 W power limit, chip_smoke.py and the
//    one-off comparison committed in 2f4cfb4.)
//
// 2. pamr_propagate_cluster_kernel<G, P> replaces pamr_pallas.py::
//    pamr_propagate_pallas (_propagate_kernel): num_iter Jacobi steps
//    m <- sum_t aff_t * shift_t(m), all in ONE launch.  The port's first
//    kernel (one block per (b, c) plane) lost on four counts; each part
//    of this design answers one:
//    - Affinity reuse.  The unit of work is (image b, a group of G
//      channels, G in 1, 2, 3, 4, 8; a last group short of G runs with
//      zero slots), as the TPU kernel's grid step holds all channels of
//      an image: one affinity value feeds G accumulators.  As many
//      dilations' affinities of a CTA's band as fit beside the replicas
//      (`sdil`) are kept in shared memory (each thread copies its own
//      pixels' on the first step and reads them back later, so no
//      barrier guards the copy); the others are read where used, from
//      L1 or L2.  The first kernel read an image's affinities 21 x 10
//      times per call from L2.
//    - Filling the card.  A thread-block cluster of N CTAs covers one
//      unit; CTA r owns rows [r H / N, (r + 1) H / N).  Each CTA keeps a
//      replica of the unit's G planes, double-buffered, and writes each
//      new value into all N replicas (its own, and its peers' through
//      distributed shared memory, st.shared::cluster), so the taps'
//      +-24-row reach costs no remote load in the inner loop; one
//      cluster barrier per step.
//    - A plain inner loop.  The dilations sit in the constant bank (the
//      kernel's parameters); the dilation loop is unrolled to kMaxDil
//      and its 8 taps inside, so a tap is one add for its address, an
//      affinity load and G FMAs.  Rows and columns are clamped once per
//      dilation, not per tap; a thread's pixels advance by a precomputed
//      (rows, columns) stride, so no step divides; a thread takes P <= 2
//      of its pixels together, so their loads are in flight at once.
//    - Fewer shared loads.  A replica holds its G planes as sub-planes
//      of 4, 2 and 1 channels per pixel (G = 3: 2 + 1), so a tap's G
//      values come in G / 4 16-byte loads and at most two smaller ones,
//      each conflict-free across a warp's consecutive pixels.
//    The host plan (ops/pamr_cuda.py::propagate_plan) picks G, N, the
//    threads and P from a cost model fitted to a sweep of the plans
//    (PERF.md, PR 9), with the clusters the card holds at once from
//    cudaOccupancyMaxActiveClusters (wseg_pamr_propagate_clusters); the
//    C entry only checks the plan.  At the flagship (8, 21, 48, 48),
//    T = 48, 10 steps, it takes G 3 (seven groups), N 2: 112 CTAs of
//    576 threads, two pixels each, four dilations staged; 202,752 B of
//    shared memory, so one CTA an SM.
//    What bounds it: 186 M FMAs (5.5 us at the float32 rate) against
//    6.6 MB of compulsory bytes, but every FMA takes its plane value
//    from shared memory: 744 MB at 128 B a clock on 132 SMs is ~22 us,
//    this design's floor.  At the flagship plan a step moves ~0.9 MB per
//    SM through the shared-memory/L1 path (plane values, affinities,
//    replica writes), ~3.5 us at that rate and ~5.2 us measured (the
//    cluster barrier, latency); launch and staging add ~4 us a call.
//    Planes up to two float32 planes of shared memory (G = 1) are
//    taken, as the first kernel took.
//
// All tensors float32, contiguous, channels-major.  Each launcher runs
// on the caller's stream, allocates nothing and returns
// cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxDil = 8;              // dilations per call
constexpr int kK = 3;                   // guide channels (RGB)
// the affinity's threads of a CTA; ops/pamr_cuda.py's AFFINITY_LIMITS
// holds it with the lanes a pixel (kAffLanes)
constexpr int kAffMaxThreads = 512;
// the propagation's limits; ops/pamr_cuda.py's LIMITS holds the same
// channels of a unit: bit G set for each instance of G
constexpr int kGroups =
    (1 << 1) | (1 << 2) | (1 << 3) | (1 << 4) | (1 << 8);
constexpr int kMaxCluster = 16;         // CTAs of a cluster (> 8 non-portable)
constexpr int kPortableCluster = 8;
constexpr int kPropMaxThreads = 768;    // threads of a CTA (80 registers)
constexpr int kMaxPixels = 2;           // pixels a thread takes together
constexpr int kSmemLimit = 232448;      // a CTA's dynamic shared memory

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

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// lanes that share a pixel of pamr_affinity_kernel, and the pixels a
// warp takes
constexpr int kAffLanes = 4;
constexpr int kAffWarpPx = 32 / kAffLanes;

// The tile's pitch in shared memory is an odd multiple of a warp's
// pixels, so a warp's stores (8 consecutive pixels of 4 taps t = 8 i + g)
// fall in 32 distinct banks.
__host__ __device__ inline int affinity_pitch(int px) {
  return (((px + kAffWarpPx - 1) / kAffWarpPx) | 1) * kAffWarpPx;
}

// floats of one guide plane's window in shared memory: the widest tile
// (one row of `cols` pixels) with its clamped +-reach halo, rounded up
// to 4 floats
long long affinity_window(int cols, int reach, int H, int W) {
  const long long wr = 1 + 2LL * reach < H ? 1 + 2LL * reach : H;
  const long long wc = cols + 2LL * reach < W ? cols + 2LL * reach : W;
  return (wr * wc + 3) / 4 * 4;
}

// dynamic shared memory of an affinity CTA: the three planes' windows
// and the tile's T softmax planes
long long affinity_smem(int cols, int n_dil, int reach, int H, int W) {
  return 4 * (kK * affinity_window(cols, reach, H, W) +
              8LL * n_dil * affinity_pitch(cols));
}

// One CTA a tile of `cols` pixels of one image row (blockIdx.x the
// column tile, .y the row, .z the image); kAffLanes lanes a pixel, lane
// g of a pixel's group taking neighbours g and g + 4 of every dilation.
// `window` floats a staged plane; `reach` the largest dilation (no larger
// than max(H, W): a larger one clamps the same).
__global__ void __launch_bounds__(kAffMaxThreads)
pamr_affinity_kernel(const float* __restrict__ im, float* __restrict__ aff,
                     Dilations dil, int H, int W, int cols, int reach,
                     int window) {
  extern __shared__ __align__(16) float aff_smem[];
  constexpr int G = kAffLanes;
  constexpr int kJ = 8 / G;  // neighbours a lane takes per dilation
  constexpr int kPx = kAffWarpPx;
  constexpr unsigned kFull = 0xffffffffu;
  const int n = dil.n;
  const int T = 8 * n;
  const int x0 = blockIdx.x * cols, y = blockIdx.y;
  const int b = blockIdx.z;
  const int tw = min(cols, W - x0);
  const int wx0 = max(0, x0 - reach), wy0 = max(0, y - reach);
  const int wc = min(W, x0 + tw + reach) - wx0;
  const int wr = min(H, y + 1 + reach) - wy0;
  const int pitch = affinity_pitch(cols);
  float* win = aff_smem;                 // kK planes of `window` floats
  float* tile = aff_smem + kK * window;  // T planes of `pitch` floats
  const size_t hw = static_cast<size_t>(H) * W;
  const float* img = im + static_cast<size_t>(b) * kK * hw;

  // the window by cp.async, every copy of a thread in flight at once:
  // whole rows of an aligned guide in 16-byte copies
  if (wc == W && (W & 3) == 0 &&
      (reinterpret_cast<uintptr_t>(im) & 15) == 0) {
    const int n4 = wr * W / 4;
    const float* src = img + static_cast<size_t>(wy0) * W;
    for (int k = 0; k < kK; ++k) {
      for (int r = threadIdx.x; r < n4; r += blockDim.x) {
        cp_async16(win + k * window + 4 * r, src + k * hw + 4 * r);
      }
    }
  } else {
    for (int k = 0; k < kK; ++k) {
      for (int yy = 0; yy < wr; ++yy) {
        const float* src = img + k * hw + static_cast<size_t>(wy0 + yy) * W;
        for (int xx = threadIdx.x; xx < wc; xx += blockDim.x) {
          cp_async4(win + k * window + yy * wc + xx, src + wx0 + xx);
        }
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int g = lane / kPx;
  const int slot = (threadIdx.x >> 5) * kPx + lane % kPx;  // tile pixel
  const bool live = slot < tw;  // others compute pixel 0, store nothing
  const int x = x0 + (live ? slot : 0);
  float c[kK];
#pragma unroll
  for (int k = 0; k < kK; ++k) {
    c[k] = win[k * window + (y - wy0) * wc + (x - wx0)];
  }
  int oy[kJ], ox[kJ];
#pragma unroll
  for (int u = 0; u < kJ; ++u) {
    oy[u] = off_y(g + G * u);
    ox[u] = off_x(g + G * u);
  }

  // this lane's taps: their row and column clamped once per dilation,
  // their kK values kept for the mean, the variance and the logits
  float v[kMaxDil][kJ][kK];
  float s[kK] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < kMaxDil; ++i) {
    if (i < n) {
      const int d = dil.d[i];
#pragma unroll
      for (int u = 0; u < kJ; ++u) {
        const int o = (clampi(y + oy[u] * d, H - 1) - wy0) * wc +
                      clampi(x + ox[u] * d, W - 1) - wx0;
#pragma unroll
        for (int k = 0; k < kK; ++k) {
          v[i][u][k] = win[k * window + o];
          s[k] += v[i][u][k];
        }
      }
    }
  }
  // the group's sums by xor shuffles: a + b == b + a, so every lane of
  // the group ends with the same bits
#pragma unroll
  for (int o = kPx; o < 32; o <<= 1) {
#pragma unroll
    for (int k = 0; k < kK; ++k) s[k] += __shfl_xor_sync(kFull, s[k], o);
  }
  const float fn = static_cast<float>(n);
  const float n9 = 9.0f * fn;
  float mean[kK];
#pragma unroll
  for (int k = 0; k < kK; ++k) mean[k] = (s[k] + fn * c[k]) / n9;

  // two-pass Bessel-corrected variance about that mean
  float q[kK] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < kMaxDil; ++i) {
    if (i < n) {
#pragma unroll
      for (int u = 0; u < kJ; ++u) {
#pragma unroll
        for (int k = 0; k < kK; ++k) {
          const float e = v[i][u][k] - mean[k];
          q[k] += e * e;
        }
      }
    }
  }
#pragma unroll
  for (int o = kPx; o < 32; o <<= 1) {
#pragma unroll
    for (int k = 0; k < kK; ++k) q[k] += __shfl_xor_sync(kFull, q[k], o);
  }
  float inv[kK];  // 1 / (1e-8 + 0.1 sigma)
#pragma unroll
  for (int k = 0; k < kK; ++k) {
    const float e = c[k] - mean[k];
    inv[k] = 1.0f / (1e-8f + 0.1f * sqrtf((q[k] + fn * (e * e)) /
                                          (n9 - 1.0f)));
  }

  // logits, then the softmax over the group's T taps
  float a[kMaxDil][kJ];
  float mx = __int_as_float(0xff800000);  // -inf
#pragma unroll
  for (int i = 0; i < kMaxDil; ++i) {
    if (i < n) {
#pragma unroll
      for (int u = 0; u < kJ; ++u) {
        float t = 0.0f;
#pragma unroll
        for (int k = 0; k < kK; ++k) t -= fabsf(c[k] - v[i][u][k]) * inv[k];
        a[i][u] = t / static_cast<float>(kK);
        mx = fmaxf(mx, a[i][u]);
      }
    }
  }
#pragma unroll
  for (int o = kPx; o < 32; o <<= 1) {
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
  }
  float tot = 0.0f;
#pragma unroll
  for (int i = 0; i < kMaxDil; ++i) {
    if (i < n) {
#pragma unroll
      for (int u = 0; u < kJ; ++u) {
        a[i][u] = expf(a[i][u] - mx);
        tot += a[i][u];
      }
    }
  }
#pragma unroll
  for (int o = kPx; o < 32; o <<= 1) tot += __shfl_xor_sync(kFull, tot, o);
  tot = 1.0f / tot;
  if (live) {
#pragma unroll
    for (int i = 0; i < kMaxDil; ++i) {
      if (i < n) {
#pragma unroll
        for (int u = 0; u < kJ; ++u) {
          tile[(8 * i + g + G * u) * pitch + slot] = a[i][u] * tot;
        }
      }
    }
  }
  __syncthreads();

  // out[b, t, y, x] along x: a whole row of an aligned plane in 16-byte
  // stores
  float* dst = aff + static_cast<size_t>(b) * T * hw +
               static_cast<size_t>(y) * W + x0;
  if (tw == W && (W & 3) == 0 &&
      (reinterpret_cast<uintptr_t>(aff) & 15) == 0) {
    const int n4 = tw / 4;
    for (int i = threadIdx.x; i < T * n4; i += blockDim.x) {
      const int t = i / n4, r = i - t * n4;
      reinterpret_cast<float4*>(dst + t * hw)[r] =
          reinterpret_cast<const float4*>(tile + t * pitch)[r];
    }
  } else {
    for (int i = threadIdx.x; i < T * tw; i += blockDim.x) {
      const int t = i / tw, r = i - t * tw;
      dst[t * hw + r] = tile[t * pitch + r];
    }
  }
}

// The G channel slots of a replica buffer (pitch hwp floats a plane):
// G / 4 sub-planes of 4 floats a pixel, then one of 2, then one of 1.
template <int G>
struct Slots {
  static constexpr int kQuads = G / 4;
  static constexpr bool kPair = (G % 4) >= 2;
  static constexpr bool kOne = (G % 2) == 1;
  static constexpr int kPairBase = 4 * kQuads;  // in planes of hwp floats
  static constexpr int kOneBase = kPairBase + (kPair ? 2 : 0);
};

// float offset of slot k (a compile-time constant where unrolled) at
// pixel p
template <int G>
__device__ __forceinline__ int slot_offset(int k, int p, int hwp) {
  using S = Slots<G>;
  if (k < 4 * S::kQuads) return (k / 4) * 4 * hwp + 4 * p + (k % 4);
  if (S::kPair && k < S::kPairBase + 2) {
    return S::kPairBase * hwp + 2 * p + (k - S::kPairBase);
  }
  return S::kOneBase * hwp + p;
}

// acc[k] += a * buf[slot k, pixel p] for the G slots
template <int G>
__device__ __forceinline__ void fma_tap(const float* __restrict__ buf,
                                        int hwp, int p, float a,
                                        float (&acc)[G]) {
  using S = Slots<G>;
#pragma unroll
  for (int s = 0; s < S::kQuads; ++s) {
    const float4 v = reinterpret_cast<const float4*>(buf + 4 * s * hwp)[p];
    acc[4 * s] = fmaf(a, v.x, acc[4 * s]);
    acc[4 * s + 1] = fmaf(a, v.y, acc[4 * s + 1]);
    acc[4 * s + 2] = fmaf(a, v.z, acc[4 * s + 2]);
    acc[4 * s + 3] = fmaf(a, v.w, acc[4 * s + 3]);
  }
  if constexpr (S::kPair) {
    const float2 v =
        reinterpret_cast<const float2*>(buf + S::kPairBase * hwp)[p];
    acc[S::kPairBase] = fmaf(a, v.x, acc[S::kPairBase]);
    acc[S::kPairBase + 1] = fmaf(a, v.y, acc[S::kPairBase + 1]);
  }
  if constexpr (S::kOne) {
    acc[G - 1] = fmaf(a, buf[S::kOneBase * hwp + p], acc[G - 1]);
  }
}

template <int G>
__device__ __forceinline__ void store_slots(float* buf, int hwp, int p,
                                            const float (&acc)[G]) {
  using S = Slots<G>;
#pragma unroll
  for (int s = 0; s < S::kQuads; ++s) {
    reinterpret_cast<float4*>(buf + 4 * s * hwp)[p] =
        make_float4(acc[4 * s], acc[4 * s + 1], acc[4 * s + 2],
                    acc[4 * s + 3]);
  }
  if constexpr (S::kPair) {
    reinterpret_cast<float2*>(buf + S::kPairBase * hwp)[p] =
        make_float2(acc[S::kPairBase], acc[S::kPairBase + 1]);
  }
  if constexpr (S::kOne) buf[S::kOneBase * hwp + p] = acc[G - 1];
}

// the address of `local` in cluster rank `rank`'s shared memory
__device__ __forceinline__ unsigned mapa(const float* local, int rank) {
  unsigned out;
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(local));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(a), "r"(rank));
  return out;
}

// store_slots into a peer's replica at cluster address `buf`
template <int G>
__device__ __forceinline__ void store_slots_remote(unsigned buf, int hwp,
                                                   int p,
                                                   const float (&acc)[G]) {
  using S = Slots<G>;
#pragma unroll
  for (int s = 0; s < S::kQuads; ++s) {
    const unsigned a = buf + 4u * (4 * s * hwp + 4 * p);
    asm volatile(
        "st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(a),
        "f"(acc[4 * s]), "f"(acc[4 * s + 1]), "f"(acc[4 * s + 2]),
        "f"(acc[4 * s + 3])
        : "memory");
  }
  if constexpr (S::kPair) {
    const unsigned a = buf + 4u * (S::kPairBase * hwp + 2 * p);
    asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};\n" ::"r"(a),
                 "f"(acc[S::kPairBase]), "f"(acc[S::kPairBase + 1])
                 : "memory");
  }
  if constexpr (S::kOne) {
    const unsigned a = buf + 4u * (S::kOneBase * hwp + p);
    asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(a),
                 "f"(acc[G - 1])
                 : "memory");
  }
}

// Where a dilation's affinities come from: global memory (L1 or L2),
// shared memory, or global memory on the first step with a copy into
// shared memory for the later ones.
enum class AffFrom { kGlobal, kShared, kGlobalToShared };

// For each of a thread's P pixels (y[k], x[k]): acc[k][c] += the 8 taps
// of dilation d, in tap order, of aff * cur[slot c, tap j's clamped
// pixel], the affinity of tap j at g[k] + j * hw in global memory or at
// s[k] + j * npx in shared memory (kFrom).  A tap's address is one add of
// a row and a column clamped once per dilation; the P pixels' loads of a
// tap are independent, so they are in flight together.
template <int G, int P, AffFrom kFrom>
__device__ __forceinline__ void dilation_taps(
    const float* cur, int hwp, const int (&y)[P], const int (&x)[P], int H,
    int W, int d, const float* const (&g)[P], int hw, float* const (&s)[P],
    int npx, float (&acc)[P][G]) {
  int rows[P][3], cols[P][3];
#pragma unroll
  for (int k = 0; k < P; ++k) {
    rows[k][0] = max(y[k] - d, 0) * W;
    rows[k][1] = y[k] * W;
    rows[k][2] = min(y[k] + d, H - 1) * W;
    cols[k][0] = max(x[k] - d, 0);
    cols[k][1] = x[k];
    cols[k][2] = min(x[k] + d, W - 1);
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int jj = j < 4 ? j : j + 1;  // 3x3 scan without its centre
#pragma unroll
    for (int k = 0; k < P; ++k) {
      float a;
      if constexpr (kFrom == AffFrom::kShared) {
        a = s[k][j * npx];
      } else {
        a = __ldg(g[k] + j * hw);
        if constexpr (kFrom == AffFrom::kGlobalToShared) s[k][j * npx] = a;
      }
      fma_tap<G>(cur, hwp, rows[k][jj / 3] + cols[k][jj % 3], a, acc[k]);
    }
  }
}

// One cluster per unit (image b, channels [c0, c0 + G)), cluster rank r
// owning rows [r H / N, (r + 1) H / N).  Dynamic shared memory: two
// replica buffers of G * hwp floats, then the band's affinities of the
// first `sdil` dilations, [tap][band pixel], staged once per call.  A
// thread's pixels are q = tid, tid + nt, ... of the band; the other
// dilations' affinities are read where used (from L1 or L2).  Channel
// slots past C (the last group short of G) hold zeros.
template <int G, int P>
__global__ void __launch_bounds__(kPropMaxThreads)
pamr_propagate_cluster_kernel(const float* __restrict__ aff,
                              const float* __restrict__ mask,
                              float* __restrict__ out, Dilations dil, int C,
                              int H, int W, int num_iter, int sdil) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int n = static_cast<int>(cluster.num_blocks());
  const int r = static_cast<int>(cluster.block_rank());
  const int unit = blockIdx.x / n;
  const int groups = (C + G - 1) / G;
  const int b = unit / groups;
  const int c0 = (unit - b * groups) * G;
  const int gc = min(G, C - c0);
  const int hw = H * W;
  const int hwp = (hw + 3) & ~3;
  const int y0 = r * H / n;
  const int npx = ((r + 1) * H / n - y0) * W;
  const int T = 8 * dil.n;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  float* cur = smem;
  float* nxt = smem + G * hwp;

  // stage the unit's G planes: copied as they lie into nxt (all copies
  // in flight at once), then re-laid into cur's slots, zeros past C
  const float* src = mask + (static_cast<size_t>(b) * C + c0) * hw;
  if (hw % 4 == 0 && (reinterpret_cast<uintptr_t>(mask) & 15) == 0) {
    // 16-byte copies: every plane starts aligned
    for (int k = 0; k < gc; ++k) {
      for (int p = 4 * tid; p < hw; p += 4 * nt) {
        cp_async16(nxt + k * hwp + p, src + static_cast<size_t>(k) * hw + p);
      }
    }
  } else {
    for (int k = 0; k < gc; ++k) {
      for (int p = tid; p < hw; p += nt) {
        cp_async4(nxt + k * hwp + p, src + static_cast<size_t>(k) * hw + p);
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();
#pragma unroll
  for (int k = 0; k < G; ++k) {
    for (int p = tid; p < hw; p += nt) {
      cur[slot_offset<G>(k, p, hwp)] = k < gc ? nxt[k * hwp + p] : 0.0f;
    }
  }
  const float* a_img = aff + static_cast<size_t>(b) * T * hw;
  // the first sdil dilations' affinities of the band, [tap][band pixel]:
  // each thread copies its own pixels' on the first step and reads them
  // back on the later ones, so the copy needs no barrier of its own
  float* s_aff = smem + 2 * G * hwp;
  cluster.sync();  // every replica staged before any peer writes into it

  // a thread's pixels: q = tid, tid + nt, ... of the band, P at a time;
  // they advance by (sy rows, sx columns), no division
  const int ys = y0 + tid / W;
  const int xs = tid % W;
  const int sy = nt / W;
  const int sx = nt % W;
  for (int it = 0; it < num_iter; ++it) {
    int yn = ys;
    int xn = xs;
    for (int q0 = tid; q0 < npx; q0 += P * nt) {
      int y[P], x[P], q[P];
      bool ok[P];
#pragma unroll
      for (int k = 0; k < P; ++k) {
        q[k] = q0 + k * nt;
        ok[k] = q[k] < npx;  // pixel 0 always is
        // past the band: pixel 0 stands in, computed again, not stored
        y[k] = ok[k] ? yn : y[0];
        x[k] = ok[k] ? xn : x[0];
        if (!ok[k]) q[k] = q[0];
        xn += sx;
        yn += sy;
        if (xn >= W) {
          xn -= W;
          ++yn;
        }
      }
      float acc[P][G];
#pragma unroll
      for (int k = 0; k < P; ++k) {
#pragma unroll
        for (int c = 0; c < G; ++c) acc[k][c] = 0.0f;
      }
      const float* ga[P];
      float* sa[P];
#pragma unroll
      for (int k = 0; k < P; ++k) {
        ga[k] = a_img + y[k] * W + x[k];
        sa[k] = s_aff + q[k];
      }
#pragma unroll
      for (int i = 0; i < kMaxDil; ++i) {
        const int d = dil.d[i];
        const float* g[P];
        float* s[P];
#pragma unroll
        for (int k = 0; k < P; ++k) {
          g[k] = ga[k] + i * 8 * hw;
          s[k] = sa[k] + i * 8 * npx;
        }
        if (i < sdil && it > 0) {
          dilation_taps<G, P, AffFrom::kShared>(cur, hwp, y, x, H, W, d, g,
                                                hw, s, npx, acc);
        } else if (i < sdil) {
          dilation_taps<G, P, AffFrom::kGlobalToShared>(
              cur, hwp, y, x, H, W, d, g, hw, s, npx, acc);
        } else if (i < dil.n) {
          dilation_taps<G, P, AffFrom::kGlobal>(cur, hwp, y, x, H, W, d, g,
                                                hw, s, npx, acc);
        }
      }
#pragma unroll
      for (int k = 0; k < P; ++k) {
        if (ok[k]) {
          const int pix = y[k] * W + x[k];
          store_slots<G>(nxt, hwp, pix, acc[k]);
          for (int m = 1; m < n; ++m) {
            const int rk = r + m < n ? r + m : r + m - n;
            store_slots_remote<G>(mapa(nxt, rk), hwp, pix, acc[k]);
          }
        }
      }
    }
    cluster.sync();  // the step's values are in every replica
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }

  float* dst = out + (static_cast<size_t>(b) * C + c0) * hw + y0 * W;
#pragma unroll
  for (int k = 0; k < G; ++k) {
    if (k < gc) {
      for (int q = tid; q < npx; q += nt) {
        dst[static_cast<size_t>(k) * hw + q] =
            cur[slot_offset<G>(k, y0 * W + q, hwp)];
      }
    }
  }
}

using PropagateKernel = void (*)(const float*, const float*, float*,
                                 Dilations, int, int, int, int, int);

// the instance of G channels (one of kGroups) and P pixels a thread
template <int P>
PropagateKernel propagate_kernel(int g) {
  switch (g) {
    case 1: return pamr_propagate_cluster_kernel<1, P>;
    case 2: return pamr_propagate_cluster_kernel<2, P>;
    case 3: return pamr_propagate_cluster_kernel<3, P>;
    case 4: return pamr_propagate_cluster_kernel<4, P>;
    case 8: return pamr_propagate_cluster_kernel<8, P>;
    default: return nullptr;
  }
}

PropagateKernel propagate_kernel(int g, int p) {
  return p == 1 ? propagate_kernel<1>(g) : propagate_kernel<2>(g);
}

bool valid_group(int g) {
  return g >= 1 && g <= 30 && ((kGroups >> g) & 1);
}

// dynamic shared memory of a CTA: two replicas of G planes at a pitch of
// hw rounded up to 4 floats, and the largest band's affinities of `sdil`
// dilations
long long propagate_smem(int g, int sdil, int n, int H, int W) {
  const long long band = static_cast<long long>((H + n - 1) / n) * W;
  return 4 * (2LL * g * ((static_cast<long long>(H) * W + 3) / 4 * 4) +
              8LL * sdil * band);
}

// the launch of a plan: its kernel, attributes and cluster dimension.
// A kernel's attributes are set only where they change (per device,
// kernel and value), not on every launch.
cudaError_t propagate_config(int g, int p, int n, int threads, int smem,
                             PropagateKernel* kernel,
                             cudaLaunchConfig_t* cfg,
                             cudaLaunchAttribute* attr) {
  constexpr int kDevices = 16;
  struct Attrs {
    int smem, nonportable;
  };
  static Attrs set[kDevices][kMaxPixels][9];
  *kernel = propagate_kernel(g, p);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  const Attrs want = {smem, n > kPortableCluster ? 1 : 0};
  Attrs* have = dev < kDevices ? &set[dev][p - 1][g] : nullptr;
  if (e == cudaSuccess && (!have || have->smem != want.smem)) {
    e = cudaFuncSetAttribute(
        *kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, want.smem);
  }
  if (e == cudaSuccess && want.nonportable &&
      (!have || !have->nonportable)) {
    e = cudaFuncSetAttribute(
        *kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  if (e == cudaSuccess && have) {
    *have = {want.smem, have->nonportable | want.nonportable};
  }
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = n;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->blockDim = dim3(threads);
  cfg->dynamicSmemBytes = smem;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return e;
}

// raises the affinity kernel's dynamic shared-memory attribute where a
// launch needs more than it was given (per device)
cudaError_t affinity_smem_attribute(int smem) {
  constexpr int kDevices = 16;
  static int given[kDevices];
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  int* have = dev < kDevices ? &given[dev] : nullptr;
  if (e == cudaSuccess && (!have || *have < smem)) {
    e = cudaFuncSetAttribute(pamr_affinity_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e == cudaSuccess && have) *have = smem;
  }
  return e;
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

// {channel groups (bit G set for an instance of G), max cluster, max
// threads, shared-memory limit, max pixels a thread takes together}: the
// limits ops/pamr_cuda.py's LIMITS must equal; returns their count
extern "C" int wseg_pamr_propagate_limits(int* out) {
  out[0] = kGroups;
  out[1] = kMaxCluster;
  out[2] = kPropMaxThreads;
  out[3] = kSmemLimit;
  out[4] = kMaxPixels;
  return 5;
}

// largest H * W plane the propagation kernel takes on the current device:
// G = 1, the affinities read from L2, two planes of a pitch rounded up to
// 4 floats in shared memory
extern "C" int wseg_pamr_propagate_max_plane() {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess) {
    return 0;
  }
  const int limit = optin < kSmemLimit ? optin : kSmemLimit;
  return limit / (2 * static_cast<int>(sizeof(float))) / 4 * 4;
}

// {lanes a pixel, threads of a CTA}: the limits ops/pamr_cuda.py's
// AFFINITY_LIMITS must equal; returns their count
extern "C" int wseg_pamr_affinity_limits(int* out) {
  out[0] = kAffLanes;
  out[1] = kAffMaxThreads;
  return 2;
}

// plan: {columns of a CTA's one-row tile, threads, shared memory bytes},
// from ops/pamr_cuda.py::affinity_plan; checked, not chosen, here
extern "C" int wseg_pamr_affinity(const void* im, void* aff,
                                  const int* dilations, int n_dil, int B,
                                  int H, int W, const int* plan,
                                  void* stream) {
  Dilations dil;
  const int cols = plan[0], threads = plan[1], smem = plan[2];
  if (!fill_dilations(dilations, n_dil, &dil) || B <= 0 || B > 65535 ||
      H <= 0 || H > 65535 || W <= 0 ||
      static_cast<long long>(H) * W > 0x7fffffffLL || cols < 1 ||
      cols > W || threads < 32 || threads % 32 != 0 ||
      threads > kAffMaxThreads ||
      static_cast<long long>(cols) * kAffLanes > threads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // a dilation beyond max(H, W) clamps every tap as max(H, W) does
  const int most = H > W ? H : W;
  int reach = 0;
  for (int i = 0; i < n_dil; ++i) {
    if (dil.d[i] > most) dil.d[i] = most;
    if (dil.d[i] > reach) reach = dil.d[i];
  }
  if (affinity_smem(cols, n_dil, reach, H, W) != smem ||
      smem > kSmemLimit) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = affinity_smem_attribute(smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((W + cols - 1) / cols, H, B);
  pamr_affinity_kernel<<<grid, threads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(im), static_cast<float*>(aff), dil, H, W,
      cols, reach, static_cast<int>(affinity_window(cols, reach, H, W)));
  return static_cast<int>(cudaGetLastError());
}

// clusters of a plan the current device holds at once
// (cudaOccupancyMaxActiveClusters), or minus a CUDA error
extern "C" int wseg_pamr_propagate_clusters(int g, int p, int n,
                                            int threads, int smem) {
  if (!valid_group(g) || p < 1 || p > kMaxPixels || n < 1 ||
      n > kMaxCluster || threads < 32 || threads > kPropMaxThreads ||
      smem < 0 || smem > kSmemLimit) {
    return -static_cast<int>(cudaErrorInvalidValue);
  }
  PropagateKernel kernel;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  cudaError_t e =
      propagate_config(g, p, n, threads, smem, &kernel, &cfg, &attr);
  cfg.gridDim = dim3(n);
  int clusters = 0;
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  }
  return e == cudaSuccess ? clusters : -static_cast<int>(e);
}

// plan: {G, cluster size N, threads, shared memory bytes, dilations
// whose affinities are staged in shared memory, pixels a thread takes
// together}, from ops/pamr_cuda.py::propagate_plan; checked, not chosen,
// here
extern "C" int wseg_pamr_propagate(const void* aff, const void* mask,
                                   void* out, const int* dilations,
                                   int n_dil, int B, int C, int H, int W,
                                   int num_iter, const int* plan,
                                   void* stream) {
  Dilations dil;
  const int g = plan[0], n = plan[1], threads = plan[2], smem = plan[3];
  const int sdil = plan[4], p = plan[5];
  if (!fill_dilations(dilations, n_dil, &dil) || B <= 0 || C <= 0 ||
      H <= 0 || W <= 0 || num_iter < 0 || !valid_group(g) || g > C ||
      n < 1 || n > kMaxCluster || n > H || threads < 32 ||
      threads % 32 != 0 || threads > kPropMaxThreads || sdil < 0 ||
      sdil > n_dil || propagate_smem(g, sdil, n, H, W) != smem ||
      smem > kSmemLimit || p < 1 || p > kMaxPixels) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // (a card with less shared memory than kSmemLimit refuses the launch)
  const long long grid = static_cast<long long>(B) * ((C + g - 1) / g) * n;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  PropagateKernel kernel;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  cudaError_t e =
      propagate_config(g, p, n, threads, smem, &kernel, &cfg, &attr);
  if (e != cudaSuccess) return static_cast<int>(e);
  cfg.gridDim = dim3(static_cast<unsigned>(grid));
  cfg.stream = static_cast<cudaStream_t>(stream);
  e = cudaLaunchKernelEx(&cfg, kernel, static_cast<const float*>(aff),
                         static_cast<const float*>(mask),
                         static_cast<float*>(out), dil, C, H, W, num_iter,
                         sdil);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

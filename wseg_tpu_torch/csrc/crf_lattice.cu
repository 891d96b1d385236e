// Exact permutohedral lattice filter on Hopper (sm_90a), plain C
// interface: the steps of one filter application of the exact dense
// CRF, float32 throughout.
//
//   lattice_weights  wn = w * norm[pixel], pixel-major and vertex-major
//   lattice_splat    lat[v, c] = sum_{e in row v} wn[e] * q[pix(e), c]
//   lattice_blur     lat[v] += (lat[n1_j(v)] + lat[n2_j(v)]) / 2, axis j
//                    after axis j-1, j = 0 .. d
//   lattice_slice    out[p, c] = alpha * sum_s wn[p, s] * lat[ids[p, s], c]
//
// Replaces the TPU kernels of wseg_tpu/ops/crf_mm.py: _ohgen_call
// (lattice_weights), _splat_call (lattice_splat) and _gather_call
// (lattice_blur and lattice_slice).  On the TPU, gather and scatter cost
// 4-17 ns per row, so crf_mm.py writes the filter as block matmuls
// against dense multi-hot planes (the splat/slice matrix S with the
// symmetric norm folded in, and one 3-hot matrix per blur axis), in bf16
// planes that emulate f32 on the MXU.  On Hopper a gather is cheap, so
// the same linear operators run directly over the sparse tables: the
// pixel-major (ids, w) table, (Np, d+1), for the slice, and its
// transpose vertex-major (CSR: row_ptr, entries pixel*(d+1)+slot,
// weights) for the splat, built on the host by a counting sort
// (csrc/permutohedral_host.cc).  lattice_weights folds the norm into both,
// once per image and lattice: S' = S diag(norm), so each filter is
// S'^T B S' q with no per-pixel multiplies (crf_mm.py scale_oh).
//
// What bounds them: bytes, 1-2 FLOP per float moved.  At the flagship
// (384x512 canvas, 21 classes, bilateral d=5) a splat reads the real
// pixels' q rows (15.8 MB) and 9 MB of CSR and writes m x 84 B of
// lattice (m ~ 18k, ~8 us at HBM rate); a blur reads and writes the
// 1.5 MB lattice per axis, which stays in the 50 MB L2; a slice reads
// the lattice and 9.4 MB of tables and writes 16.5 MB (its gathers are
// its cost, see below).  In practice the
// splat is bound by L2 traffic: it gathers one 84 B q row (3-4 sectors)
// per CSR entry, ~1.1M rows on the bilateral lattice, and more loads in
// flight per warp made it slower on the H100; the blur is bound by
// latency, d+1 dependent passes.
//
// * lattice_splat (replaces _splat_call).  The CSR rows are skewed: flat
//   colour maps up to ~1,100 pixels onto one bilateral vertex (mean ~62),
//   so a warp per vertex leaves the kernel's time to its longest row,
//   hundreds of dependent L2 round trips on one warp.  Work is split by
//   ENTRIES instead: a table built once per lattice on the host
//   (ops/crf_lattice.split_table) cuts every CSR row into chunks of at
//   most 32 entries, in order (an empty row and the zero slot m are one
//   empty chunk each).  Warp w takes chunks w, w + W, ..., so a long
//   row's chunks run on different warps; its lanes load the chunk's
//   (entry, weight) pairs coalesced and hand them round by __shfl_sync,
//   8 independent q-row loads in flight; lanes split the channels (C = 21:
//   one lane each) or, for few channels (the norm filter's C = 1), the
//   entries, summed by a fixed shuffle tree.  A chunk that is its row's
//   only one writes the lattice row; a split row's chunks write partials
//   to a scratch row each, and after a grid-wide barrier each split row
//   sums its partials in chunk order.  No float atomics: the order of
//   every sum depends only on the table, so two runs are bit-equal.
// * lattice_blur (replaces _gather_call's 3-hot blur products).  A
//   launch per axis is d+1 launches per filter (3 or 6), ~2.5 us of
//   kernel each under tens of us of host wrapper.  One launch runs all
//   axes:
//   grid-stride over (vertex, channel), cooperative_groups grid sync
//   between axes, ping-pong between two buffers; each thread starts the
//   loads of 4 elements together and loads the next axis's neighbour ids
//   (which no axis writes) before the barrier, so an axis costs one
//   dependent gather and the barrier.  Each axis computes lat[v] + 0.5f *
//   (lat[n1] + lat[n2]) in the per-axis order (bit-equal to d+1 one-axis
//   passes) and rewrites the zero slot (row m, where missing neighbours
//   and padded pixels point) as zero.
// * lattice_slice (replaces _gather_call's slice product).  Its bound is
//   bytes: the lattice, the (Np, d+1) ids and weights and out once, 27.5
//   MB at the flagship bilateral filter (Np 196,608, d+1 6, C 21, m
//   18,241), 8.2 us at the HBM rate.  Its gathers are the cost: each
//   (pixel, slot) reads an 84 B vertex row that spans 3-4 sectors of 32 B
//   (rows are not sector-aligned).  Neighbouring pixels share vertices,
//   so a warp's 32-pixel tile touches only 22.1 MB of distinct row
//   sectors on the photo-like lattice of chip_smoke.py: with the tables
//   and out once, 48.0 MB, this design's L2 floor, 10.1 us at the 4.7
//   TB/s of a copy between two L2-resident tensors.  (Had no gather hit
//   L1, the row sectors would be 125.9 MB: an upper estimate of the
//   traffic, not a floor.)  The first kernel (one thread per (pixel,
//   channel), 4.1 M threads, a 64-bit division each, the pixel's d+1 ids
//   and weights re-read by each of its C threads) took 31-33 us.  This design: a
//   warp per tile of pixels copies the tile's ids and weights once,
//   coalesced, into shared memory; lanes walk the tile's outputs in
//   pixel-major order, so neighbouring lanes gather neighbouring
//   channels of one vertex row and a warp's rounds share rows in L1;
//   d+1 is a template (the loads of a round in flight together), each
//   output sums its slots in slot order (two runs bit-equal); a slot on
//   the zero row m (every slot of a padded canvas pixel) issues no load;
//   outputs leave through shared memory as one 16-byte store a lane per
//   128 outputs.  It takes 20-21 us, about twice its L2 floor and 2.5x
//   the bound: without its gathers the same kernel takes 8.3-8.7 us (at
//   the bound), so the gathers' trips through L1, not HBM bytes, hold
//   it.  At C = 1 (the norm filter) it is 0.6 us slower than the
//   first kernel (3.1-4.5 us): one round of 32 outputs a tile leaves its
//   staging little to hide behind.  (Times in this note: NVIDIA H100
//   80GB HBM3 at a 700 W power limit, chip_smoke.py and the one-off
//   comparison committed in 2f4cfb4.)
// * The splat and the blur are cooperative launches at as many blocks as
//   the card holds at once (grid.sync needs no -rdc since CUDA 11).  A
//   grid that cannot be co-resident is refused
//   (cudaErrorCooperativeLaunchTooLarge): the entry returns the error,
//   nothing falls back.
// * wseg_lattice_filter launches splat, blur and slice back to back on
//   the caller's stream: one host call per filter.
//
// All tensors are contiguous; ids/entries/nbr and the chunk tables are
// int32, the rest float32.  Each entry point launches on the caller's
// stream, allocates nothing, and returns a CUDA error code.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <atomic>
#include <climits>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kBlock = 256;
constexpr int kWarpsPerBlock = kBlock / 32;
constexpr int kUnroll = 8;  // q-row loads in flight per splat warp
constexpr int kBlurBlock = 1024;
constexpr int kBlurIlp = 4;
constexpr int kSliceBlock = 128;
constexpr int kSliceWarps = kSliceBlock / 32;
constexpr int kSliceMaxD1 = 8;  // slots a pixel: instances 1 .. 8
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDevices = 64;

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

// Cooperative.  Phase 1: warp w of the W warps takes chunks w, w + W,
// w + 2W, ... (a long row's chunks land on different warps); chunk c
// spans entries [chunk_ptr[c], chunk_ptr[c+1]) of row chunk_row[c], at
// most 32 (ops/crf_lattice.SPLAT_CHUNK).  The lanes load the chunk's
// (pixel, weight) pairs, one each, and hand them round by shuffles;
// kUnroll q-row loads are in flight per warp.  Lane = group
// * cp + channel, cp = 2^cp_log2 >= C; the 32 / cp groups take every
// G-th entry.  Phase 2 (only if some row is split): per (split row,
// channel) the partials of chunks [splits[s][0], splits[s][1]) in chunk
// order.  `lat` and `partial` are written here and read after the grid
// barrier, so they are plain (coherent) pointers.
__global__ void __launch_bounds__(kBlock)
lattice_splat_kernel(const int* __restrict__ chunk_ptr,
                     const int* __restrict__ chunk_row,
                     const int* __restrict__ splits, int n_chunks,
                     int n_split, const int* __restrict__ entries,
                     const float* __restrict__ w_csr,
                     const float* __restrict__ q, int C, int d1,
                     int cp_log2, float* lat, float* partial) {
  const int lane = threadIdx.x & 31;
  const int cp = 1 << cp_log2;
  const int ch = lane & (cp - 1);
  const int g = lane >> cp_log2;
  const int G = 32 >> cp_log2;
  const bool live = ch < C;
  const int n_warps = gridDim.x * kWarpsPerBlock;
  for (int c = blockIdx.x * kWarpsPerBlock + threadIdx.x / 32; c < n_chunks;
       c += n_warps) {  // warp-uniform
    const int begin = chunk_ptr[c], end = chunk_ptr[c + 1];
    const int v = chunk_row[c];
    const bool whole = (c == 0 || chunk_row[c - 1] != v) &&
                       (c + 1 == n_chunks || chunk_row[c + 1] != v);
    const int n = end - begin;  // <= 32
    int my_p = 0;
    float my_w = 0.0f;
    if (lane < n) {
      my_p = entries[begin + lane] / d1;
      my_w = w_csr[begin + lane];
    }
    float acc = 0.0f;
    for (int t0 = 0; t0 < n; t0 += kUnroll * G) {
      float wv[kUnroll], qv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int t = t0 + u * G + g;
        const int p = __shfl_sync(kFull, my_p, t & 31);
        const float w = __shfl_sync(kFull, my_w, t & 31);
        const bool ok = live && t < n;
        wv[u] = ok ? w : 0.0f;
        qv[u] = ok ? __ldg(q + static_cast<size_t>(p) * C + ch) : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) acc += wv[u] * qv[u];
    }
    for (int off = cp; off < 32; off <<= 1)
      acc += __shfl_xor_sync(kFull, acc, off);
    if (g == 0 && live) {
      float* dst = whole ? lat + static_cast<size_t>(v) * C
                         : partial + static_cast<size_t>(c) * C;
      dst[ch] = acc;
    }
  }
  if (n_split == 0) return;  // uniform over the grid
  cg::this_grid().sync();
  const int n = n_split * C;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    const int s = i / C, ch2 = i - s * C;
    const int c0 = splits[2 * s], c1 = splits[2 * s + 1];
    float acc = 0.0f;
    for (int k = c0; k < c1; ++k) acc += partial[static_cast<size_t>(k) * C + ch2];
    lat[static_cast<size_t>(chunk_row[c0]) * C + ch2] = acc;
  }
}

// Cooperative, blocks of kBlurBlock threads.  Axis j reads `in` (j = 0)
// or the buffer axis j-1 wrote, and writes buf0 (j even) or buf1 (j
// odd); nbr is (n_axes, m, 2).  The result lies in buf0 if n_axes is
// odd, else in buf1.  in != buf0.  Each thread takes kBlurIlp elements
// (vertex, channel) per round: their neighbour ids, then their lattice
// reads, then their writes, so the loads of a round overlap; the ids of
// the next axis's first round (which no axis writes) are loaded before
// the grid barrier.
__global__ void __launch_bounds__(kBlurBlock)
lattice_blur_kernel(const float* in, float* buf0, float* buf1,
                    const int* __restrict__ nbr, int m, int C, int n_axes) {
  const int n = (m + 1) * C;
  const int stride = gridDim.x * blockDim.x;
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  int n1[kBlurIlp], n2[kBlurIlp];
  auto ids = [&](int j, int i0) {
    const int* nb = nbr + 2 * static_cast<size_t>(j) * m;
#pragma unroll
    for (int k = 0; k < kBlurIlp; ++k) {
      const int i = i0 + k * stride;
      const int v = i / C;
      n1[k] = n2[k] = m;
      if (i < n && v < m) {
        n1[k] = __ldg(nb + 2 * static_cast<size_t>(v));
        n2[k] = __ldg(nb + 2 * static_cast<size_t>(v) + 1);
      }
    }
  };
  ids(0, first);
  const float* src = in;
  for (int j = 0; j < n_axes; ++j) {
    float* dst = (j & 1) ? buf1 : buf0;
    for (int i0 = first; i0 < n; i0 += kBlurIlp * stride) {
      if (i0 != first) ids(j, i0);
      float out[kBlurIlp];
#pragma unroll
      for (int k = 0; k < kBlurIlp; ++k) {
        const int i = i0 + k * stride;
        const int v = i / C;
        const int c = i - v * C;
        out[k] = 0.0f;  // the zero slot, row m
        if (i < n && v < m)
          out[k] = src[i] + 0.5f * (src[static_cast<size_t>(n1[k]) * C + c] +
                                    src[static_cast<size_t>(n2[k]) * C + c]);
      }
#pragma unroll
      for (int k = 0; k < kBlurIlp; ++k) {
        const int i = i0 + k * stride;
        if (i < n) dst[i] = out[k];
      }
    }
    if (j + 1 < n_axes) {
      ids(j + 1, first);
      cg::this_grid().sync();
    }
    src = dst;
  }
}

// pixels a slice warp takes: 32, or for C < 4 enough that the warp's
// tile has at least 128 outputs (one 16-byte store a lane)
__host__ __device__ constexpr int slice_tile(int C) {
  return C >= 4 ? 32 : 32 * ((4 + C - 1) / C);
}

// dynamic shared memory of a slice block: each warp's (id, weight) pairs
// and its 128-output staging buffer
constexpr int slice_smem(int C, int d1) {
  return kSliceWarps * (slice_tile(C) * d1 * 8 + 128 * 4);
}

// Warp w of block k takes the tile of pixels [p0, p0 + tile), p0 = (k *
// kSliceWarps + w) * tile: it copies their (Np, D1) ids and weights, one
// contiguous span each, into shared memory as (id, weight) pairs, D1
// loads of each in flight at once per 32 pixels; then it walks the
// tile's outputs (pixel-major, p * C + c) 128 at a time, lane l taking
// outputs 32 r + l of rounds r = 0..3: neighbouring lanes gather
// neighbouring channels of one vertex row, each output sums its D1 slots
// in slot order, a slot on the zero row m (a padded pixel's) issues no
// load.  The 128 outputs go through shared memory to one 16-byte store a
// lane.  (pixel, channel) advance by (32 / C, 32 % C) a round, so nothing
// divides in the loop.  out is 16-byte aligned (the entry checks).
template <int D1>
__global__ void __launch_bounds__(kSliceBlock)
lattice_slice_kernel(const float* __restrict__ lat,
                     const int* __restrict__ ids,
                     const float* __restrict__ wn, int n_pix, int C, int m,
                     float alpha, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char slice_smem_raw[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tile = slice_tile(C);
  int2* tab = reinterpret_cast<int2*>(slice_smem_raw);
  float* stage =
      reinterpret_cast<float*>(tab + kSliceWarps * tile * D1) + warp * 128;
  tab += warp * tile * D1;
  const int p0 = (blockIdx.x * kSliceWarps + warp) * tile;
  if (p0 >= n_pix) return;  // warp-uniform; no block barrier follows
  const int np = min(tile, n_pix - p0);
  const int* wid = ids + static_cast<size_t>(p0) * D1;
  const float* wwn = wn + static_cast<size_t>(p0) * D1;
  for (int j = 0; j < np * D1; j += 32 * D1) {
    int id[D1];
    float w[D1];
#pragma unroll
    for (int s = 0; s < D1; ++s) {
      const int i = j + lane + 32 * s;
      id[s] = i < np * D1 ? __ldg(wid + i) : 0;
      w[s] = i < np * D1 ? __ldg(wwn + i) : 0.0f;
    }
#pragma unroll
    for (int s = 0; s < D1; ++s) {
      tab[j + lane + 32 * s] = make_int2(id[s], __float_as_int(w[s]));
    }
  }
  __syncwarp();
  const int span = np * C;
  const int pstep = 32 / C, cstep = 32 - pstep * C;
  int p = lane / C, c = lane - p * C;
  float* dst = out + static_cast<size_t>(p0) * C;
  for (int base = 0; base < span; base += 128) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      // past the tile's end a lane reads its last pixel (stored nowhere),
      // so the rounds' loads need no branch and issue together
      const int2* e = tab + min(p, np - 1) * D1;
      float w[D1], x[D1];
#pragma unroll
      for (int s = 0; s < D1; ++s) {
        const int2 v = e[s];
        w[s] = __int_as_float(v.y);
        x[s] = static_cast<unsigned>(v.x) < static_cast<unsigned>(m)
                   ? __ldg(lat + v.x * C + c)
                   : 0.0f;
      }
      float acc = 0.0f;
#pragma unroll
      for (int s = 0; s < D1; ++s) acc = fmaf(w[s], x[s], acc);
      stage[32 * r + lane] = alpha * acc;
      c += cstep;
      p += pstep;
      if (c >= C) {
        c -= C;
        ++p;
      }
    }
    __syncwarp();
    const int n = min(128, span - base);
    if (4 * lane + 4 <= n) {
      reinterpret_cast<float4*>(dst + base)[lane] =
          reinterpret_cast<const float4*>(stage)[lane];
    } else {
      for (int k = 4 * lane; k < n; ++k) dst[base + k] = stage[k];
    }
    __syncwarp();
  }
}

using SliceKernel = void (*)(const float*, const int*, const float*, int,
                             int, int, float, float*);

// the instance of d+1 = d1 slots (1 .. kSliceMaxD1)
SliceKernel slice_kernel(int d1) {
  switch (d1) {
    case 1: return lattice_slice_kernel<1>;
    case 2: return lattice_slice_kernel<2>;
    case 3: return lattice_slice_kernel<3>;
    case 4: return lattice_slice_kernel<4>;
    case 5: return lattice_slice_kernel<5>;
    case 6: return lattice_slice_kernel<6>;
    case 7: return lattice_slice_kernel<7>;
    case 8: return lattice_slice_kernel<8>;
    default: return nullptr;
  }
}

unsigned blocks_for(long long n) {
  return static_cast<unsigned>((n + kBlock - 1) / kBlock);
}

constexpr long long kMaxBlocks = 2147483647LL;

// Blocks of `block` threads of `fn` that the current device holds at
// once (occupancy x SMs), cached per device and kernel (`which`).
cudaError_t coresident_blocks(const void* fn, int which, int block,
                              int* blocks) {
  static std::atomic<int> cache[kMaxDevices][2];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices) {
    const int v = cache[dev][which].load(std::memory_order_relaxed);
    if (v > 0) {
      *blocks = v;
      return cudaSuccess;
    }
  }
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, block, 0);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (per_sm * sms <= 0) return cudaErrorCooperativeLaunchTooLarge;
  *blocks = per_sm * sms;
  if (dev < kMaxDevices)
    cache[dev][which].store(*blocks, std::memory_order_relaxed);
  return cudaSuccess;
}

// A cooperative launch of `fn` with min(co-resident, want) blocks of
// `block` threads, or `grid` blocks if grid > 0 (the wrappers pass 0;
// the card tests pass a grid the card cannot hold, which is refused).
cudaError_t launch_coop(const void* fn, int which, int block, long long want,
                        int grid, void** args, cudaStream_t stream) {
  unsigned blocks = static_cast<unsigned>(grid);
  if (grid <= 0) {
    int most = 0;
    const cudaError_t err = coresident_blocks(fn, which, block, &most);
    if (err != cudaSuccess) return err;
    blocks = static_cast<unsigned>(want < 1 ? 1 : (want < most ? want : most));
  }
  const cudaError_t err = cudaLaunchCooperativeKernel(
      fn, dim3(blocks), dim3(block), args, 0, stream);
  if (err != cudaSuccess) cudaGetLastError();  // no later check reports it
  return err;
}

cudaError_t launch_splat(const int* chunk_ptr, const int* chunk_row,
                         const int* splits, int n_chunks, int n_split,
                         const int* entries, const float* w_csr,
                         const float* q, int C, int d1, float* lat,
                         float* partial, int grid, cudaStream_t stream) {
  if (n_chunks <= 0 || n_split < 0 || C <= 0 || C > 32 || d1 <= 0 ||
      static_cast<long long>(n_split) * C > INT_MAX) {
    return cudaErrorInvalidValue;
  }
  int cp_log2 = 0;
  while ((1 << cp_log2) < C) ++cp_log2;
  void* args[] = {&chunk_ptr, &chunk_row, &splits, &n_chunks, &n_split,
                  &entries,   &w_csr,     &q,      &C,        &d1,
                  &cp_log2,   &lat,       &partial};
  return launch_coop(reinterpret_cast<const void*>(lattice_splat_kernel), 0,
                     kBlock, (n_chunks + kWarpsPerBlock - 1) / kWarpsPerBlock,
                     grid, args, stream);
}

cudaError_t launch_blur(const float* in, float* buf0, float* buf1,
                        const int* nbr, int m, int C, int n_axes, int grid,
                        cudaStream_t stream) {
  if (m < 0 || C <= 0 || n_axes <= 0 || in == buf0 ||
      static_cast<long long>(m + 1) * C > INT_MAX) {
    return cudaErrorInvalidValue;
  }
  void* args[] = {&in, &buf0, &buf1, &nbr, &m, &C, &n_axes};
  const long long n = static_cast<long long>(m + 1) * C;
  return launch_coop(reinterpret_cast<const void*>(lattice_blur_kernel), 1,
                     kBlurBlock, (n + kBlurBlock - 1) / kBlurBlock, grid, args,
                     stream);
}

// the slice of an (m+1, C) lattice: blocks of kSliceWarps warps, a warp
// per slice_tile(C) pixels
cudaError_t launch_slice(const float* lat, const int* ids, const float* wn,
                         int n_pix, int C, int d1, int m, float alpha,
                         float* out, cudaStream_t stream) {
  const SliceKernel kernel = slice_kernel(d1);
  const long long per_block =
      static_cast<long long>(kSliceWarps) * slice_tile(C > 0 ? C : 1);
  if (n_pix < 0 || C <= 0 || !kernel || m < 0 ||
      static_cast<long long>(m + 1) * C > INT_MAX ||
      n_pix + per_block > INT_MAX ||
      (reinterpret_cast<uintptr_t>(out) & 15) != 0) {
    return cudaErrorInvalidValue;
  }
  if (n_pix == 0) return cudaSuccess;
  kernel<<<static_cast<unsigned>((n_pix + per_block - 1) / per_block),
           kSliceBlock, slice_smem(C, d1), stream>>>(lat, ids, wn, n_pix, C,
                                                     m, alpha, out);
  return cudaGetLastError();
}

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

// lat (rows, C) and partial (n_chunks, C): rows = the last chunk's row+1.
extern "C" int wseg_lattice_splat(const void* chunk_ptr,
                                  const void* chunk_row, const void* splits,
                                  int n_chunks, int n_split,
                                  const void* entries, const void* w_csr,
                                  const void* q, int C, int d1, void* lat,
                                  void* partial, int grid, void* stream) {
  return static_cast<int>(launch_splat(
      static_cast<const int*>(chunk_ptr), static_cast<const int*>(chunk_row),
      static_cast<const int*>(splits), n_chunks, n_split,
      static_cast<const int*>(entries), static_cast<const float*>(w_csr),
      static_cast<const float*>(q), C, d1, static_cast<float*>(lat),
      static_cast<float*>(partial), grid, static_cast<cudaStream_t>(stream)));
}

// All n_axes axes of nbr (n_axes, m, 2) in one launch; see the kernel for
// which of buf0/buf1 holds the result.
extern "C" int wseg_lattice_blur(const void* lat, void* buf0, void* buf1,
                                 const void* nbr, int m, int C, int n_axes,
                                 int grid, void* stream) {
  return static_cast<int>(launch_blur(
      static_cast<const float*>(lat), static_cast<float*>(buf0),
      static_cast<float*>(buf1), static_cast<const int*>(nbr), m, C, n_axes,
      grid, static_cast<cudaStream_t>(stream)));
}

// lat (m+1, C), ids in [0, m]; row m is the zero slot and must hold
// zeros: a slot on it (or on any id outside [0, m)) issues no load and
// adds 0.  out 16-byte aligned
extern "C" int wseg_lattice_slice(const void* lat, const void* ids,
                                  const void* wn, int n_pix, int C, int d1,
                                  int m, float alpha, void* out,
                                  void* stream) {
  return static_cast<int>(launch_slice(
      static_cast<const float*>(lat), static_cast<const int*>(ids),
      static_cast<const float*>(wn), n_pix, C, d1, m, alpha,
      static_cast<float*>(out), static_cast<cudaStream_t>(stream)));
}

// {slots of a pixel, threads of a slice block}: the limits
// ops/crf_lattice_cuda.py's SLICE_LIMITS must equal; returns their count
extern "C" int wseg_lattice_slice_limits(int* out) {
  out[0] = kSliceMaxD1;
  out[1] = kSliceBlock;
  return 2;
}

// One filter: splat -> all d1 blur axes -> slice, back to back.  scratch
// holds 2 (m+1) C + n_chunks C floats: the lattice, the blur's second
// buffer and the split rows' partials.
extern "C" int wseg_lattice_filter(
    const void* chunk_ptr, const void* chunk_row, const void* splits,
    int n_chunks, int n_split, const void* entries, const void* w_csr,
    const void* q, int C, int d1, const void* nbr, int m, const void* ids,
    const void* w_pix, int n_pix, float alpha, void* scratch, void* out,
    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m < 0) return static_cast<int>(cudaErrorInvalidValue);
  float* lat = static_cast<float*>(scratch);
  float* lat2 = lat + static_cast<size_t>(m + 1) * C;
  float* partial = lat2 + static_cast<size_t>(m + 1) * C;
  cudaError_t err = launch_splat(
      static_cast<const int*>(chunk_ptr), static_cast<const int*>(chunk_row),
      static_cast<const int*>(splits), n_chunks, n_split,
      static_cast<const int*>(entries), static_cast<const float*>(w_csr),
      static_cast<const float*>(q), C, d1, lat, partial, 0, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_blur(lat, lat2, lat, static_cast<const int*>(nbr), m, C, d1, 0,
                    s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* blurred = ((d1 - 1) & 1) ? lat : lat2;
  return static_cast<int>(launch_slice(
      blurred, static_cast<const int*>(ids),
      static_cast<const float*>(w_pix), n_pix, C, d1, m, alpha,
      static_cast<float*>(out), s));
}


// The 3xTF32 tile core shared by ddmm.cu and sddmm.cu: one block computes
// one K chunk of a BM x BN output tile on mma.sync, and the chunks of a
// tile, one thread-block cluster, add their partials in chunk order over
// distributed shared memory.
//
// - Block tile BM x BN: BM = 16, 32 or 64 rows, BN = 32 or 64 columns, 4
//   warps (1 x 4 at 16 rows, else 2 x 2), K in stages of 32 through a
//   3-deep cp.async ring; shared rows padded so fragment reads hit 32
//   banks.  x is row-major (M, K); y is read through its strides,
//   row-major (K, N) or a transposed view of a contiguous (N, K) matrix (a
//   VIP's x @ xᵀ), each staged in the layout its 16-byte copies come in.
//   Masked copies zero-fill: ragged M, N and K need no padding.  Both
//   layouts give the MMAs the same fragments, so the same bits.
// - The tensor cores' fp32 sums do not round to nearest and their bias
//   grows with the MMAs into one register: each 32-deep stage sums into a
//   fresh partial, added to the running total by FADD.
// - Split-K: the K stages fall into `split` chunks of `kt_per` stages (the
//   last may be shorter), one block each; the chunks of one output tile
//   form one cluster (split <= 8).  Each block leaves its partial tile in
//   shared memory; after a cluster barrier, block r adds every chunk's
//   partial in chunk order 0..split-1 for its share of the tile's elements
//   and hands each sum to the kernel's store.  No workspace, no atomics:
//   the same bits from run to run, and whatever M, tile height or block
//   computes a chunk.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "tf32x3.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int BK = 32, STAGES = 3, THREADS = 128, APAD = 4, BPAD = 8;
constexpr int MAX_SPLIT = 8;

// The operands and K plan of one product.  YT: y is a transposed view
// (element (k, n) at y[n * ldy + k]); otherwise at y[k * ldy + n].
struct TileArgs {
  const float* x;
  const float* y;
  int M, K, N, ldy, k_tiles, kt_per, split;
};

template <int BM, int BN, bool YT>
struct Tile {
  static constexpr int LDA = BK + APAD;
  static constexpr int LDB = YT ? BK + APAD : BN + BPAD;
  static constexpr int A_STAGE = BM * LDA;
  static constexpr int B_STAGE = YT ? BN * LDB : BK * LDB;
  static constexpr int LDR = BN + BPAD;          // the partial tile's rows
  static constexpr int RING = STAGES * (A_STAGE + B_STAGE);
  static constexpr int BYTES = 4 * (RING > BM * LDR ? RING : BM * LDR);
};

// This block's K chunk (`chunk`) of the tile at (m0, n0), left in smem as
// the partial tile [BM][LDR].
template <int BM, int BN, bool YT>
__device__ __forceinline__ void tile_chunk(const TileArgs& a, int m0, int n0,
                                           int chunk, float* smem) {
  using T = Tile<BM, BN, YT>;
  constexpr int WARPS_M = BM == 16 ? 1 : 2, WARPS_N = 4 / WARPS_M;
  constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;
  constexpr int MT = WM / 16, NT = WN / 8;       // MMA tiles per warp
  constexpr int LDA = T::LDA, LDB = T::LDB;
  float* As = smem;                              // [STAGES][BM][LDA]
  float* Bs = smem + STAGES * T::A_STAGE;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int kt0 = chunk * a.kt_per;
  const int nk = min(a.kt_per, a.k_tiles - kt0);
  const float* __restrict__ x = a.x;
  const float* __restrict__ y = a.y;
  const bool x_vec =
      a.K % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const bool y_vec = (YT ? a.K : a.N) % 4 == 0 && a.ldy % 4 == 0 &&
                     (reinterpret_cast<uintptr_t>(y) & 15) == 0;

  auto load_x = [&](int kt, float* dst) {
    const int k0 = kt * BK;
    if (x_vec) {
#pragma unroll
      for (int i = 0; i < BM * BK / 4 / THREADS; ++i) {
        const int c = tid + i * THREADS;
        const int r = c / (BK / 4), col = (c % (BK / 4)) * 4;
        const int m = m0 + r, k = k0 + col;
        const bool ok = m < a.M && k < a.K;
        cp_async16(dst + r * LDA + col, ok ? x + (size_t)m * a.K + k : x, ok);
      }
    } else {
#pragma unroll 4
      for (int i = 0; i < BM * BK / THREADS; ++i) {
        const int e = tid + i * THREADS;
        const int r = e / BK, col = e % BK;
        const int m = m0 + r, k = k0 + col;
        const bool ok = m < a.M && k < a.K;
        cp_async4(dst + r * LDA + col, ok ? x + (size_t)m * a.K + k : x, ok);
      }
    }
  };
  // staged rows run along y's unit stride: k for YT, n otherwise
  auto load_y = [&](int kt, float* dst) {
    const int k0 = kt * BK;
    constexpr int ROW = YT ? BK : BN;            // floats a staged row holds
    if (y_vec) {
#pragma unroll
      for (int i = 0; i < BK * BN / 4 / THREADS; ++i) {
        const int c = tid + i * THREADS;
        const int r = c / (ROW / 4), col = (c % (ROW / 4)) * 4;
        const int k = k0 + (YT ? col : r), n = n0 + (YT ? r : col);
        const bool ok = k < a.K && n < a.N;
        const float* src = YT ? y + (size_t)n * a.ldy + k
                              : y + (size_t)k * a.ldy + n;
        cp_async16(dst + r * LDB + col, ok ? src : y, ok);
      }
    } else {
#pragma unroll 4
      for (int i = 0; i < BK * BN / THREADS; ++i) {
        const int e = tid + i * THREADS;
        const int r = e / ROW, col = e % ROW;
        const int k = k0 + (YT ? col : r), n = n0 + (YT ? r : col);
        const bool ok = k < a.K && n < a.N;
        const float* src = YT ? y + (size_t)n * a.ldy + k
                              : y + (size_t)k * a.ldy + n;
        cp_async4(dst + r * LDB + col, ok ? src : y, ok);
      }
    }
  };

  const int wm = (warp / WARPS_N) * WM, wn = (warp % WARPS_N) * WN;
  const int gq = lane >> 2, tq = lane & 3;
  float acc[MT][NT][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nk) {
      load_x(kt0 + st, As + st * T::A_STAGE);
      load_y(kt0 + st, Bs + st * T::B_STAGE);
    }
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();   // stage kt has landed (this thread's part)
    __syncthreads();               // ... everyone's; stage kt-1 is consumed
    const int nxt = kt + STAGES - 1;
    if (nxt < nk) {
      load_x(kt0 + nxt, As + (nxt % STAGES) * T::A_STAGE);
      load_y(kt0 + nxt, Bs + (nxt % STAGES) * T::B_STAGE);
    }
    cp_async_commit();
    const float* A = As + (kt % STAGES) * T::A_STAGE;
    const float* B = Bs + (kt % STAGES) * T::B_STAGE;
    float part[MT][NT][4];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int ni = 0; ni < NT; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[mi][ni][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      uint32_t ah[MT][4], al[MT][4], bh[NT][2], bl[NT][2];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        const float* ap = A + (wm + mi * 16 + gq) * LDA + kk + tq;
        split_tf32(ap[0], ah[mi][0], al[mi][0]);
        split_tf32(ap[8 * LDA], ah[mi][1], al[mi][1]);
        split_tf32(ap[4], ah[mi][2], al[mi][2]);
        split_tf32(ap[8 * LDA + 4], ah[mi][3], al[mi][3]);
      }
#pragma unroll
      for (int ni = 0; ni < NT; ++ni) {
        if constexpr (YT) {
          const float* bp = B + (wn + ni * 8 + gq) * LDB + kk + tq;
          split_tf32(bp[0], bh[ni][0], bl[ni][0]);
          split_tf32(bp[4], bh[ni][1], bl[ni][1]);
        } else {
          const float* bp = B + (kk + tq) * LDB + wn + ni * 8 + gq;
          split_tf32(bp[0], bh[ni][0], bl[ni][0]);
          split_tf32(bp[4 * LDB], bh[ni][1], bl[ni][1]);
        }
      }
      // small terms first; every element sees the same MMA sequence
      // whatever the tile and warp layout
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int ni = 0; ni < NT; ++ni) mma_tf32(part[mi][ni], al[mi], bh[ni]);
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int ni = 0; ni < NT; ++ni) mma_tf32(part[mi][ni], ah[mi], bl[ni]);
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int ni = 0; ni < NT; ++ni) mma_tf32(part[mi][ni], ah[mi], bh[ni]);
    }
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int ni = 0; ni < NT; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] += part[mi][ni][e];
  }
  cp_async_wait<0>();
  __syncthreads();                 // the ring is free: it holds the partial

  float* red = smem;               // [BM][LDR]: this chunk's partial tile
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = wm + mi * 16 + gq + 8 * half;
#pragma unroll
      for (int ni = 0; ni < NT; ++ni)
        *reinterpret_cast<float2*>(red + r * T::LDR + wn + ni * 8 + 2 * tq) =
            make_float2(acc[mi][ni][2 * half], acc[mi][ni][2 * half + 1]);
    }
}

// After tile_chunk in every block of the tile's cluster: block `chunk`
// adds the chunks' partials in order for elements chunk*THREADS + tid,
// stepping by split*THREADS (the tile's reduction is shared by the
// cluster), and calls store(sum, m, n) for each element inside (M, N).
template <int BM, int BN, bool YT, class Store>
__device__ __forceinline__ void tile_reduce(const TileArgs& a, float* red,
                                            int m0, int n0, int chunk,
                                            Store&& store) {
  using T = Tile<BM, BN, YT>;
  // split > 1 only: the launch is then one cluster per output tile
  cg::cluster_group cluster = cg::this_cluster();
  if (a.split > 1) {
    cluster.sync();                // every chunk's partial is in place
  } else {
    __syncthreads();
  }
  const float* parts[MAX_SPLIT];
  for (int s = 0; s < a.split; ++s)
    parts[s] = a.split > 1 ? cluster.map_shared_rank(red, s) : red;
#pragma unroll 2
  for (int e = chunk * THREADS + threadIdx.x; e < BM * BN;
       e += a.split * THREADS) {
    const int r = e / BN, c = e % BN;
    const int m = m0 + r, n = n0 + c;
    if (m >= a.M || n >= a.N) continue;
    float v = parts[0][r * T::LDR + c];
    for (int s = 1; s < a.split; ++s) v += parts[s][r * T::LDR + c];
    store(v, m, n);
  }
  if (a.split > 1) cluster.sync();  // peers' shared memory stays until read
}

// Launch `kernel` (a tile kernel of BYTES dynamic shared memory) on a grid
// of (n_tiles * split, m_tiles) blocks: a plain launch for split 1, else
// one cluster of `split` blocks per output tile.
template <auto kernel, int BYTES, class... Args>
cudaError_t launch_tiles(int n_tiles, int m_tiles, int split,
                         cudaStream_t stream, Args... args) {
  if constexpr (BYTES > 48 * 1024) {
    // above 48 KB needs an opt-in, once per device (one bit each)
    static std::atomic<unsigned long long> opted{0};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
    if (!(opted.load() & bit)) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, BYTES);
      if (err != cudaSuccess) return err;
      opted.fetch_or(bit);
    }
  }
  if (split == 1) {               // no cluster: a plain launch
    kernel<<<dim3(n_tiles, m_tiles), THREADS, BYTES, stream>>>(args...);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_tiles * split, m_tiles);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = BYTES;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

}  // namespace

// DDMM: out = act(x @ y + bias) + residual, fp32 in and out, fp32-accurate
// products on the tensor cores (3xTF32).
//
// Replaces the TPU kernel src/repro/kernels/ddmm.py (ddmm / _ddmm_kernel),
// a (bm, bk) x (bk, bn) MXU tile loop with the same fused epilogue.
//
// What bounds it on the H100: the served products are narrow and tall in K
// ((1,1024)@(1024,40), (26,800)@(800,400), (80,1024)@(1024,2048)): a few
// MFLOP over a few MB of weights, bound by bytes, or by operations at
// 495/3 TFLOP/s for the largest (b6's (1024,256)@(256,1024)).  What held
// the SIMT kernel back was neither: one 64x64 tile per block and no split
// of K left 1-64 blocks walking up to 64 K steps on a 132-SM card.
//
// Design:
// - Tensor cores, fp32-accurate: each operand is split into two TF32 parts
//   and each product taken as lo*hi + hi*lo + hi*hi on
//   mma.sync.m16n8k8 (tf32x3.cuh).  The tensor cores' fp32 sums do not
//   round to nearest and their bias grows with the MMAs into one register:
//   each 32-deep stage sums into a fresh partial, added to the running
//   total by FADD.
// - Block tile BM x BN: BM = 16, 32 or 64 rows (from M), BN = 32 or 64
//   columns (from N), 4 warps (1 x 4 at 16 rows, else 2 x 2), K in stages
//   of 32 through a 3-deep cp.async ring; shared rows padded so fragment
//   reads hit 32 banks.  x is row-major (M, K); y is read through its
//   strides, row-major (K, N) or a transposed view of a contiguous (N, K)
//   matrix (a VIP's x @ xᵀ), each staged in the layout its 16-byte copies
//   come in.  Masked copies zero-fill: ragged M, N and K need no padding.
// - Split-K in one launch: the K stages fall into `split` chunks of
//   `kt_per` stages (the last may be shorter); the chunks of one output
//   tile form one thread-block cluster (split <= 8).  Each block leaves its
//   partial tile in shared memory; after a cluster barrier, block r adds
//   every chunk's partial over distributed shared memory, in chunk order
//   0..split-1, for its share of the tile's elements, applies the epilogue
//   and stores them coalesced.  One launch, no workspace, no atomics: the
//   same bits from run to run.  (shift_conv.cu's second reduction launch
//   costs a launch per product on a host-bound path; a cluster does not.)
// - The plan (kernels/ddmm.py: launch_plan) takes split and kt_per from K
//   and N only, never from M: every output element is the same in-order
//   sum of the same chunks whatever M, the tile height or the block that
//   computes it, so a (4M, K) @ (K, N) product equals four stacked
//   (M, K) @ (K, N) products bit for bit.  For a tile row short of a wave,
//   K splits into up to 8 chunks of at least 2 stages: every output tile
//   gets at least half of min(8, ceil(132 / n_tiles), k_tiles / 2) blocks.
// - Narrow N (N <= 8: b2's (80,2048)@(2048,1), b1's (26,400)@(400,5)): the
//   tensor-core tile would be mostly padding, so one warp per row of x
//   walks K with lane stride 32 (SIMT FFMA, one sum per column) and a
//   fixed xor-butterfly reduces the lanes; chosen by N alone.
// - Epilogue in the store: + bias, then the activation (relu keeps NaN, as
//   torch.relu and jax.nn.relu do), then + residual.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "tf32x3.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int BK = 32, STAGES = 3, THREADS = 128, APAD = 4, BPAD = 8;
constexpr int MAX_SPLIT = 8, NARROW_N = 8, NARROW_ROWS = 4;

struct Args {
  const float* x;
  const float* y;
  const float* bias;
  const float* res;
  float* out;
  int M, K, N, ldy, act, k_tiles, kt_per, split;
};

__device__ __forceinline__ float apply_act(float v, int act) {
  switch (act) {
    case 1:  // relu; NaN stays NaN (fmaxf would return 0)
      return v < 0.f ? 0.f : v;
    case 2: {  // gelu, tanh approximation (jax.nn.gelu's default)
      const float u = 0.7978845608028654f * (v + 0.044715f * v * v * v);
      return 0.5f * v * (1.f + tanhf(u));
    }
    case 3:  // silu
      return v / (1.f + expf(-v));
    case 4:  // tanh
      return tanhf(v);
    default:
      return v;
  }
}

__device__ __forceinline__ float epilogue(const Args& a, float v, int m,
                                          int n) {
  if (a.bias != nullptr) v += a.bias[n];
  v = apply_act(v, a.act);
  if (a.res != nullptr) v += a.res[(size_t)m * a.N + n];
  return v;
}

// YT: y is a transposed view (element (k, n) at y[n * ldy + k]), staged
// as Bs[n][k]; otherwise y[k * ldy + n], staged as Bs[k][n].
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

template <int BM, int BN, bool YT>
__global__ void __launch_bounds__(THREADS)
ddmm_tf32x3_kernel(Args a) {
  using T = Tile<BM, BN, YT>;
  constexpr int WARPS_M = BM == 16 ? 1 : 2, WARPS_N = 4 / WARPS_M;
  constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;
  constexpr int MT = WM / 16, NT = WN / 8;       // MMA tiles per warp
  constexpr int LDA = T::LDA, LDB = T::LDB;
  extern __shared__ __align__(16) float smem[];
  float* As = smem;                              // [STAGES][BM][LDA]
  float* Bs = smem + STAGES * T::A_STAGE;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int chunk = blockIdx.x % a.split;        // = the cluster rank
  const int m0 = blockIdx.y * BM, n0 = (blockIdx.x / a.split) * BN;
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
  // block `chunk` finishes elements chunk*THREADS + tid, stepping by
  // split*THREADS: the tile's reduction is shared by the cluster
#pragma unroll 2
  for (int e = chunk * THREADS + tid; e < BM * BN; e += a.split * THREADS) {
    const int r = e / BN, c = e % BN;
    const int m = m0 + r, n = n0 + c;
    if (m >= a.M || n >= a.N) continue;
    float v = parts[0][r * T::LDR + c];
    for (int s = 1; s < a.split; ++s) v += parts[s][r * T::LDR + c];
    a.out[(size_t)m * a.N + n] = epilogue(a, v, m, n);
  }
  if (a.split > 1) cluster.sync();  // peers' shared memory stays until read
}

// One warp per row of x: lane l sums x[m, k] * y[k, n] over k = l, l + 32,
// ... in order (SIMT FFMA), then a fixed xor butterfly adds the 32 lanes
// (each add commutes, so every lane holds the same bits).
__global__ void __launch_bounds__(NARROW_ROWS * 32)
ddmm_narrow_kernel(Args a, long long sk, long long sn) {
  const int lane = threadIdx.x & 31;
  const int m = blockIdx.x * NARROW_ROWS + (threadIdx.x >> 5);
  if (m >= a.M) return;
  float acc[NARROW_N];
#pragma unroll
  for (int n = 0; n < NARROW_N; ++n) acc[n] = 0.f;
  const float* __restrict__ xr = a.x + (size_t)m * a.K;
#pragma unroll 4
  for (int k = lane; k < a.K; k += 32) {
    const float xv = xr[k];
    const float* yr = a.y + k * sk;
#pragma unroll
    for (int n = 0; n < NARROW_N; ++n)
      if (n < a.N) acc[n] = fmaf(xv, yr[n * sn], acc[n]);
  }
  float v = 0.f;
#pragma unroll
  for (int n = 0; n < NARROW_N; ++n) {
    float s = acc[n];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == n) v = s;
  }
  if (lane < a.N) a.out[(size_t)m * a.N + lane] = epilogue(a, v, m, lane);
}

template <int BM, int BN, bool YT>
cudaError_t launch_mma(const Args& a, int n_tiles, int m_tiles,
                       cudaStream_t stream) {
  constexpr int bytes = Tile<BM, BN, YT>::BYTES;
  if constexpr (bytes > 48 * 1024) {
    // above 48 KB needs an opt-in, once per device (one bit each)
    static std::atomic<unsigned long long> opted{0};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
    if (!(opted.load() & bit)) {
      err = cudaFuncSetAttribute(ddmm_tf32x3_kernel<BM, BN, YT>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 bytes);
      if (err != cudaSuccess) return err;
      opted.fetch_or(bit);
    }
  }
  if (a.split == 1) {             // no cluster: a plain launch
    ddmm_tf32x3_kernel<BM, BN, YT>
        <<<dim3(n_tiles, m_tiles), THREADS, bytes, stream>>>(a);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_tiles * a.split, m_tiles);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, ddmm_tf32x3_kernel<BM, BN, YT>, a);
}

}  // namespace

// p holds, in order: M, K, N, ldy (y's non-unit stride), y_t (1: y is a
// transposed view, element (k, n) at y[n * ldy + k]; 0: at y[k * ldy + n]),
// act (0 none, 1 relu, 2 gelu (tanh), 3 silu, 4 tanh), then the launch plan
// (kernels/ddmm.py: launch_plan): narrow (1: the N <= 8 route), bm, bn,
// kt_per (K stages per chunk) and split (chunks, the cluster size).  bias /
// res may be null.  Returns cudaGetLastError() after the launch.
extern "C" int repro_ddmm(const float* x, const float* y, const float* bias,
                          const float* res, float* out, const int* p,
                          void* stream) {
  Args a;
  a.x = x;
  a.y = y;
  a.bias = bias;
  a.res = res;
  a.out = out;
  a.M = p[0];
  a.K = p[1];
  a.N = p[2];
  a.ldy = p[3];
  const int y_t = p[4], narrow = p[6], bm = p[7], bn = p[8];
  a.act = p[5];
  a.kt_per = p[9];
  a.split = p[10];
  a.k_tiles = a.K > 0 ? (a.K + BK - 1) / BK : 1;
  if (a.M == 0 || a.N == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (narrow) {
    if (a.N > NARROW_N) return static_cast<int>(cudaErrorInvalidValue);
    const long long sk = y_t ? 1 : a.ldy, sn = y_t ? a.ldy : 1;
    ddmm_narrow_kernel<<<(a.M + NARROW_ROWS - 1) / NARROW_ROWS,
                         NARROW_ROWS * 32, 0, st>>>(a, sk, sn);
    return static_cast<int>(cudaGetLastError());
  }
  if ((bm != 16 && bm != 32 && bm != 64) || (bn != 32 && bn != 64) ||
      a.split < 1 || a.split > MAX_SPLIT || a.kt_per < 1 ||
      a.split * a.kt_per < a.k_tiles ||
      (a.split - 1) * a.kt_per >= a.k_tiles)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_tiles = (a.N + bn - 1) / bn, m_tiles = (a.M + bm - 1) / bm;
  using Launch = cudaError_t (*)(const Args&, int, int, cudaStream_t);
  // [bm: 16, 32, 64][bn == 64][y_t]
  constexpr Launch kLaunch[3][2][2] = {
      {{launch_mma<16, 32, false>, launch_mma<16, 32, true>},
       {launch_mma<16, 64, false>, launch_mma<16, 64, true>}},
      {{launch_mma<32, 32, false>, launch_mma<32, 32, true>},
       {launch_mma<32, 64, false>, launch_mma<32, 64, true>}},
      {{launch_mma<64, 32, false>, launch_mma<64, 32, true>},
       {launch_mma<64, 64, false>, launch_mma<64, 64, true>}}};
  const int bi = bm == 16 ? 0 : bm == 32 ? 1 : 2;
  const cudaError_t err =
      kLaunch[bi][bn == 64][y_t != 0](a, n_tiles, m_tiles, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

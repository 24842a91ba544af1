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
// Design (the tile core is tf32x3_tile.cuh, shared with sddmm.cu):
// - Tensor cores, fp32-accurate: each operand is split into two TF32 parts
//   and each product taken as lo*hi + hi*lo + hi*hi on
//   mma.sync.m16n8k8 (tf32x3.cuh), each 32-deep stage summed into a fresh
//   partial.
// - Block tile BM x BN: BM = 16, 32 or 64 rows (from M), BN = 32 or 64
//   columns (from N), through a 3-deep cp.async ring; y row-major or a
//   transposed view (a VIP's x @ xᵀ).
// - Split-K in one launch: the chunks of one output tile form one
//   thread-block cluster (split <= 8) and add their partials over
//   distributed shared memory in chunk order; the block finishing an
//   element applies the epilogue and stores it.  No workspace, no atomics:
//   the same bits from run to run.  (shift_conv.cu's second reduction
//   launch costs a launch per product on a host-bound path; a cluster
//   does not.)
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
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3_tile.cuh"

namespace {

constexpr int NARROW_N = 8, NARROW_ROWS = 4;

struct Args {
  TileArgs t;                    // x, y, sizes and the K plan
  const float* bias;
  const float* res;
  float* out;
  int act;
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
  if (a.res != nullptr) v += a.res[(size_t)m * a.t.N + n];
  return v;
}

template <int BM, int BN, bool YT>
__global__ void __launch_bounds__(THREADS)
ddmm_tf32x3_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  const int chunk = blockIdx.x % a.t.split;      // = the cluster rank
  const int m0 = blockIdx.y * BM, n0 = (blockIdx.x / a.t.split) * BN;
  tile_chunk<BM, BN, YT>(a.t, m0, n0, chunk, smem);
  tile_reduce<BM, BN, YT>(a.t, smem, m0, n0, chunk,
                          [&](float v, int m, int n) {
                            a.out[(size_t)m * a.t.N + n] =
                                epilogue(a, v, m, n);
                          });
}

// One warp per row of x: lane l sums x[m, k] * y[k, n] over k = l, l + 32,
// ... in order (SIMT FFMA), then a fixed xor butterfly adds the 32 lanes
// (each add commutes, so every lane holds the same bits).
__global__ void __launch_bounds__(NARROW_ROWS * 32)
ddmm_narrow_kernel(Args a, long long sk, long long sn) {
  const int lane = threadIdx.x & 31;
  const int m = blockIdx.x * NARROW_ROWS + (threadIdx.x >> 5);
  if (m >= a.t.M) return;
  float acc[NARROW_N];
#pragma unroll
  for (int n = 0; n < NARROW_N; ++n) acc[n] = 0.f;
  const float* __restrict__ xr = a.t.x + (size_t)m * a.t.K;
#pragma unroll 4
  for (int k = lane; k < a.t.K; k += 32) {
    const float xv = xr[k];
    const float* yr = a.t.y + k * sk;
#pragma unroll
    for (int n = 0; n < NARROW_N; ++n)
      if (n < a.t.N) acc[n] = fmaf(xv, yr[n * sn], acc[n]);
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
  if (lane < a.t.N) a.out[(size_t)m * a.t.N + lane] = epilogue(a, v, m, lane);
}

template <int BM, int BN, bool YT>
cudaError_t launch_mma(const Args& a, int n_tiles, int m_tiles,
                       cudaStream_t stream) {
  return launch_tiles<ddmm_tf32x3_kernel<BM, BN, YT>,
                      Tile<BM, BN, YT>::BYTES>(n_tiles, m_tiles, a.t.split,
                                               stream, a);
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
  a.t.x = x;
  a.t.y = y;
  a.bias = bias;
  a.res = res;
  a.out = out;
  TileArgs& t = a.t;
  t.M = p[0];
  t.K = p[1];
  t.N = p[2];
  t.ldy = p[3];
  const int y_t = p[4], narrow = p[6], bm = p[7], bn = p[8];
  a.act = p[5];
  t.kt_per = p[9];
  t.split = p[10];
  t.k_tiles = t.K > 0 ? (t.K + BK - 1) / BK : 1;
  if (t.M == 0 || t.N == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (narrow) {
    if (t.N > NARROW_N) return static_cast<int>(cudaErrorInvalidValue);
    const long long sk = y_t ? 1 : t.ldy, sn = y_t ? t.ldy : 1;
    ddmm_narrow_kernel<<<(t.M + NARROW_ROWS - 1) / NARROW_ROWS,
                         NARROW_ROWS * 32, 0, st>>>(a, sk, sn);
    return static_cast<int>(cudaGetLastError());
  }
  if ((bm != 16 && bm != 32 && bm != 64) || (bn != 32 && bn != 64) ||
      t.split < 1 || t.split > MAX_SPLIT || t.kt_per < 1 ||
      t.split * t.kt_per < t.k_tiles ||
      (t.split - 1) * t.kt_per >= t.k_tiles)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_tiles = (t.N + bn - 1) / bn, m_tiles = (t.M + bm - 1) / bm;
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

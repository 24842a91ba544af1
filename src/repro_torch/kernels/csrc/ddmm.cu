// DDMM: out = act(x @ y + bias) + residual, fp32 in and out, fp32 accumulation.
//
// Replaces the TPU kernel src/repro/kernels/ddmm.py (ddmm / _ddmm_kernel),
// a (bm, bk) x (bk, bn) MXU tile loop with the same fused epilogue.
//
// What bounds it on the H100: in fp32 without tensor cores a large product
// is bound by operations (67 TFLOP/s of FFMA); the shapes on b4's path are
// tiny ((1,256)@(256,60)), where the launch and the 61 KB of weight reads
// dominate and the card is far from either bound.
//
// Design: a plain shared-memory tiled SIMT GEMM.  A block of 256 threads
// owns a 64x64 output tile and walks K in steps of 16, staging one x tile
// (stored k-major, so the inner loop reads a thread's four rows from one
// shared-memory row) and one y tile through shared memory; each thread
// keeps a 4x4 accumulator in registers.  Every load and store is masked,
// so ragged M, N and K (M = 1, N = 60) need no padding copies.  The
// epilogue (bias -> act -> residual) runs on the accumulators before the
// single store.  tf32/wgmma tiles are a later step: this version favours
// exact fp32 parity with the reference.
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64, BN = 64, BK = 16, TM = 4, TN = 4;
constexpr int THREADS = (BM / TM) * (BN / TN);   // 256

__device__ __forceinline__ float apply_act(float v, int act) {
  switch (act) {
    case 1:  // relu
      return fmaxf(v, 0.f);
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

__global__ void __launch_bounds__(THREADS)
ddmm_kernel(const float* __restrict__ x, const float* __restrict__ y,
            const float* __restrict__ bias, const float* __restrict__ res,
            float* __restrict__ out, int M, int K, int N, int act) {
  __shared__ float xs[BK][BM + 1];   // +1: the k-major stores hit distinct banks
  __shared__ float ys[BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // x tile: consecutive threads walk k (x is row-major over K)
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int r = e / BK, c = e % BK;
      const int gm = m0 + r, gk = k0 + c;
      xs[c][r] = (gm < M && gk < K) ? x[(size_t)gm * K + gk] : 0.f;
    }
    // y tile: consecutive threads walk n (y is row-major over N)
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int r = e / BN, c = e % BN;
      const int gk = k0 + r, gn = n0 + c;
      ys[r][c] = (gk < K && gn < N) ? y[(size_t)gk * N + gn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = ys[kk][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty * TM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx * TN + j;
      if (gn >= N) continue;
      float v = acc[i][j];
      if (bias != nullptr) v += bias[gn];
      v = apply_act(v, act);
      if (res != nullptr) v += res[(size_t)gm * N + gn];
      out[(size_t)gm * N + gn] = v;
    }
  }
}

}  // namespace

// act: 0 none, 1 relu, 2 gelu (tanh), 3 silu, 4 tanh.  bias / res may be
// null.  Returns cudaGetLastError() after the launch.
extern "C" int repro_ddmm(const float* x, const float* y, const float* bias,
                          const float* res, float* out, int M, int K, int N,
                          int act, void* stream) {
  if (M == 0 || N == 0) return 0;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  ddmm_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      x, y, bias, res, out, M, K, N, act);
  return static_cast<int>(cudaGetLastError());
}

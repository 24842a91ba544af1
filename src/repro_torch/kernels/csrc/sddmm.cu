// SDDMM: out = mask ⊙ (x @ y), fp32 in and out, fp32 accumulation.
//
// Replaces the TPU kernel src/repro/kernels/sddmm.py (sddmm /
// _sddmm_kernel): a (bm, bk) x (bk, bn) MXU tile loop that skips every
// (bm, bn) block whose mask is all zero (a block mask reduced on the device
// before the call and read from SMEM) and multiplies the live blocks by the
// mask in the epilogue (elementwise=True, the only mode the runtime uses).
//
// What bounds it on the H100: the sampled products, 2 * nnz(mask) * K
// operations, against x, y, the mask and the output moved once each.  At
// the masked VIP's (196, 512) x (512, 196) with a 5x5-window mask (nnz
// 4096) that is 4.2 MFLOP over 1.1 MB: bound by bytes (0.3 us), far below
// one launch, so the kernel is launch- and latency-bound at that size.
//
// Design: the tiled SIMT GEMM of ddmm.cu with a 32x32 output tile per block
// of 64 threads (4x4 accumulators each, K in steps of 16), so the 196-node
// VIP spreads over 49 blocks and block skipping works at a finer grain than
// the TPU's 128x128 blocks.  Each block first loads the mask elements its
// threads own in the epilogue (into registers) and decides liveness in the
// kernel with __syncthreads_or: no separate reduction pass, one launch.  A
// dead block does no K loop and writes exact zeros.  y is read through its
// two strides, so the VIP's y = xᵀ is a view and needs no transposed copy;
// the tile load walks whichever axis of y is contiguous.  Every load and
// store is masked, so ragged M, N and K need no padding copies.  A live
// tile may hold more than the TPU's block would, but elementwise=True
// multiplies by the mask, so the result does not depend on the tile size.
#include <cuda_runtime.h>

namespace {

constexpr int BM = 32, BN = 32, BK = 16, TM = 4, TN = 4;
constexpr int THREADS = (BM / TM) * (BN / TN);   // 64

__global__ void __launch_bounds__(THREADS)
sddmm_kernel(const float* __restrict__ x, const float* __restrict__ y,
             const float* __restrict__ mask, float* __restrict__ out, int M,
             int K, int N, long long ys_k, long long ys_n) {
  __shared__ float xs[BK][BM + 1];   // +1: the k-major stores hit distinct banks
  __shared__ float ys[BK][BN + 1];
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  // The mask elements this thread owns; the block is live if any is nonzero.
  float mk[TM][TN];
  int any = 0;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty * TM + i;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx * TN + j;
      mk[i][j] = (gm < M && gn < N) ? mask[(size_t)gm * N + gn] : 0.f;
      any |= mk[i][j] != 0.f;
    }
  }
  const bool live = __syncthreads_or(any);

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  if (live) {
    const bool y_k_contig = ys_k == 1;   // y = xᵀ: walk k across threads
    for (int k0 = 0; k0 < K; k0 += BK) {
      // x tile: consecutive threads walk k (x is row-major over K)
      for (int e = tid; e < BM * BK; e += THREADS) {
        const int r = e / BK, c = e % BK;
        const int gm = m0 + r, gk = k0 + c;
        xs[c][r] = (gm < M && gk < K) ? x[(size_t)gm * K + gk] : 0.f;
      }
      // y tile: consecutive threads walk y's contiguous axis
      for (int e = tid; e < BK * BN; e += THREADS) {
        const int r = y_k_contig ? e % BK : e / BN;
        const int c = y_k_contig ? e / BK : e % BN;
        const int gk = k0 + r, gn = n0 + c;
        ys[r][c] = (gk < K && gn < N) ? y[gk * ys_k + gn * ys_n] : 0.f;
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
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty * TM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx * TN + j;
      if (gn >= N) continue;
      out[(size_t)gm * N + gn] = live ? acc[i][j] * mk[i][j] : 0.f;
    }
  }
}

}  // namespace

// Output tile edge (square tiles): the grain of block skipping.
extern "C" int repro_sddmm_block() { return BM; }

// x: (M, K) row-major; y: (K, N) with element (k, n) at y[k*ys_k + n*ys_n];
// mask, out: (M, N) row-major.  Returns cudaGetLastError() after the launch.
extern "C" int repro_sddmm(const float* x, const float* y, const float* mask,
                           float* out, int M, int K, int N, long long ys_k,
                           long long ys_n, void* stream) {
  if (M == 0 || N == 0) return 0;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  sddmm_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      x, y, mask, out, M, K, N, ys_k, ys_n);
  return static_cast<int>(cudaGetLastError());
}

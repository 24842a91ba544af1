// SDDMM: out = mask ⊙ (x @ y), fp32 in and out, fp32-accurate products on
// the tensor cores (3xTF32).
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
// 4096) that is 4.2 MFLOP over 0.7 MB: bound by bytes (0.2 us), far below
// one launch, so the kernel is bound by latency at that size.  The SIMT
// kernel it replaces ran one 32x32 tile per block over all of K: 19 live
// blocks of 2 warps, each walking K = 512 in 32 synchronous steps.
//
// Design: DDMM's 3xTF32 tile core (tf32x3_tile.cuh) on 32x32 output
// tiles, the grain of block skipping:
// - Split-K: K falls into up to 8 chunks of at least 2 stages of 32, one
//   block each; the chunks of a tile form one thread-block cluster and add
//   their partials over distributed shared memory in chunk order (no
//   atomics, the same bits every run).  The split follows K alone
//   (kernels/sddmm.py: launch_plan): at the masked VIP, 19 live tiles x 8
//   chunks keep 152 blocks busy instead of 19.  x and y tiles come through
//   a 3-deep cp.async ring.
// - Liveness in the kernel, one launch: every block of a cluster reads the
//   whole 32x32 mask tile and decides with __syncthreads_or, so all reach
//   the same answer.  A dead cluster does no K loop and writes exact zeros
//   (even where x or y hold NaN or inf); it never waits on a cluster
//   barrier, since none of its blocks does.
// - The mask is multiplied in the store.  A live tile may hold more than
//   the TPU's block would, but elementwise=True multiplies by the mask, so
//   the result does not depend on the tile size.
// - y is read through its strides, row-major (K, N) or a transposed view
//   (the VIP's y = xᵀ needs no copy); both layouts give the MMAs the same
//   fragments, so the same bits.  Masked copies zero-fill ragged M, N, K.
#include <cuda_runtime.h>

#include "tf32x3_tile.cuh"

namespace {

constexpr int TILE = 32;           // BM = BN: the grain of block skipping

template <bool YT>
__global__ void __launch_bounds__(THREADS)
sddmm_tf32x3_kernel(TileArgs a, const float* __restrict__ mask,
                    float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  const int chunk = blockIdx.x % a.split;        // = the cluster rank
  const int m0 = blockIdx.y * TILE, n0 = (blockIdx.x / a.split) * TILE;
  int any = 0;
#pragma unroll
  for (int i = 0; i < TILE * TILE / THREADS; ++i) {
    const int e = threadIdx.x + i * THREADS;
    const int m = m0 + e / TILE, n = n0 + e % TILE;
    any |= m < a.M && n < a.N && mask[(size_t)m * a.N + n] != 0.f;
  }
  if (!__syncthreads_or(any)) {
    // dead: this block's share of the tile's exact zeros
    for (int e = chunk * THREADS + threadIdx.x; e < TILE * TILE;
         e += a.split * THREADS) {
      const int m = m0 + e / TILE, n = n0 + e % TILE;
      if (m < a.M && n < a.N) out[(size_t)m * a.N + n] = 0.f;
    }
    return;
  }
  tile_chunk<TILE, TILE, YT>(a, m0, n0, chunk, smem);
  tile_reduce<TILE, TILE, YT>(a, smem, m0, n0, chunk,
                              [&](float v, int m, int n) {
                                const size_t o = (size_t)m * a.N + n;
                                out[o] = v * mask[o];
                              });
}

}  // namespace

// Output tile edge (square tiles): the grain of block skipping.
extern "C" int repro_sddmm_block() { return TILE; }

// x: (M, K) row-major; y: (K, N), element (k, n) at y[n * ldy + k] when
// y_t (a transposed view) else at y[k * ldy + n]; mask, out: (M, N)
// row-major; the K plan (kernels/sddmm.py: launch_plan): kt_per stages of
// 32 per chunk, split chunks (the cluster size).  Returns
// cudaGetLastError() after the launch.
extern "C" int repro_sddmm(const float* x, const float* y, const float* mask,
                           float* out, int M, int K, int N, int ldy, int y_t,
                           int kt_per, int split, void* stream) {
  TileArgs a;
  a.x = x;
  a.y = y;
  a.M = M;
  a.K = K;
  a.N = N;
  a.ldy = ldy;
  a.k_tiles = K > 0 ? (K + BK - 1) / BK : 1;
  a.kt_per = kt_per;
  a.split = split;
  if (M == 0 || N == 0) return 0;
  if (split < 1 || split > MAX_SPLIT || kt_per < 1 ||
      split * kt_per < a.k_tiles || (split - 1) * kt_per >= a.k_tiles)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_tiles = (N + TILE - 1) / TILE, m_tiles = (M + TILE - 1) / TILE;
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      y_t ? launch_tiles<sddmm_tf32x3_kernel<true>,
                         Tile<TILE, TILE, true>::BYTES>(
                n_tiles, m_tiles, split, st, a, mask, out)
          : launch_tiles<sddmm_tf32x3_kernel<false>,
                         Tile<TILE, TILE, false>::BYTES>(
                n_tiles, m_tiles, split, st, a, mask, out);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

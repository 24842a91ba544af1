// ELL SpDMM, fp32 accumulation, in two layouts:
//   rows:    out[r, i] = sum_l val[i, l] * x2[r, idx[i, l]]   (the path's)
//   columns: Z[i, n]   = sum_l val[i, l] * Y[idx[i, l], n]    (the JAX one)
// The first is the second with Y = x2ᵀ and out = Zᵀ.
//
// Replaces the TPU kernel src/repro/kernels/spdmm.py (spdmm / _spdmm_kernel),
// which gathers (bm, bl) blocks of Y rows with jnp.take into VMEM and
// reduces them on the VPU.
//
// What bounds it on the H100: bytes.  Each output element costs L
// multiply-adds against one 4-byte read and one 4-byte write (L = 5 on b4's
// 25-joint skeleton): at b4's widest op, x2 (19200, 25), ~3.8 MB in and out,
// ~1.1 us at 3.35 TB/s, far from the FFMA roof.
//
// Rows design (ell_spdmm_rows_kernel; b4's right_t side hands it the
// (C·T, V) view of its (C, T, V) activation, no copy in or out): one block
// per chunk of `rows` rows of x2.  The block stages the (S1, L) pairs in
// shared memory once and streams its rows in as one flat span with 16-byte
// cp.async (a 25-float row is not 16-byte aligned; a span of a multiple of
// 4 rows is), overlapping the two.  Each thread then computes outputs
// (r, i) from shared memory, summing over l in order, and writes them as a
// flat span too: the (rows, S1) chunk of out is contiguous, so the stores
// are coalesced.  The wrapper picks `rows` (a multiple of 4) for several
// blocks per SM.
//
// Columns design (ell_spdmm_kernel; no path uses it): one block per tile
// of N columns covers all S1 rows; thread n walks the rows and, for each,
// the row's L (idx, val) pairs (one broadcast load per warp) and
// accumulates val * Y[idx, n]: loads of Y and stores of Z coalesced.
//
// Both: a padding slot has val == 0 and may carry any idx: an in-range idx
// is multiplied like any other slot (0 * Y, as the reference does), an
// out-of-range idx is skipped, so no slot reads out of bounds.
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
ell_spdmm_kernel(const int* __restrict__ idx, const float* __restrict__ val,
                 const float* __restrict__ y, float* __restrict__ z, int S1,
                 int L, int S2, int N) {
  const int n = blockIdx.x * THREADS + threadIdx.x;
  if (n >= N) return;
  for (int i = 0; i < S1; ++i) {
    const int* irow = idx + (size_t)i * L;
    const float* vrow = val + (size_t)i * L;
    float acc = 0.f;
    for (int l = 0; l < L; ++l) {
      const int j = __ldg(irow + l);
      if (static_cast<unsigned>(j) < static_cast<unsigned>(S2))
        acc = fmaf(__ldg(vrow + l), y[(size_t)j * N + n], acc);
    }
    z[(size_t)i * N + n] = acc;
  }
}


constexpr int ROWS_THREADS = 128;

__global__ void __launch_bounds__(ROWS_THREADS)
ell_spdmm_rows_kernel(const int* __restrict__ idx,
                      const float* __restrict__ val,
                      const float* __restrict__ x2, float* __restrict__ out,
                      int R, int S1, int L, int S2, int rows) {
  extern __shared__ __align__(16) float sm[];
  const int pairs = S1 * L;
  float* xs = sm;                                // [rows][S2], flat
  int* sidx = reinterpret_cast<int*>(sm + rows * S2);
  float* sval = sm + rows * S2 + pairs;
  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * rows;
  const int nr = min(rows, R - r0);
  const int span = nr * S2;
  const float* src = x2 + (size_t)r0 * S2;
  // rows * S2 % 4 == 0 keeps every block's span 16-byte aligned
  const bool vec = (rows * S2) % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(x2) & 15) == 0;
  int done = 0;
  if (vec) {
    for (int c = tid; c < span / 4; c += ROWS_THREADS)
      cp_async16(xs + 4 * c, src + 4 * c, true);
    done = span / 4 * 4;
  }
  for (int e = done + tid; e < span; e += ROWS_THREADS)
    cp_async4(xs + e, src + e, true);
  cp_async_commit();
  for (int e = tid; e < pairs; e += ROWS_THREADS) {
    sidx[e] = idx[e];
    sval[e] = val[e];
  }
  cp_async_wait<0>();
  __syncthreads();
  float* o = out + (size_t)r0 * S1;
  for (int e = tid; e < nr * S1; e += ROWS_THREADS) {
    const int r = e / S1, i = e - r * S1;
    const float* xr = xs + r * S2;
    float acc = 0.f;
    for (int l = 0; l < L; ++l) {
      const int j = sidx[i * L + l];
      if (static_cast<unsigned>(j) < static_cast<unsigned>(S2))
        acc = fmaf(sval[i * L + l], xr[j], acc);
    }
    o[e] = acc;
  }
}

}  // namespace

// idx, val: (S1, L); y: (S2, N); z: (S1, N).
// Returns cudaGetLastError() after the launch.
extern "C" int repro_ell_spdmm(const int* idx, const float* val,
                               const float* y, float* z, int S1, int L,
                               int S2, int N, void* stream) {
  if (S1 == 0 || N == 0) return 0;
  const dim3 grid((N + THREADS - 1) / THREADS);
  ell_spdmm_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      idx, val, y, z, S1, L, S2, N);
  return static_cast<int>(cudaGetLastError());
}

// idx, val: (S1, L); x2: (R, S2), row-major; out: (R, S1).  rows: x2 rows
// per block, a multiple of 4; shared memory holds rows * S2 floats and the
// S1 * L pairs (the wrapper keeps it within 48 KB).  Returns
// cudaGetLastError() after the launch.
extern "C" int repro_ell_spdmm_rows(const int* idx, const float* val,
                                    const float* x2, float* out, int R,
                                    int S1, int L, int S2, int rows,
                                    void* stream) {
  if (R == 0 || S1 == 0) return 0;
  if (rows < 4 || rows % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = 4 * ((size_t)rows * S2 + 2 * (size_t)S1 * L);
  if (bytes > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  ell_spdmm_rows_kernel<<<(R + rows - 1) / rows, ROWS_THREADS, bytes,
                          static_cast<cudaStream_t>(stream)>>>(
      idx, val, x2, out, R, S1, L, S2, rows);
  return static_cast<int>(cudaGetLastError());
}

// Shared by every launcher's error path.
extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

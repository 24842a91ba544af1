// ELL SpDMM: Z[i, n] = sum_l val[i, l] * Y[idx[i, l], n], fp32 accumulation.
//
// Replaces the TPU kernel src/repro/kernels/spdmm.py (spdmm / _spdmm_kernel),
// which gathers (bm, bl) blocks of Y rows with jnp.take into VMEM and
// reduces them on the VPU.
//
// What bounds it on the H100: bytes.  Each output element costs L
// multiply-adds against one 4-byte read of Y (L = 5 on b4's 25-joint
// skeleton), so at b4's (25, 5) x (25, 19200) the work is ~4.8 MFLOP over
// ~3.8 MB of Y and Z: a few microseconds of HBM traffic, far from the
// FFMA roof.
//
// Design: one block per tile of N columns covers all S1 rows.  Thread n
// walks the rows; for each row it reads the row's L (idx, val) pairs (the
// same address for every thread of the warp: one broadcast load, cached)
// and accumulates val * Y[idx, n].  Neighbouring threads read neighbouring
// n, so every load of Y and store of Z is coalesced.  A padding slot has
// val == 0 and may carry any idx: an in-range idx is multiplied like any
// other slot (0 * Y, as the reference does), an out-of-range idx is
// skipped, so no slot reads out of bounds.
#include <cuda_runtime.h>

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

// Shared by every launcher's error path.
extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Shift-conv: 2-D correlation of one (c_in, H, W) image with a
// (k1, k2, c_in/groups, c_out) weight as an implicit GEMM, fp32 accumulation.
//
// Replaces the TPU kernel src/repro/kernels/shift_conv.py (shift_conv2d /
// _shift_conv_valid / _shift_conv_kernel): k1*k2 shifted GEMMs over a
// VMEM-resident plane, SAME realized by pre-padding and stride by
// subsampling a stride-1 result.
//
// What bounds it on the H100: b4's 9x1 temporal convs do 2*9*C*C*T*V
// flops over C*T*V activations (C = 64..256, T*V = 950..3750), i.e. about
// 20..75 flops per byte moved, so in fp32 SIMT they are bound by operations
// (67 TFLOP/s FFMA), not by the 3.35 TB/s of HBM; the 1x1 graph-conv
// "theta" convs with c_in = 3 are bound by their bytes.
//
// Design: out[g*og + co, p] = sum_k W[k, g*og + co] * X[g, k, p] with
// k = (dy*k2 + dx)*cin_g + ci and p = oy*wo + ox.  The B operand is never
// materialized: each thread gathers X[ci, oy*sh + dy*dh - pad_t,
// ox*sw + dx*dw - pad_l] straight from the unpadded image, with bounds
// masks in place of the reference's explicit pad (same TF SAME split,
// computed by the wrapper).  Only the strided outputs are computed - the
// TPU kernel computes stride 1 and subsamples, which wastes half the work
// on b4's two stride-(2,1) convs.  A block of 256 threads owns a 64
// (out channels) x 64 (output pixels) tile, stages a 16-deep W tile and
// gathered X tile through shared memory per K step, and keeps a 4x4
// accumulator per thread.  Groups run as grid.z; dilation only scales the
// tap offsets.  The ragged W = 25 plane and every partial tile are masked.
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64, BN = 64, BK = 16, TM = 4, TN = 4;
constexpr int THREADS = (BM / TM) * (BN / TN);   // 256

struct ConvArgs {
  int cin_g, H, W, k2, cout, og, ho, wo, sh, sw, dh, dw, pad_t, pad_l, ktot;
};

__global__ void __launch_bounds__(THREADS)
shift_conv_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  float* __restrict__ out, ConvArgs a) {
  __shared__ float ws[BK][BM];
  __shared__ float xs[BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  const int g = blockIdx.z;
  const int co0 = blockIdx.y * BM;           // within the group
  const int p0 = blockIdx.x * BN;
  const int npix = a.ho * a.wo;
  const float* xg = x + (size_t)g * a.cin_g * a.H * a.W;

  // Each thread always loads the same tile column (THREADS % 64 == 0), so
  // its output pixel and its output channel are fixed for the whole K loop.
  const int col = tid % BN;
  const int row0 = tid / BN;                 // rows row0, row0 + 4, ...
  const int p = p0 + col;
  const bool p_ok = p < npix;
  const int oy = p_ok ? p / a.wo : 0, ox = p_ok ? p % a.wo : 0;
  const int iy0 = oy * a.sh - a.pad_t, ix0 = ox * a.sw - a.pad_l;
  const int co_ld = co0 + col;
  const bool co_ok = co_ld < a.og;
  const float* wcol = w + (size_t)g * a.og + co_ld;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < a.ktot; k0 += BK) {
#pragma unroll
    for (int r = row0; r < BK; r += THREADS / BN) {
      const int k = k0 + r;
      // W tile: row k of the (ktot, cout) weight matrix, coalesced over co
      ws[r][col] = (k < a.ktot && co_ok) ? wcol[(size_t)k * a.cout] : 0.f;
      // X tile: gather the shifted input pixel this (tap, ci) reads
      float v = 0.f;
      if (k < a.ktot && p_ok) {
        const int tap = k / a.cin_g, ci = k - tap * a.cin_g;
        const int dy = tap / a.k2, dx = tap - dy * a.k2;
        const int iy = iy0 + dy * a.dh, ix = ix0 + dx * a.dw;
        if (iy >= 0 && iy < a.H && ix >= 0 && ix < a.W)
          v = xg[((size_t)ci * a.H + iy) * a.W + ix];
      }
      xs[r][col] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float wa[TM], xb[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) wa[i] = ws[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) xb[j] = xs[kk][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(wa[i], xb[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int co = co0 + ty * TM + i;
    if (co >= a.og) continue;
    float* orow = out + ((size_t)g * a.og + co) * npix;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int pj = p0 + tx * TN + j;
      if (pj < npix) orow[pj] = acc[i][j];
    }
  }
}

}  // namespace

// x: (cin, H, W); w: (k1, k2, cin/groups, cout); out: (cout, ho, wo).
// The wrapper computes ho, wo and the SAME split (pad_t, pad_l).
// Returns cudaGetLastError() after the launch.
extern "C" int repro_shift_conv2d(const float* x, const float* w, float* out,
                                  int cin, int H, int W, int k1, int k2,
                                  int cout, int groups, int ho, int wo,
                                  int sh, int sw, int dh, int dw, int pad_t,
                                  int pad_l, void* stream) {
  ConvArgs a;
  a.cin_g = cin / groups;
  a.H = H;
  a.W = W;
  a.k2 = k2;
  a.cout = cout;
  a.og = cout / groups;
  a.ho = ho;
  a.wo = wo;
  a.sh = sh;
  a.sw = sw;
  a.dh = dh;
  a.dw = dw;
  a.pad_t = pad_t;
  a.pad_l = pad_l;
  a.ktot = k1 * k2 * a.cin_g;
  const int npix = ho * wo;
  if (npix == 0 || a.og == 0) return 0;
  const dim3 grid((npix + BN - 1) / BN, (a.og + BM - 1) / BM, groups);
  shift_conv_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      x, w, out, a);
  return static_cast<int>(cudaGetLastError());
}

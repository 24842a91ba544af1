// Shift-conv: 2-D correlation of a batch of (c_in, H, W) images with a
// (k1, k2, c_in/groups, c_out) weight as an implicit GEMM on the tensor
// cores, in 3xTF32 (fp32-accurate), fp32 accumulation.
//
// Replaces the TPU kernel src/repro/kernels/shift_conv.py (shift_conv2d /
// _shift_conv_valid / _shift_conv_kernel): k1*k2 shifted GEMMs over a
// VMEM-resident plane, SAME realized by pre-padding and stride by
// subsampling a stride-1 result.
//
// What bounds it on the H100: the ResNet layers do 2*K*c_out*pixels flops
// over activations and weights of a few MB, 50-500 flops per byte, so they
// are bound by operations.  fp32-accurate products on the tensor cores cost
// three TF32 products each (below), so the least time is 3*ops / 495
// TFLOP/s; the 1x1 convs with c_in = 3 are bound by their bytes.
//
// Design: out[g*og + co, p] = sum_k W[k, g*og + co] * X[g, k, p] with
// k = (dy*k2 + dx)*cin_g + ci and p = oy*wo + ox (M = og, N = pixels).
// - Tensor cores, fp32-accurate: every operand a is split into
//   hi = cvt.rna.tf32(a) and lo = cvt.rna.tf32(a - hi) (a - hi is exact),
//   and each product is hi*hi + hi*lo + lo*hi on
//   mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32.  The dropped lo*lo and the
//   rounding of lo are ~2^-22 of each product: fp32-level agreement with
//   the plain version, where one TF32 product (~2^-11) would not be.  The
//   tensor cores' fp32 accumulation does not round to nearest, and its bias
//   grows with the number of MMAs into one register (1.2e-5 of max|out| at
//   K = 4608 in one accumulator, on the card): each 32-deep stage sums into
//   a fresh partial, which an FADD adds to the running total.
// - Block tile BM (out channels) x BN (pixels), each 64 or 32 (narrow
//   planes, 49 and 196 pixels, waste fewer MMA columns; a shallow K takes
//   narrow tiles for blocks enough without a split), 4 warps in 2 x 2,
//   K in stages of 32 through a 3-deep cp.async ring (one __syncthreads per
//   stage: loads of stage s+2 overlap the MMAs of stage s).  Shared rows are
//   padded by 8 floats, so each warp's fragment reads hit 32 banks.
// - The W tile is row k of the (ktot, cout) weight, 16-byte copies where
//   og % 4 == 0 and 4-byte copies otherwise.  The X tile is gathered
//   straight from the unpadded image: a bounds mask replaces the
//   reference's pad (the wrapper computes the TF SAME split) and the copy
//   zero-fills.  Each thread loads fixed rows k = k0 + warp + 4i and walks
//   (ci, dx, dy) with counters, 4 rows at a time: no integer division in the
//   gather.  A 1x1 stride-1 conv ("dense") reads X as a plain (K, H*W)
//   matrix, 16 bytes at a time where H*W % 4 == 0.  Only strided outputs
//   are computed.
// - Split-K where the tiles alone are under one wave: the wrapper's plan
//   (kernels/shift_conv.py: launch_plan) gives a split that divides the K
//   tiles; block s writes its partial sums to slab s of the output buffer
//   and shift_conv_splitk_reduce adds the slabs in order 0..split-1 into
//   slab 0, the output.  No atomics:
//   results are the same bit for bit from run to run.  The plan depends on
//   the per-image problem only, so each image of a batch comes out as the
//   3-D call on it gives it, bit for bit.
// - grid.y runs batch x groups (y = b * groups + g); grid.x runs
//   (split, m tile, n tile).
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "tf32x3.cuh"

namespace {

constexpr int BK = 32, STAGES = 3, THREADS = 128, PAD = 8;

struct ConvArgs {
  int cin_g, H, W, k2, cout, og, ho, wo, sh, sw, dh, dw, pad_t, pad_l, ktot,
      groups, npix, m_tiles, n_tiles, kt_per;
  long long slab;              // elements of one split's partial (= out's)
};

template <int BM, int BN>
constexpr int smem_bytes() {
  return STAGES * BK * ((BM + PAD) + (BN + PAD)) * 4;
}

template <int BM, int BN, bool DENSE>
__global__ void __launch_bounds__(THREADS)
shift_conv_tf32x3_kernel(const float* __restrict__ x,
                         const float* __restrict__ w, float* __restrict__ out,
                         ConvArgs a) {
  constexpr int WM = BM / 2, WN = BN / 2;       // warp tile
  constexpr int MT = WM / 16, NT = WN / 8;      // MMA tiles per warp
  constexpr int LDA = BM + PAD, LDB = BN + PAD;
  constexpr int A_STAGE = BK * LDA, B_STAGE = BK * LDB;
  constexpr int NC = BN / 32;                   // gathered columns a thread
  extern __shared__ __align__(16) float smem[];
  float* As = smem;                             // [STAGES][BK][LDA]: W[k][m]
  float* Bs = smem + STAGES * A_STAGE;          // [STAGES][BK][LDB]: X[k][p]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  int bx = blockIdx.x;
  const int nt = bx % a.n_tiles;
  bx /= a.n_tiles;
  const int mt = bx % a.m_tiles, part = bx / a.m_tiles;
  const int img = blockIdx.y / a.groups, g = blockIdx.y % a.groups;
  const int m0 = mt * BM, p0 = nt * BN;
  const int HW = a.H * a.W;
  const float* xg = x + ((size_t)img * a.groups + g) * a.cin_g * HW;
  const float* wg = w + (size_t)g * a.og;
  out += part * a.slab + (size_t)img * a.cout * a.npix;
  const bool w_vec = a.og % 4 == 0 && a.cout % 4 == 0 &&
                     (reinterpret_cast<uintptr_t>(w) & 15) == 0;
  const bool x_vec = DENSE && HW % 4 == 0 &&
                     (reinterpret_cast<uintptr_t>(x) & 15) == 0;

  auto load_w = [&](int kt, float* dst) {
    const int k0 = kt * BK;
    if (w_vec) {
#pragma unroll
      for (int i = 0; i < BK * BM / 4 / THREADS; ++i) {
        const int c = tid + i * THREADS;
        const int r = c / (BM / 4), col = (c % (BM / 4)) * 4;
        const int k = k0 + r, m = m0 + col;
        const bool ok = k < a.ktot && m < a.og;
        cp_async16(dst + r * LDA + col, ok ? wg + (size_t)k * a.cout + m : w,
                   ok);
      }
    } else {
#pragma unroll 4
      for (int i = 0; i < BK * BM / THREADS; ++i) {
        const int e = tid + i * THREADS;
        const int r = e / BM, col = e % BM;
        const int k = k0 + r, m = m0 + col;
        const bool ok = k < a.ktot && m < a.og;
        cp_async4(dst + r * LDA + col, ok ? wg + (size_t)k * a.cout + m : w,
                  ok);
      }
    }
  };

  // the gather's per-thread state: its columns' input origin, and the
  // (k, ci, dx, dy) of the next row it loads (rows warp + 4i of each stage)
  int iy0[NC], ix0[NC];
  bool pok[NC];
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int p = p0 + lane + 32 * j;
    pok[j] = p < a.npix;
    const int oy = pok[j] ? p / a.wo : 0, ox = pok[j] ? p - oy * a.wo : 0;
    iy0[j] = oy * a.sh - a.pad_t;
    ix0[j] = ox * a.sw - a.pad_l;
  }
  const int kt0 = part * a.kt_per;
  int kr = kt0 * BK + warp;                     // one division per block
  int tap = kr / a.cin_g, ci = kr - tap * a.cin_g;
  int dy = tap / a.k2, dx = tap - dy * a.k2;

  auto load_x = [&](int kt, float* dst) {
    const int k0 = kt * BK;
    if constexpr (DENSE) {
      if (x_vec) {
#pragma unroll
        for (int i = 0; i < BK * BN / 4 / THREADS; ++i) {
          const int c = tid + i * THREADS;
          const int r = c / (BN / 4), col = (c % (BN / 4)) * 4;
          const int k = k0 + r, p = p0 + col;
          const bool ok = k < a.ktot && p < a.npix;
          cp_async16(dst + r * LDB + col, ok ? xg + (size_t)k * HW + p : x,
                     ok);
        }
      } else {
#pragma unroll 4
        for (int i = 0; i < BK * BN / THREADS; ++i) {
          const int e = tid + i * THREADS;
          const int r = e / BN, col = e % BN;
          const int k = k0 + r, p = p0 + col;
          const bool ok = k < a.ktot && p < a.npix;
          cp_async4(dst + r * LDB + col, ok ? xg + (size_t)k * HW + p : x,
                    ok);
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < BK / 4; ++i) {
        const int r = warp + 4 * i;
        const bool kok = kr < a.ktot;
        const int dyo = dy * a.dh, dxo = dx * a.dw;
        const float* xrow = xg + (size_t)ci * HW;
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          const int iy = iy0[j] + dyo, ix = ix0[j] + dxo;
          const bool ok = kok && pok[j] && (unsigned)iy < (unsigned)a.H &&
                          (unsigned)ix < (unsigned)a.W;
          cp_async4(dst + r * LDB + lane + 32 * j,
                    ok ? xrow + iy * a.W + ix : x, ok);
        }
        // next row: k + 4, carrying ci into dx and dx into dy
        kr += 4;
        ci += 4;
        while (ci >= a.cin_g) {
          ci -= a.cin_g;
          if (++dx == a.k2) {
            dx = 0;
            ++dy;
          }
        }
      }
    }
  };

  const int wm = (warp >> 1) * WM, wn = (warp & 1) * WN;
  const int gq = lane >> 2, tq = lane & 3;
  float acc[MT][NT][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  const int nk = a.kt_per;
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nk) {
      load_w(kt0 + st, As + st * A_STAGE);
      load_x(kt0 + st, Bs + st * B_STAGE);
    }
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();   // stage kt has landed (this thread's part)
    __syncthreads();               // ... everyone's; stage kt-1 is consumed
    const int nxt = kt + STAGES - 1;
    if (nxt < nk) {
      load_w(kt0 + nxt, As + (nxt % STAGES) * A_STAGE);
      load_x(kt0 + nxt, Bs + (nxt % STAGES) * B_STAGE);
    }
    cp_async_commit();
    const float* A = As + (kt % STAGES) * A_STAGE;
    const float* B = Bs + (kt % STAGES) * B_STAGE;
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
        // A fragment (16 x 8, row-major): (g, t), (g+8, t), (g, t+4),
        // (g+8, t+4) with A(m, k) = W[k][m]
        const float* ap = A + (kk + tq) * LDA + wm + mi * 16 + gq;
        split_tf32(ap[0], ah[mi][0], al[mi][0]);
        split_tf32(ap[8], ah[mi][1], al[mi][1]);
        split_tf32(ap[4 * LDA], ah[mi][2], al[mi][2]);
        split_tf32(ap[4 * LDA + 8], ah[mi][3], al[mi][3]);
      }
#pragma unroll
      for (int ni = 0; ni < NT; ++ni) {
        // B fragment (8 x 8, col): (k = t, n = g), (t+4, g)
        const float* bp = B + (kk + tq) * LDB + wn + ni * 8 + gq;
        split_tf32(bp[0], bh[ni][0], bl[ni][0]);
        split_tf32(bp[4 * LDB], bh[ni][1], bl[ni][1]);
      }
      // small terms first; MT x NT independent accumulators per term
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
    // the tensor cores' fp32 sums do not round to nearest: one stage's 12
    // MMAs go into a fresh partial, added to the total by FADD, so the
    // rounding bias cannot build up along K
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int ni = 0; ni < NT; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] += part[mi][ni][e];
  }
  cp_async_wait<0>();

  // C fragment: (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1)
#pragma unroll
  for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm + mi * 16 + gq + 8 * half;
      if (m >= a.og) continue;
      float* orow = out + (size_t)(g * a.og + m) * a.npix;
#pragma unroll
      for (int ni = 0; ni < NT; ++ni) {
        const int p = p0 + wn + ni * 8 + 2 * tq;
        if (p < a.npix) orow[p] = acc[mi][ni][2 * half];
        if (p + 1 < a.npix) orow[p + 1] = acc[mi][ni][2 * half + 1];
      }
    }
  }
}

// slab[0][i] = sum over s = 0..split-1, in that order, of slab[s][i]: the
// partials of split-K, n floats each, summed into the first
__global__ void __launch_bounds__(256)
shift_conv_splitk_reduce(float* slabs, long long n, int split) {
  const long long i0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  if (n % 4 == 0) {
    float4* s4 = reinterpret_cast<float4*>(slabs);
    const long long n4 = n / 4;
    for (long long i = i0; i < n4; i += stride) {
      float4 s = s4[i];
      for (int j = 1; j < split; ++j) {
        const float4 v = s4[j * n4 + i];
        s.x += v.x;
        s.y += v.y;
        s.z += v.z;
        s.w += v.w;
      }
      s4[i] = s;
    }
    return;
  }
  for (long long i = i0; i < n; i += stride) {
    float s = slabs[i];
    for (int j = 1; j < split; ++j) s += slabs[j * n + i];
    slabs[i] = s;
  }
}

template <int BM, int BN, bool DENSE>
cudaError_t launch_conv(const float* x, const float* w, float* dst,
                        const ConvArgs& a, int split, int images,
                        cudaStream_t stream) {
  constexpr int bytes = smem_bytes<BM, BN>();
  // above 48 KB needs an opt-in, once per device (one bit each)
  static std::atomic<unsigned long long> opted{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (!(opted.load() & bit)) {
    err = cudaFuncSetAttribute(shift_conv_tf32x3_kernel<BM, BN, DENSE>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return err;
    opted.fetch_or(bit);
  }
  const dim3 grid(a.m_tiles * a.n_tiles * split, images);
  shift_conv_tf32x3_kernel<BM, BN, DENSE>
      <<<grid, THREADS, bytes, stream>>>(x, w, dst, a);
  return cudaGetLastError();
}

}  // namespace

// x: (batch, cin, H, W); w: (k1, k2, cin/groups, cout); out: split slabs of
// (batch, cout, ho, wo), the first of which receives the result.  p holds, in order: batch, cin, H, W, k1, k2, cout, groups, ho,
// wo, sh, sw, dh, dw, pad_t, pad_l (the wrapper computes ho, wo and the
// SAME split), then the launch plan: the block tile bm x bn (each 64 or
// 32), the split-K factor (it divides the K tiles) and whether the conv is
// a 1x1 stride-1 "dense" one.  Returns cudaGetLastError() after the launches.
extern "C" int repro_shift_conv2d(const float* x, const float* w, float* out,
                                  const int* p, void* stream) {
  const int batch = p[0], cin = p[1], k1 = p[4], cout = p[6], groups = p[7],
            bm = p[16], bn = p[17], split = p[18], dense = p[19];
  ConvArgs a;
  a.cin_g = cin / groups;
  a.H = p[2];
  a.W = p[3];
  a.k2 = p[5];
  a.cout = cout;
  a.og = cout / groups;
  a.ho = p[8];
  a.wo = p[9];
  a.sh = p[10];
  a.sw = p[11];
  a.dh = p[12];
  a.dw = p[13];
  a.pad_t = p[14];
  a.pad_l = p[15];
  a.ktot = k1 * a.k2 * a.cin_g;
  a.groups = groups;
  a.npix = a.ho * a.wo;
  if (a.npix == 0 || a.og == 0 || batch == 0) return 0;
  const int k_tiles = (a.ktot + BK - 1) / BK;
  if ((bm != 64 && bm != 32) || (bn != 64 && bn != 32) || split < 1 ||
      k_tiles % split != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  a.m_tiles = (a.og + bm - 1) / bm;
  a.n_tiles = (a.npix + bn - 1) / bn;
  a.kt_per = k_tiles / split;
  a.slab = (long long)batch * cout * a.npix;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int images = batch * groups;
  using Launch = cudaError_t (*)(const float*, const float*, float*,
                                 const ConvArgs&, int, int, cudaStream_t);
  // [bm == 64][bn == 64][dense]
  constexpr Launch kLaunch[2][2][2] = {
      {{launch_conv<32, 32, false>, launch_conv<32, 32, true>},
       {launch_conv<32, 64, false>, launch_conv<32, 64, true>}},
      {{launch_conv<64, 32, false>, launch_conv<64, 32, true>},
       {launch_conv<64, 64, false>, launch_conv<64, 64, true>}}};
  const cudaError_t err =
      kLaunch[bm == 64][bn == 64][dense != 0](x, w, out, a, split, images, st);
  if (err != cudaSuccess || split == 1) return static_cast<int>(err);
  const long long n4 = a.slab % 4 == 0 ? a.slab / 4 : a.slab;
  const int blocks = static_cast<int>((n4 + 255) / 256 < 4096
                                          ? (n4 + 255) / 256 : 4096);
  shift_conv_splitk_reduce<<<blocks, 256, 0, st>>>(out, a.slab, split);
  return static_cast<int>(cudaGetLastError());
}

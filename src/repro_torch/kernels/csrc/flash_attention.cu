// Flash attention: o = softmax(scale · q kᵀ, causal / key-padding mask) v,
// GQA (kv head = q head / group), fp32 or bf16 in, fp32 running max, sum
// and accumulator, output in the input's type.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention / _fa_kernel): a (B, Hq, Sq/bq, Sk/bk) grid whose
// innermost k axis carries the online-softmax state (m, l, acc) in VMEM
// scratch across grid steps, skips k blocks entirely above the causal
// diagonal (the SDDMM dead-block skip), masks keys at j >= Sk, aligns query
// i with key i + (Sk - Sq), and writes acc / l, or 0 where l == 0.
//
// What bounds it on the H100: the products over the live (query, key)
// pairs, 4·D operations each (q·k and p·v), against q, k, v and o moved
// once each.  At the served prefills (Sq = Sk = 16-48, Hq 16, D 128, bf16)
// that is under 0.06 MFLOP per head and 0.4 MB: a few hundred nanoseconds,
// far below one launch.  At a 2048-token prefill the causal half holds
// 33.6M live pairs per layer, 17.2 GFLOP against 25 MB: bound by
// operations, 17 us at the bf16 tensor-core peak.
//
// Design (simple and right first; tensor cores, TMA and split-KV are
// later work): one block of 256 threads per (b, h, 64-query tile); the
// q tile is staged in shared memory as fp32 once, then a loop walks the
// 32-key tiles this q tile can see — the loop ends at the tile holding the
// last query's last live key, so dead tiles above the diagonal cost
// nothing and rows with no live key keep l = 0.  Thread (ty, tx) owns
// query rows 4·ty..4·ty+3: their scores for keys tx and tx+16 of the tile,
// their running m and l, and their output columns tx + 16·c, so the
// rescale by alpha needs no exchange.  Row max and row sum reduce over the
// 16 lanes of a half-warp with shuffles; p goes through shared memory to
// the p·v product.  Shared rows are padded to odd strides so the
// column-wise reads hit distinct banks.  q, k, v and o are read and written
// through their batch, head and sequence strides (the head dim must be
// contiguous), so the model's (B, S, H, D) activations pass as permuted
// views with no copy.  The head dim is padded with zeros to 64 or 128
// (D <= 128), which leaves every product unchanged.  expf, not __expf, and
// a division by l, as in the Pallas kernel, so fp32 results match the
// plain version to rounding.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64, BK = 32, TX = 16, TY = 16, THREADS = TX * TY;
constexpr int RM = BQ / TY;    // query rows per thread (4)
constexpr int CN = BK / TX;    // score columns per thread (2)
constexpr int MAX_D = 128;

struct Strides {
  long long b, h, s;           // element strides; the head dim's is 1
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);   // round to nearest even, as torch's .to()
}

template <int DP>
constexpr int smem_floats() {
  return BQ * (DP + 1) + BK * (DP + 1) + BK * DP + BQ * (BK + 1);
}

template <typename T, int DP>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int group, int Sq,
             int Sk, int D, int causal, float scale, Strides qs, Strides ks,
             Strides vs, Strides os) {
  extern __shared__ float smem[];
  float* Qs = smem;                       // [BQ][DP + 1]
  float* Ks = Qs + BQ * (DP + 1);         // [BK][DP + 1]
  float* Vs = Ks + BK * (DP + 1);         // [BK][DP]
  float* Ps = Vs + BK * DP;               // [BQ][BK + 1]
  constexpr int CD = DP / TX;             // output columns per thread

  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  // the tiles near the diagonal's end hold the most live keys: start them
  // first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / group;
  const int offset = Sk - Sq;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;

  for (int e = tid; e < BQ * DP; e += THREADS) {
    const int r = e / DP, d = e % DP, gq = q0 + r;
    Qs[r * (DP + 1) + d] =
        (gq < Sq && d < D) ? to_f(qb[gq * qs.s + d]) : 0.f;
  }
  // keys [0, kend) can be live for some row of this tile
  int kend = Sk;
  if (causal) kend = min(Sk, min(q0 + BQ, Sq) + offset);
  const int nkt = kend > 0 ? (kend + BK - 1) / BK : 0;

  float m[RM], l[RM], acc[RM][CD];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[i][c] = 0.f;
  }

  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();             // the last tile's K, V and P are consumed
    for (int e = tid; e < BK * DP; e += THREADS) {
      const int r = e / DP, d = e % DP, gk = k0 + r;
      const bool in = gk < Sk && d < D;
      Ks[r * (DP + 1) + d] = in ? to_f(kb[gk * ks.s + d]) : 0.f;
      Vs[r * DP + d] = in ? to_f(vb[gk * vs.s + d]) : 0.f;
    }
    __syncthreads();

    float s[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DP; ++d) {
      float a[RM], kk[CN];
#pragma unroll
      for (int i = 0; i < RM; ++i) a[i] = Qs[(ty * RM + i) * (DP + 1) + d];
#pragma unroll
      for (int j = 0; j < CN; ++j) kk[j] = Ks[(tx + TX * j) * (DP + 1) + d];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) s[i][j] = fmaf(a[i], kk[j], s[i][j]);
    }

    // online softmax; the 16 lanes sharing ty hold one row's 32 scores
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int row = ty * RM + i, qpos = q0 + row + offset;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int kpos = k0 + tx + TX * j;
        const bool live = kpos < Sk && (!causal || kpos <= qpos);
        s[i][j] = live ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      // a row with no live key yet keeps m = -inf: no inf - inf
      const float alpha = m[i] == -INFINITY ? 0.f : expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const float p = m_new == -INFINITY ? 0.f : expf(s[i][j] - m_new);
        Ps[row * (BK + 1) + tx + TX * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CD; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float p[RM], vv[CD];
#pragma unroll
      for (int i = 0; i < RM; ++i) p[i] = Ps[(ty * RM + i) * (BK + 1) + j];
#pragma unroll
      for (int c = 0; c < CD; ++c) vv[c] = Vs[j * DP + tx + TX * c];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int c = 0; c < CD; ++c) acc[i][c] = fmaf(p[i], vv[c], acc[i][c]);
    }
  }

  T* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int gq = q0 + ty * RM + i;
    if (gq >= Sq) continue;
    const float den = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int c = 0; c < CD; ++c) {
      const int d = tx + TX * c;
      if (d < D) ob[gq * os.s + d] = from_f<T>(acc[i][c] / den);
    }
  }
}

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Hq, int Hkv, int Sq, int Sk, int D, int causal, float scale,
           Strides qs, Strides ks, Strides vs, Strides os,
           cudaStream_t stream) {
  constexpr int bytes = smem_floats<DP>() * sizeof(float);
  // above 48 KB needs an opt-in (per device: set on every call)
  const cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  flash_kernel<T, DP><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Hq / Hkv, Sq, Sk, D,
      causal, scale, qs, ks, vs, os);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The largest head dim the kernel takes.
extern "C" int repro_flash_max_d() { return MAX_D; }

// q: (B, Hq, Sq, D), k/v: (B, Hkv, Sk, D), o like q; each addressed as
// base + b*s_b + h*s_h + i*s_s + d (the head dim contiguous).  dtype 0 is
// float32, 1 bfloat16.  Returns cudaGetLastError() after the launch.
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int Hq, int Hkv, int Sq, int Sk, int D, int causal, float scale,
    long long qsb, long long qsh, long long qss, long long ksb,
    long long ksh, long long kss, long long vsb, long long vsh,
    long long vss, long long osb, long long osh, long long oss,
    void* stream) {
  if (B == 0 || Hq == 0 || Sq == 0) return 0;
  if (D < 1 || D > MAX_D || Hkv < 1 || Hq % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss},
      os{osb, osh, oss};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return D <= 64 ? launch<float, 64>(q, k, v, o, B, Hq, Hkv, Sq, Sk, D,
                                       causal, scale, qs, ks, vs, os, st)
                   : launch<float, 128>(q, k, v, o, B, Hq, Hkv, Sq, Sk, D,
                                        causal, scale, qs, ks, vs, os, st);
  if (dtype == 1)
    return D <= 64
               ? launch<__nv_bfloat16, 64>(q, k, v, o, B, Hq, Hkv, Sq, Sk, D,
                                           causal, scale, qs, ks, vs, os, st)
               : launch<__nv_bfloat16, 128>(q, k, v, o, B, Hq, Hkv, Sq, Sk,
                                            D, causal, scale, qs, ks, vs, os,
                                            st);
  return static_cast<int>(cudaErrorInvalidValue);
}

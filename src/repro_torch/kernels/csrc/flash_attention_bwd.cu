// Flash attention backward: dq, dk, dv of o = softmax(scale · q kᵀ, causal
// mask) v from q, k, v, o, dO and the forward's log-sum-exp, recomputing
// the scores tile by tile so the (Sq, Sk) matrices never reach device
// memory.  GQA: dk and dv sum over the Hq / Hkv query heads of each kv
// head.  fp32 or bf16 in; every product, sum and the LSE in fp32; dq, dk
// and dv stored in the inputs' type.
//
// Replaces the XLA backward of the reference's training attention,
// src/repro/models/attention.py:_flash_bwd (the custom_vjp of
// flash_attention_xla, the exact XLA twin of the Pallas kernel
// kernels/flash_attention.py): D = rowsum(dO·O), p = exp(s − lse),
// dp = dO vᵀ, ds = p·(dp − D)·scale, dq = ds k, dk = dsᵀ q, dv = pᵀ dO.
// There the chunk scan runs in order and carries dq; here blocks run in
// any order, so the work is split by what each block owns: every output
// element has exactly one writer and no atomics, and two calls on the same
// inputs give the same bits.
//
// Causal with the forward's convention: query i sees keys j <= i + (Sk −
// Sq).  A row with no live key (Sq > Sk: lse = -inf) gets p = 0 and so
// contributes nothing; its dq is 0.
//
// What bounds it on the H100: the five products over the live (query, key)
// pairs, 2·D operations each (q·kᵀ, dO·vᵀ, dq, dk, dv), against q, k, v,
// o, dO, dq, dk, dv and the LSE moved once.  At llama3.2-1b's training
// shape (8 x 32/8 heads x 128 x 64, causal) that is 0.70 GFLOP and 17 MB
// per layer; at a 2048-token qwen3-0.6b prefill (16/8 heads of 128) 43
// GFLOP: both bound by operations.
//
// The design is the simple one, SIMT on fp32 registers (tensor cores,
// TMA and one fused pass with dq atomics are later work).  Three launches:
//   1. delta: one warp per row, D = Σ dO·O.
//   2. dk/dv: one block per (b, kv head, 32-key tile) keeps the tile's k
//      and v and its dk and dv accumulators on chip and walks the group's
//      query heads and the 64-query tiles at or below the diagonal: per
//      tile it recomputes s and dp (thread (ty, tx) owns rows 4·ty..+3 and
//      keys tx, tx+16), writes p and ds to shared memory, then adds pᵀ dO
//      and dsᵀ q (thread owns keys 2·ty, 2·ty+1 and columns tx + 16·c).
//   3. dq: one block per (b, q head, 64-query tile) keeps q, dO and its dq
//      accumulators on chip and walks the key tiles up to the diagonal,
//      recomputing s, dp and ds and adding ds k.
// Operands are read through their batch, head and sequence strides (the
// head dim contiguous) by scalar loads, so permuted (B, S, H, D) views and
// an expanded dO pass without a copy, at any alignment; the head dim is
// zero-padded to 64 or 128 in shared memory (D <= 128).  expf, as the
// reference's exp, so fp32 results match the plain version to rounding.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int MAX_D = 128;
constexpr int BQ = 64, BKV = 32, TX = 16, TY = 16, THREADS = TX * TY;
constexpr int RM = BQ / TY;     // query rows per thread in the scores (4)
constexpr int CN = BKV / TX;    // key columns per thread in the scores (2)
constexpr int KR = BKV / TY;    // key rows per thread in dk / dv (2)

struct Strides {
  long long b, h, s;            // element strides; the head dim's is 1
};

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);     // round to nearest even, as torch's cast
}

// shared layout of both tile kernels, in floats
template <int DP>
struct Smem {
  static constexpr int Q = 0;                        // [BQ][DP + 1]
  static constexpr int DO = Q + BQ * (DP + 1);       // [BQ][DP + 1]
  static constexpr int K = DO + BQ * (DP + 1);       // [BKV][DP + 1]
  static constexpr int V = K + BKV * (DP + 1);       // [BKV][DP + 1]
  static constexpr int P = V + BKV * (DP + 1);       // [BQ][BKV + 1]
  static constexpr int DS = P + BQ * (BKV + 1);      // [BQ][BKV + 1]
  static constexpr int LSE = DS + BQ * (BKV + 1);    // [BQ]
  static constexpr int DELTA = LSE + BQ;             // [BQ]
  static constexpr int FLOATS = DELTA + BQ;
};

// rows [r0, r0 + rows) of a (.., S, D) operand into a [rows][DP + 1] tile,
// zero past S and past D
template <int DP, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* base,
                                          long long stride, int r0,
                                          int rows, int S, int D) {
  for (int e = threadIdx.x; e < rows * DP; e += THREADS) {
    const int r = e / DP, d = e % DP, g = r0 + r;
    dst[r * (DP + 1) + d] =
        (g < S && d < D) ? load(base + g * stride + d) : 0.f;
  }
}

// the query tile's LSE and delta rows (0 past Sq: those rows are masked)
__device__ __forceinline__ void load_rows(float* lse_s, float* delta_s,
                                          const float* lse,
                                          const float* delta, int q0,
                                          int Sq) {
  if (threadIdx.x < BQ) {
    const int g = q0 + threadIdx.x;
    lse_s[threadIdx.x] = g < Sq ? lse[g] : 0.f;
    delta_s[threadIdx.x] = g < Sq ? delta[g] : 0.f;
  }
}

// p and ds of the (64-query, 32-key) tile in shared memory: thread (ty, tx)
// computes rows 4·ty + i and keys tx + 16·j
template <int DP>
__device__ __forceinline__ void scores(const float* sm, int q0, int k0,
                                       int Sq, int Sk, int offset,
                                       int causal, float scale,
                                       float (&p)[RM][CN],
                                       float (&ds)[RM][CN]) {
  using L = Smem<DP>;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  float s[RM][CN], dp[RM][CN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < CN; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < DP; ++d) {
    float a[RM], g[RM], kk[CN], vv[CN];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      a[i] = sm[L::Q + (ty * RM + i) * (DP + 1) + d];
      g[i] = sm[L::DO + (ty * RM + i) * (DP + 1) + d];
    }
#pragma unroll
    for (int j = 0; j < CN; ++j) {
      kk[j] = sm[L::K + (tx + TX * j) * (DP + 1) + d];
      vv[j] = sm[L::V + (tx + TX * j) * (DP + 1) + d];
    }
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        s[i][j] = fmaf(a[i], kk[j], s[i][j]);
        dp[i][j] = fmaf(g[i], vv[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = ty * RM + i, qpos = q0 + row;
    const float lse = sm[L::LSE + row], delta = sm[L::DELTA + row];
#pragma unroll
    for (int j = 0; j < CN; ++j) {
      const int kpos = k0 + tx + TX * j;
      const bool live = qpos < Sq && kpos < Sk &&
                        (!causal || kpos <= qpos + offset);
      p[i][j] = live ? expf(s[i][j] * scale - lse) : 0.f;
      ds[i][j] = p[i][j] * (dp[i][j] - delta) * scale;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                       float* __restrict__ delta, long long rows, int Hq,
                       int Sq, int D, Strides os, Strides gs) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * (THREADS / 32)
                        + warp;
  if (row >= rows) return;
  const int i = static_cast<int>(row % Sq);
  const long long bh = row / Sq;
  const int h = static_cast<int>(bh % Hq), b = static_cast<int>(bh / Hq);
  const T* orow = o + b * os.b + h * os.h + i * os.s;
  const T* grow = dout + b * gs.b + h * gs.h + i * gs.s;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32)
    acc = fmaf(load(grow + d), load(orow + d), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

template <int DP, typename T>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, int group, int Sq, int Sk, int D,
                      int causal, float scale, Strides qs, Strides ks,
                      Strides vs, Strides gs, Strides dks, Strides dvs) {
  using L = Smem<DP>;
  constexpr int CD = DP / TX;                // output columns per thread
  extern __shared__ float sm[];
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int k0 = blockIdx.x * BKV, hk = blockIdx.y, b = blockIdx.z;
  const int Hq = gridDim.y * group, offset = Sk - Sq;

  load_tile<DP>(sm + L::K, k + b * ks.b + hk * ks.h, ks.s, k0, BKV, Sk, D);
  load_tile<DP>(sm + L::V, v + b * vs.b + hk * vs.h, vs.s, k0, BKV, Sk, D);
  // query tiles that see some key of this tile: q + offset >= k0
  const int q_first = causal ? max(0, k0 - offset) : 0;
  const int nqt = (Sq + BQ - 1) / BQ;

  float dka[KR][CD], dva[KR][CD];
#pragma unroll
  for (int r = 0; r < KR; ++r)
#pragma unroll
    for (int c = 0; c < CD; ++c) dka[r][c] = dva[r][c] = 0.f;

  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const T* qb = q + b * qs.b + h * qs.h;
    const T* gb = dout + b * gs.b + h * gs.h;
    const long long rowbase = (static_cast<long long>(b) * Hq + h) * Sq;
    for (int qt = q_first / BQ; qt < nqt; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();             // the last tile's q, dO, p, ds consumed
      load_tile<DP>(sm + L::Q, qb, qs.s, q0, BQ, Sq, D);
      load_tile<DP>(sm + L::DO, gb, gs.s, q0, BQ, Sq, D);
      load_rows(sm + L::LSE, sm + L::DELTA, lse + rowbase, delta + rowbase,
                q0, Sq);
      __syncthreads();
      float p[RM][CN], ds[RM][CN];
      scores<DP>(sm, q0, k0, Sq, Sk, offset, causal, scale, p, ds);
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) {
          sm[L::P + (ty * RM + i) * (BKV + 1) + tx + TX * j] = p[i][j];
          sm[L::DS + (ty * RM + i) * (BKV + 1) + tx + TX * j] = ds[i][j];
        }
      __syncthreads();
      // dv += pᵀ dO, dk += dsᵀ q over the tile's queries
#pragma unroll 4
      for (int i = 0; i < BQ; ++i) {
        float pr[KR], sr[KR], gv[CD], qv[CD];
#pragma unroll
        for (int r = 0; r < KR; ++r) {
          pr[r] = sm[L::P + i * (BKV + 1) + ty * KR + r];
          sr[r] = sm[L::DS + i * (BKV + 1) + ty * KR + r];
        }
#pragma unroll
        for (int c = 0; c < CD; ++c) {
          gv[c] = sm[L::DO + i * (DP + 1) + tx + TX * c];
          qv[c] = sm[L::Q + i * (DP + 1) + tx + TX * c];
        }
#pragma unroll
        for (int r = 0; r < KR; ++r)
#pragma unroll
          for (int c = 0; c < CD; ++c) {
            dva[r][c] = fmaf(pr[r], gv[c], dva[r][c]);
            dka[r][c] = fmaf(sr[r], qv[c], dka[r][c]);
          }
      }
    }
  }

  T* dkb = dk + b * dks.b + hk * dks.h;
  T* dvb = dv + b * dvs.b + hk * dvs.h;
#pragma unroll
  for (int r = 0; r < KR; ++r) {
    const int key = k0 + ty * KR + r;
    if (key >= Sk) continue;
#pragma unroll
    for (int c = 0; c < CD; ++c) {
      const int d = tx + TX * c;
      if (d < D) {
        store(dkb + key * dks.s + d, dka[r][c]);
        store(dvb + key * dvs.s + d, dva[r][c]);
      }
    }
  }
}

template <int DP, typename T>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int group, int Sq, int Sk, int D, int causal,
                    float scale, Strides qs, Strides ks, Strides vs,
                    Strides gs, Strides dqs) {
  using L = Smem<DP>;
  constexpr int CD = DP / TX;
  extern __shared__ float sm[];
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  // the tiles near the diagonal's end walk the most keys: start them first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / group;
  const int offset = Sk - Sq;
  const long long rowbase = (static_cast<long long>(b) * gridDim.y + h) * Sq;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;

  load_tile<DP>(sm + L::Q, q + b * qs.b + h * qs.h, qs.s, q0, BQ, Sq, D);
  load_tile<DP>(sm + L::DO, dout + b * gs.b + h * gs.h, gs.s, q0, BQ, Sq,
                D);
  load_rows(sm + L::LSE, sm + L::DELTA, lse + rowbase, delta + rowbase, q0,
            Sq);
  // keys [0, kend) can be live for some row of this tile
  int kend = Sk;
  if (causal) kend = min(Sk, min(q0 + BQ, Sq) + offset);
  const int nkt = kend > 0 ? (kend + BKV - 1) / BKV : 0;

  float acc[RM][CD];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[i][c] = 0.f;

  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * BKV;
    __syncthreads();               // the last tile's k, v, ds consumed
    load_tile<DP>(sm + L::K, kb, ks.s, k0, BKV, Sk, D);
    load_tile<DP>(sm + L::V, vb, vs.s, k0, BKV, Sk, D);
    __syncthreads();
    float p[RM][CN], ds[RM][CN];
    scores<DP>(sm, q0, k0, Sq, Sk, offset, causal, scale, p, ds);
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j)
        sm[L::DS + (ty * RM + i) * (BKV + 1) + tx + TX * j] = ds[i][j];
    __syncthreads();
    // dq += ds k over the tile's keys
#pragma unroll 4
    for (int j = 0; j < BKV; ++j) {
      float sr[RM], kv[CD];
#pragma unroll
      for (int i = 0; i < RM; ++i)
        sr[i] = sm[L::DS + (ty * RM + i) * (BKV + 1) + j];
#pragma unroll
      for (int c = 0; c < CD; ++c) kv[c] = sm[L::K + j * (DP + 1) + tx + TX * c];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int c = 0; c < CD; ++c) acc[i][c] = fmaf(sr[i], kv[c], acc[i][c]);
    }
  }

  T* dqb = dq + b * dqs.b + h * dqs.h;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = q0 + ty * RM + i;
    if (row >= Sq) continue;
#pragma unroll
    for (int c = 0; c < CD; ++c) {
      const int d = tx + TX * c;
      if (d < D) store(dqb + row * dqs.s + d, acc[i][c]);
    }
  }
}

template <typename K>
cudaError_t opt_in_smem(K kernel, int bytes) {
  // above 48 KB needs an opt-in (per device: set on every call)
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <int DP, typename T>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, void* dq, void* dk, void* dv,
           float* delta, int B, int Hq, int Hkv, int Sq, int Sk, int D,
           int causal, float scale, const Strides* st, cudaStream_t stream) {
  const Strides &qs = st[0], &ks = st[1], &vs = st[2], &os = st[3],
                &gs = st[4], &dqs = st[5], &dks = st[6], &dvs = st[7];
  const T *qt = static_cast<const T*>(q), *kt = static_cast<const T*>(k),
          *vt = static_cast<const T*>(v), *ot = static_cast<const T*>(o),
          *gt = static_cast<const T*>(dout);
  const int group = Hq / Hkv;
  constexpr int bytes = Smem<DP>::FLOATS * sizeof(float);
  cudaError_t err;
  if (Sq > 0) {
    const long long rows = static_cast<long long>(B) * Hq * Sq;
    const int per = THREADS / 32;
    flash_bwd_delta_kernel<T><<<static_cast<unsigned>((rows + per - 1) / per),
                                THREADS, 0, stream>>>(ot, gt, delta, rows, Hq,
                                                      Sq, D, os, gs);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  if (Sk > 0) {          // with Sq = 0 it writes dk = dv = 0
    if ((err = opt_in_smem(flash_bwd_dkdv_kernel<DP, T>, bytes)) !=
        cudaSuccess)
      return static_cast<int>(err);
    const dim3 grid((Sk + BKV - 1) / BKV, Hkv, B);
    flash_bwd_dkdv_kernel<DP, T><<<grid, THREADS, bytes, stream>>>(
        qt, kt, vt, gt, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
        group, Sq, Sk, D, causal, scale, qs, ks, vs, gs, dks, dvs);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  if (Sq > 0) {          // with Sk = 0 it writes dq = 0
    if ((err = opt_in_smem(flash_bwd_dq_kernel<DP, T>, bytes)) != cudaSuccess)
      return static_cast<int>(err);
    const dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
    flash_bwd_dq_kernel<DP, T><<<grid, THREADS, bytes, stream>>>(
        qt, kt, vt, gt, lse, delta, static_cast<T*>(dq), group, Sq, Sk, D,
        causal, scale, qs, ks, vs, gs, dqs);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // namespace

// q, o, dout, dq: (B, Hq, Sq, D); k, v, dk, dv: (B, Hkv, Sk, D); each
// addressed as base + b*s_b + h*s_h + i*s_s + d (the head dim contiguous),
// with ``strides`` holding (s_b, s_h, s_s) of q, k, v, o, dout, dq, dk, dv
// in that order.  lse: the forward's fp32 (B, Hq, Sq), contiguous; delta:
// fp32 (B, Hq, Sq) scratch the caller allocates.  dtype 0 is float32, 1
// bfloat16.  Three launches on ``stream``; returns the first nonzero
// cudaGetLastError(), else 0.
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, void* dq, void* dk, void* dv,
    float* delta, int dtype, int B, int Hq, int Hkv, int Sq, int Sk, int D,
    int causal, float scale, const long long* strides, void* stream) {
  if (B == 0 || Hq == 0) return 0;
  if (D < 1 || D > MAX_D || Hkv < 1 || Hq % Hkv != 0 || Sq < 0 || Sk < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Strides st[8];
  for (int t = 0; t < 8; ++t)
    st[t] = Strides{strides[3 * t], strides[3 * t + 1], strides[3 * t + 2]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return D <= 64 ? launch<64, float>(q, k, v, o, dout, lse, dq, dk, dv,
                                       delta, B, Hq, Hkv, Sq, Sk, D, causal,
                                       scale, st, s)
                   : launch<128, float>(q, k, v, o, dout, lse, dq, dk, dv,
                                        delta, B, Hq, Hkv, Sq, Sk, D, causal,
                                        scale, st, s);
  if (dtype == 1)
    return D <= 64
               ? launch<64, __nv_bfloat16>(q, k, v, o, dout, lse, dq, dk, dv,
                                           delta, B, Hq, Hkv, Sq, Sk, D,
                                           causal, scale, st, s)
               : launch<128, __nv_bfloat16>(q, k, v, o, dout, lse, dq, dk,
                                            dv, delta, B, Hq, Hkv, Sq, Sk, D,
                                            causal, scale, st, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

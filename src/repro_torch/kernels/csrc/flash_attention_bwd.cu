// Flash attention backward: dq, dk, dv of o = softmax(scale · q kᵀ, causal
// mask) v from q, k, v, o, dO and the forward's log-sum-exp, recomputing
// the scores tile by tile so the (Sq, Sk) matrices never reach device
// memory.  GQA: dk and dv sum over the Hq / Hkv query heads of each kv
// head.  fp32 or bf16 in; sums and the LSE in fp32; dq, dk and dv stored
// in the inputs' type.
//
// Replaces the XLA backward of the reference's training attention,
// src/repro/models/attention.py:279 (_flash_bwd, the custom_vjp of
// flash_attention_xla, the exact XLA twin of the Pallas kernel
// kernels/flash_attention.py): D = rowsum(dO·O), p = exp(s − lse),
// dp = dO vᵀ, ds = p·(dp − D)·scale, dq = ds k, dk = dsᵀ q, dv = pᵀ dO.
// There the chunk scan runs in order and carries dq; here blocks run in
// any order, so the work is split by what each block owns: every output
// element has exactly one writer and no atomics, and two calls on the same
// inputs give the same bits (the training path's bit-for-bit resume rests
// on that).
//
// Causal with the forward's convention: query i sees keys j <= i + (Sk −
// Sq).  A row with no live key (Sq > Sk: lse = -inf) gets p = 0 and so
// contributes nothing; its dq is 0.
//
// What bounds it on the H100: operations.  The function needs five
// products over the live (query, key) pairs, 2·D operations each (q·kᵀ,
// dO·vᵀ, dq, dk, dv); this kernel runs seven (the dq pass recomputes q·kᵀ
// and dO·vᵀ, the price of one writer per output), against q, k, v, o, dO,
// dq, dk, dv and the LSE moved once.  At llama3.2-1b's training shape (8 x
// 32/8 heads x 128 x 64, causal) that is 0.70 GFLOP for the five products
// against 17 MB; at qwen3-0.6b's 2048-token shape (16/8 heads of 128) 43
// GFLOP against 34 MB: both far above the card's 295 operations a byte.
//
// Three launches: delta (D = rowsum(dO·O)), then dk/dv per key tile, then
// dq per query tile.
//
// bf16 (the training type): FlashAttention-2's deterministic backward on
// the tensor cores.
// - Every product runs on mma.sync.m16n8k16 bf16 with fp32 accumulators,
//   operands by ldmatrix from bf16 shared tiles (.trans where the product
//   contracts over the tile's rows).  p and ds reach the second-stage
//   products (pᵀ dO, dsᵀ q, ds k) from registers, as the A fragments the C
//   fragments of sᵀ and dpᵀ (or s and dp) already are, in PARTS bf16
//   parts: each the rounding of what the parts before leave.  Emulated in
//   fp32 at chip_smoke.py's backward shapes (tests/test_torch_flash_bwd.py),
//   one part (FlashAttention-2's single rounding) left dq, dk or dv up to
//   7.353e-3 of max|plain| from the plain version, within 6% of the 2^-7
//   bar; two parts keep p and ds to 2^-16 (3.049e-3), for 3 more products'
//   worth of MMAs.
// - Tiles stay bf16 in shared memory, rows padded by 8 elements (16 bytes)
//   so the 8 rows of each 8x8 ldmatrix land in 8 distinct 4-bank groups,
//   copied by 16-byte cp.async and double-buffered: the next tile's copy
//   overlaps this tile's math.  So bf16 operands must be 16-byte aligned
//   (base, batch, head and sequence strides, D % 8 == 0): the wrapper
//   checks and raises.
// - dk/dv: one block of 4 warps per (kv head, batch, 32-key tile); warps w
//   and w + 2 (w < 2) own keys 16w..16w+15, each for one half of every
//   query tile, their dk and dv in fp32 registers while the block walks the
//   group's query heads and the 64-query tiles at or below the diagonal
//   (q, dO, lse and delta double-buffered), 16 queries at a time:
//   sᵀ = k qᵀ, dpᵀ = v dOᵀ, then dv += pᵀ dO and dk += dsᵀ q.  At the end
//   warps 2 and 3 hand their sums to warps 0 and 1 through shared memory,
//   added in one fixed order.  Key tile 0 walks the most query tiles: the
//   grid's slowest index is the key tile, so the long blocks start first,
//   and 32-key tiles keep the longest block near the balanced share of the
//   SMs at qwen3's 2048 tokens (64-key tiles made it twice that).
// - dq: one block of 4 warps per (q head, batch, 64-query tile); warp w owns
//   rows 16w..16w+15 (their q and dO fragments, lse and delta in
//   registers) and walks the key tiles up to the diagonal (k and v
//   double-buffered), 16 keys at a time: s = q kᵀ, dp = dO vᵀ, dq += ds k.
//   The last query tiles walk the most keys: they start first.
// - Only tiles that cross the diagonal or an end are masked; masked pairs
//   get p = 0 (never exp of -inf - -inf).  exp2 of scores scaled by
//   scale·log2(e).
// - delta: CH = DVP / 8 lanes a row, one 16-byte load of o and of dO each.
// - At D = 128 the dk/dv block holds 86 KB of tiles, the dq block 102 KB
//   (rows of 136 bf16): two blocks an SM.
// - v's head dim DV may differ from q's and k's D, as in the forward: the
//   kernels are instantiated at (DP, DVP) = (64, 64), (128, 128) and (192,
//   128), the last for MLA (deepseek-v3: q·k over nope 128 + rope 64, v of
//   128).  dq and dk take D, dv, delta and the dO·vᵀ product DV.  At (192,
//   128) the dk/dv block splits its warps by output, not by query
//   (flash_bwd_dkdv_split_kernel: 96 dk or 64 dv accumulators a thread,
//   where the query split would hold 160), and the dq warps read q's
//   fragments from shared memory at every key tile in place of holding
//   them (96 dq accumulators); the dk/dv block holds 108,544 bytes of
//   tiles (rows of 200 and 136), the dq block 129,024.  The (64, 64) and
//   (128, 128) instantiations run the same arithmetic as before (DV only
//   bounds the copies of v and dO and the stores of dv).
//
// fp32 (parity checks only; no trained path): SIMT, as first written.
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
// an expanded dO pass without a copy, at any alignment.  expf, as the
// reference's exp, so fp32 results match the plain version to rounding.
//
// Both routes zero-pad q's and k's head dim to DP and v's to DVP in shared
// memory, which leaves every product unchanged.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bf16_mma.cuh"

namespace {

// The head dims the kernels take, as the forward's: q·k's D and v's DV up
// to MAX_D each, or D up to MAX_DQK with DV up to MAX_D.
constexpr int MAX_D = 128, MAX_DQK = 192;
constexpr int BQ = 64, BKV = 32, TX = 16, TY = 16, THREADS = TX * TY;
constexpr int RM = BQ / TY;     // query rows per thread in the scores (4)
constexpr int CN = BKV / TX;    // key columns per thread in the scores (2)
constexpr int KR = BKV / TY;    // key rows per thread in dk / dv (2)

struct Strides {
  long long b, h, s;            // element strides; the head dim's is 1
};

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

// shared layout of both tile kernels, in floats: q and k padded to DP,
// dO and v to DVP
template <int DP, int DVP>
struct Smem {
  static constexpr int Q = 0;                        // [BQ][DP + 1]
  static constexpr int DO = Q + BQ * (DP + 1);       // [BQ][DVP + 1]
  static constexpr int K = DO + BQ * (DVP + 1);      // [BKV][DP + 1]
  static constexpr int V = K + BKV * (DP + 1);       // [BKV][DVP + 1]
  static constexpr int P = V + BKV * (DVP + 1);      // [BQ][BKV + 1]
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

// s = q kᵀ over ``W`` columns of the [rows][W + 1] tiles at ``a`` (rows 4·ty
// + i) and ``b`` (rows tx + 16·j), added into ``acc`` in column order
template <int W>
__device__ __forceinline__ void tile_dots(const float* a, const float* b,
                                          float (&acc)[RM][CN]) {
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
#pragma unroll 8
  for (int d = 0; d < W; ++d) {
    float x[RM], y[CN];
#pragma unroll
    for (int i = 0; i < RM; ++i) x[i] = a[(ty * RM + i) * (W + 1) + d];
#pragma unroll
    for (int j = 0; j < CN; ++j) y[j] = b[(tx + TX * j) * (W + 1) + d];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
  }
}

// p and ds of the (64-query, 32-key) tile in shared memory: thread (ty, tx)
// computes rows 4·ty + i and keys tx + 16·j (s over DP, dp over DVP)
template <int DP, int DVP>
__device__ __forceinline__ void scores(const float* sm, int q0, int k0,
                                       int Sq, int Sk, int offset,
                                       int causal, float scale,
                                       float (&p)[RM][CN],
                                       float (&ds)[RM][CN]) {
  using L = Smem<DP, DVP>;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  float s[RM][CN], dp[RM][CN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < CN; ++j) s[i][j] = dp[i][j] = 0.f;
  tile_dots<DP>(sm + L::Q, sm + L::K, s);
  tile_dots<DVP>(sm + L::DO, sm + L::V, dp);
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

template <int DP, int DVP, typename T>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, int group, int Sq, int Sk, int D,
                      int DV, int causal, float scale, Strides qs,
                      Strides ks, Strides vs, Strides gs, Strides dks,
                      Strides dvs) {
  using L = Smem<DP, DVP>;
  constexpr int CD = DP / TX;                // dk columns per thread
  constexpr int CDV = DVP / TX;              // dv columns per thread
  extern __shared__ float sm[];
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int k0 = blockIdx.x * BKV, hk = blockIdx.y, b = blockIdx.z;
  const int Hq = gridDim.y * group, offset = Sk - Sq;

  load_tile<DP>(sm + L::K, k + b * ks.b + hk * ks.h, ks.s, k0, BKV, Sk, D);
  load_tile<DVP>(sm + L::V, v + b * vs.b + hk * vs.h, vs.s, k0, BKV, Sk,
                 DV);
  // query tiles that see some key of this tile: q + offset >= k0
  const int q_first = causal ? max(0, k0 - offset) : 0;
  const int nqt = (Sq + BQ - 1) / BQ;

  float dka[KR][CD], dva[KR][CDV];
#pragma unroll
  for (int r = 0; r < KR; ++r) {
#pragma unroll
    for (int c = 0; c < CD; ++c) dka[r][c] = 0.f;
#pragma unroll
    for (int c = 0; c < CDV; ++c) dva[r][c] = 0.f;
  }

  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const T* qb = q + b * qs.b + h * qs.h;
    const T* gb = dout + b * gs.b + h * gs.h;
    const long long rowbase = (static_cast<long long>(b) * Hq + h) * Sq;
    for (int qt = q_first / BQ; qt < nqt; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();             // the last tile's q, dO, p, ds consumed
      load_tile<DP>(sm + L::Q, qb, qs.s, q0, BQ, Sq, D);
      load_tile<DVP>(sm + L::DO, gb, gs.s, q0, BQ, Sq, DV);
      load_rows(sm + L::LSE, sm + L::DELTA, lse + rowbase, delta + rowbase,
                q0, Sq);
      __syncthreads();
      float p[RM][CN], ds[RM][CN];
      scores<DP, DVP>(sm, q0, k0, Sq, Sk, offset, causal, scale, p, ds);
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
        float pr[KR], sr[KR], gv[CDV], qv[CD];
#pragma unroll
        for (int r = 0; r < KR; ++r) {
          pr[r] = sm[L::P + i * (BKV + 1) + ty * KR + r];
          sr[r] = sm[L::DS + i * (BKV + 1) + ty * KR + r];
        }
#pragma unroll
        for (int c = 0; c < CDV; ++c)
          gv[c] = sm[L::DO + i * (DVP + 1) + tx + TX * c];
#pragma unroll
        for (int c = 0; c < CD; ++c)
          qv[c] = sm[L::Q + i * (DP + 1) + tx + TX * c];
#pragma unroll
        for (int r = 0; r < KR; ++r) {
#pragma unroll
          for (int c = 0; c < CDV; ++c)
            dva[r][c] = fmaf(pr[r], gv[c], dva[r][c]);
#pragma unroll
          for (int c = 0; c < CD; ++c)
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
      if (d < D) store(dkb + key * dks.s + d, dka[r][c]);
    }
#pragma unroll
    for (int c = 0; c < CDV; ++c) {
      const int d = tx + TX * c;
      if (d < DV) store(dvb + key * dvs.s + d, dva[r][c]);
    }
  }
}

template <int DP, int DVP, typename T>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int group, int Sq, int Sk, int D, int DV, int causal,
                    float scale, Strides qs, Strides ks, Strides vs,
                    Strides gs, Strides dqs) {
  using L = Smem<DP, DVP>;
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
  load_tile<DVP>(sm + L::DO, dout + b * gs.b + h * gs.h, gs.s, q0, BQ, Sq,
                 DV);
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
    load_tile<DVP>(sm + L::V, vb, vs.s, k0, BKV, Sk, DV);
    __syncthreads();
    float p[RM][CN], ds[RM][CN];
    scores<DP, DVP>(sm, q0, k0, Sq, Sk, offset, causal, scale, p, ds);
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

template <int DP, int DVP, typename T>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, void* dq, void* dk, void* dv,
           float* delta, int B, int Hq, int Hkv, int Sq, int Sk, int D,
           int DV, int causal, float scale, const Strides* st,
           cudaStream_t stream) {
  const Strides &qs = st[0], &ks = st[1], &vs = st[2], &os = st[3],
                &gs = st[4], &dqs = st[5], &dks = st[6], &dvs = st[7];
  const T *qt = static_cast<const T*>(q), *kt = static_cast<const T*>(k),
          *vt = static_cast<const T*>(v), *ot = static_cast<const T*>(o),
          *gt = static_cast<const T*>(dout);
  const int group = Hq / Hkv;
  constexpr int bytes = Smem<DP, DVP>::FLOATS * sizeof(float);
  cudaError_t err;
  if (Sq > 0) {
    const long long rows = static_cast<long long>(B) * Hq * Sq;
    const int per = THREADS / 32;
    flash_bwd_delta_kernel<T><<<static_cast<unsigned>((rows + per - 1) / per),
                                THREADS, 0, stream>>>(ot, gt, delta, rows, Hq,
                                                      Sq, DV, os, gs);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  if (Sk > 0) {          // with Sq = 0 it writes dk = dv = 0
    if ((err = opt_in_smem(flash_bwd_dkdv_kernel<DP, DVP, T>, bytes)) !=
        cudaSuccess)
      return static_cast<int>(err);
    const dim3 grid((Sk + BKV - 1) / BKV, Hkv, B);
    flash_bwd_dkdv_kernel<DP, DVP, T><<<grid, THREADS, bytes, stream>>>(
        qt, kt, vt, gt, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
        group, Sq, Sk, D, DV, causal, scale, qs, ks, vs, gs, dks, dvs);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  if (Sq > 0) {          // with Sk = 0 it writes dq = 0
    if ((err = opt_in_smem(flash_bwd_dq_kernel<DP, DVP, T>, bytes)) !=
        cudaSuccess)
      return static_cast<int>(err);
    const dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
    flash_bwd_dq_kernel<DP, DVP, T><<<grid, THREADS, bytes, stream>>>(
        qt, kt, vt, gt, lse, delta, static_cast<T*>(dq), group, Sq, Sk, D, DV,
        causal, scale, qs, ks, vs, gs, dqs);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// ---- bf16: tensor cores ----------------------------------------------------
constexpr int MQ = 64, MK = 64, MWARPS = 4, MTHREADS = 32 * MWARPS;
constexpr int MKV = 32;           // the dk/dv kernel's key tile
constexpr int PARTS = 2;          // bf16 parts of p and ds
constexpr int DTHREADS = 256;     // the delta kernel's block
constexpr float LOG2E = 1.4426950408889634f;
using bf16 = __nv_bfloat16;
static_assert(MTHREADS == 2 * MQ, "copy_rows: one thread per lse or delta");

// dk/dv: k and v (MKV rows each), q and dO double-buffered (4 x MQ rows),
// two stages of lse and delta rows; dq: q and dO, k and v double-buffered.
// Rows of q and k hold DP + 8 elements, rows of dO and v DVP + 8.
template <int DP, int DVP>
constexpr int dkdv_smem_bytes() {
  return (MKV + 2 * MQ) * (DP + DVP + 16) * 2 + 4 * MQ * 4;
}
template <int DP, int DVP>
constexpr int dq_smem_bytes() {
  return (MQ + 2 * MK) * (DP + DVP + 16) * 2;
}

// rows [r0, r0 + ROWS) of a (.., S, D) operand into a [ROWS][DP + 8] tile
// by 16-byte copies, zeros past S and past D
template <int DP, int ROWS = MQ>
__device__ __forceinline__ void copy_tile(bf16* dst, const bf16* base,
                                          long long stride, int r0, int S,
                                          int D) {
  constexpr int CH = DP / 8, LD = DP + 8;
  static_assert(ROWS * CH % MTHREADS == 0, "whole rounds of copies");
#pragma unroll
  for (int i = 0; i < ROWS * CH / MTHREADS; ++i) {
    const int c = threadIdx.x + i * MTHREADS, r = c / CH, d = (c % CH) * 8;
    const bool in = r0 + r < S && d < D;
    cp_async16(dst + r * LD + d, in ? base + (r0 + r) * stride + d : base,
               in);
  }
}

// the query tile's lse and delta rows by 4-byte copies (0 past Sq: those
// rows are masked)
__device__ __forceinline__ void copy_rows(float* lse_s, float* delta_s,
                                          const float* lse,
                                          const float* delta, int q0,
                                          int Sq) {
  const int t = threadIdx.x % MQ;
  const bool in = q0 + t < Sq;
  float* dst = threadIdx.x < MQ ? lse_s : delta_s;
  const float* src = threadIdx.x < MQ ? lse : delta;
  cp_async4(dst + t, in ? src + q0 + t : src, in);
}

template <int DP>
__global__ void __launch_bounds__(DTHREADS)
flash_bwd_delta_bf16_kernel(const bf16* __restrict__ o,
                            const bf16* __restrict__ dout,
                            float* __restrict__ delta, long long rows, int Hq,
                            int Sq, int D, Strides os, Strides gs) {
  constexpr int CH = DP / 8;            // lanes a row, 8 elements each
  const long long row =
      static_cast<long long>(blockIdx.x) * (DTHREADS / CH) + threadIdx.x / CH;
  const int d = (threadIdx.x % CH) * 8;
  float acc = 0.f;
  if (row < rows && d < D) {
    const int i = static_cast<int>(row % Sq);
    const long long bh = row / Sq;
    const int h = static_cast<int>(bh % Hq), b = static_cast<int>(bh / Hq);
    const uint4 ov = *reinterpret_cast<const uint4*>(
        o + b * os.b + h * os.h + i * os.s + d);
    const uint4 gv = *reinterpret_cast<const uint4*>(
        dout + b * gs.b + h * gs.h + i * gs.s + d);
    const __nv_bfloat162* op = reinterpret_cast<const __nv_bfloat162*>(&ov);
    const __nv_bfloat162* gp = reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 a = __bfloat1622float2(op[e]), g = __bfloat1622float2(gp[e]);
      acc = fmaf(g.x, a.x, acc);
      acc = fmaf(g.y, a.y, acc);
    }
  }
#pragma unroll
  for (int off = CH / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (row < rows && d == 0) delta[row] = acc;
}

template <int DP>
__global__ void __launch_bounds__(MTHREADS)
flash_bwd_dkdv_mma_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v,
                          const bf16* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          bf16* __restrict__ dk, bf16* __restrict__ dv,
                          int group, int Sq, int Sk, int D, int DV,
                          int causal, float scale, Strides qs, Strides ks,
                          Strides vs, Strides gs, Strides dks,
                          Strides dvs) {
  constexpr int LD = DP + 8;          // shared row stride, elements
  constexpr int KD = DP / 16;         // k16 steps over the head dim
  constexpr int ND = DP / 8;          // n8 tiles of the head dim
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);   // [MKV][LD]
  bf16* Vs = Ks + MKV * LD;                       // [MKV][LD]
  bf16* Qs = Vs + MKV * LD;                       // [2][MQ][LD]
  bf16* Gs = Qs + 2 * MQ * LD;                    // [2][MQ][LD] dO
  float* Ls = reinterpret_cast<float*>(Gs + 2 * MQ * LD);   // [2][MQ]
  float* Ds = Ls + 2 * MQ;                                  // [2][MQ]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;      // fragment row, column pair
  const int hk = blockIdx.x, b = blockIdx.y, k0 = blockIdx.z * MKV;
  const int Hq = gridDim.x * group, offset = Sk - Sq;
  const float scale_log2 = scale * LOG2E;

  copy_tile<DP, MKV>(Ks, k + b * ks.b + hk * ks.h, ks.s, k0, Sk, D);
  copy_tile<DP, MKV>(Vs, v + b * vs.b + hk * vs.h, vs.s, k0, Sk, DV);
  // query tiles that see some key of this tile: q + offset >= k0
  const int qt0 = causal ? max(0, k0 - offset) / MQ : 0;
  const int nq = max(0, (Sq + MQ - 1) / MQ - qt0);
  const int iters = group * nq;       // (query head, query tile) pairs
  auto load_q = [&](int it, int stage) {
    const int h = hk * group + it / nq, q0 = (qt0 + it % nq) * MQ;
    const long long rowbase = (static_cast<long long>(b) * Hq + h) * Sq;
    copy_tile<DP>(Qs + stage * MQ * LD, q + b * qs.b + h * qs.h, qs.s, q0,
                  Sq, D);
    copy_tile<DP>(Gs + stage * MQ * LD, dout + b * gs.b + h * gs.h, gs.s, q0,
                  Sq, DV);
    copy_rows(Ls + stage * MQ, Ds + stage * MQ, lse + rowbase,
              delta + rowbase, q0, Sq);
  };
  if (iters > 0) load_q(0, 0);
  cp_async_commit();

  // warps w and w + 2 own keys r0..r0+15 of the tile, each for one half
  // of every query tile (slices c0, c0 + 1 of 16 queries)
  const int r0 = (warp & 1) * 16, c0 = (warp >> 1) * 2;
  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;

  for (int it = 0; it < iters; ++it) {
    const int stage = it & 1, q0 = (qt0 + it % nq) * MQ;
    if (it + 1 < iters) load_q(it + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();               // this stage (and k, v) have landed
    __syncthreads();
    const bf16* Qt = Qs + stage * MQ * LD;
    const bf16* Gt = Gs + stage * MQ * LD;
    const float* Lt = Ls + stage * MQ;
    const float* Dt = Ds + stage * MQ;
    const bool edge = q0 + MQ > Sq || k0 + MKV > Sk ||
                      (causal && k0 + MKV - 1 > q0 + offset);
#pragma unroll 1
    for (int c = c0; c < c0 + 2; ++c) {          // 16 queries at a time
      // sᵀ = k qᵀ and dpᵀ = v dOᵀ for the warp's 16 keys: A fragments of k
      // and v, B fragments of qᵀ and dOᵀ are rows of q and dO (one
      // ldmatrix.x4 gives two k16 steps for 8 queries)
      float s[2][4] = {}, dp[2][4] = {};
#pragma unroll
      for (int kd = 0; kd < KD; kd += 2) {
        uint32_t ka[2][4], va[2][4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int col = (kd + h) * 16 + (lane >> 4) * 8;
          ldsm_x4(ka[h], Ks + (r0 + (lane & 15)) * LD + col);
          ldsm_x4(va[h], Vs + (r0 + (lane & 15)) * LD + col);
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int row = c * 16 + j * 8 + (lane & 7);
          uint32_t bq[4], bg[4];
          ldsm_x4(bq, Qt + row * LD + kd * 16 + (lane >> 3) * 8);
          ldsm_x4(bg, Gt + row * LD + kd * 16 + (lane >> 3) * 8);
          mma_bf16(s[j], ka[0], bq[0], bq[1]);
          mma_bf16(s[j], ka[1], bq[2], bq[3]);
          mma_bf16(dp[j], va[0], bg[0], bg[1]);
          mma_bf16(dp[j], va[1], bg[2], bg[3]);
        }
      }
      // p and ds at key r0 + gq (+8 for e >= 2), query c·16 + 8j + 2tq (+1)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = c * 16 + j * 8 + 2 * tq;
        const float2 l2 = *reinterpret_cast<const float2*>(Lt + col);
        const float2 d2 = *reinterpret_cast<const float2*>(Dt + col);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float l = (e & 1) ? l2.y : l2.x, del = (e & 1) ? d2.y : d2.x;
          float p = exp2f(fmaf(s[j][e], scale_log2, -l * LOG2E));
          if (edge) {
            const int key = k0 + r0 + gq + 8 * (e >> 1);
            const int query = q0 + col + (e & 1);
            if (query >= Sq || key >= Sk || (causal && key > query + offset))
              p = 0.f;
          }
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - del) * scale;
        }
      }
      // dv += pᵀ dO, dk += dsᵀ q over the 16 queries: the C fragments of
      // pᵀ and dsᵀ are A fragments; B fragments of dO and q by
      // ldmatrix.trans, two d tiles each; small parts first
      uint32_t pa[PARTS][4], sa[PARTS][4];
      a_parts(pa, s);
      a_parts(sa, dp);
#pragma unroll
      for (int dn = 0; dn < ND; dn += 2) {
        uint32_t bg[4], bq[4];
        const int off = (c * 16 + (lane & 15)) * LD + dn * 8 + (lane >> 4) * 8;
        ldsm_x4_t(bg, Gt + off);
        ldsm_x4_t(bq, Qt + off);
#pragma unroll
        for (int p = PARTS - 1; p >= 0; --p) {
          mma_bf16(dva[dn], pa[p], bg[0], bg[1]);
          mma_bf16(dva[dn + 1], pa[p], bg[2], bg[3]);
          mma_bf16(dka[dn], sa[p], bq[0], bq[1]);
          mma_bf16(dka[dn + 1], sa[p], bq[2], bq[3]);
        }
      }
    }
    __syncthreads();                  // this stage is consumed
  }
  cp_async_wait<0>();

  // warps 2 and 3 hand their sums to warps 0 and 1 through the (consumed)
  // q tiles, each lane its own fragments: one fixed order of adds, so the
  // same bits every call
  float* red = reinterpret_cast<float*>(Qs) + (warp & 1) * (2 * ND * 4 * 32);
  if (warp >= 2) {
#pragma unroll
    for (int j = 0; j < ND; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        red[(j * 4 + e) * 32 + lane] = dka[j][e];
        red[((ND + j) * 4 + e) * 32 + lane] = dva[j][e];
      }
  }
  __syncthreads();
  if (warp >= 2) return;
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dka[j][e] += red[(j * 4 + e) * 32 + lane];
      dva[j][e] += red[((ND + j) * 4 + e) * 32 + lane];
    }

  bf16* dkb = dk + b * dks.b + hk * dks.h;
  bf16* dvb = dv + b * dvs.b + hk * dvs.h;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = k0 + r0 + gq + 8 * half;
    if (key >= Sk) continue;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      const int d = j * 8 + 2 * tq;   // D % 8 == 0: the pair is all in
      if (d < D)
        *reinterpret_cast<uint32_t*>(dkb + key * dks.s + d) =
            pack_bf16(dka[j][2 * half], dka[j][2 * half + 1]);
      if (d < DV)
        *reinterpret_cast<uint32_t*>(dvb + key * dvs.s + d) =
            pack_bf16(dva[j][2 * half], dva[j][2 * half + 1]);
    }
  }
}

// dk/dv at (DP, DVP) = (192, 128), MLA's q·k over 192 and v of 128: the
// kernel above would hold 96 + 64 fp32 accumulators a thread.  Here the
// warps split the outputs instead of the queries: warps 0 and 1 own dv of
// keys 16w..16w+15 (64 accumulators), warps 2 and 3 dk of the same keys
// (96), each over every query of every tile, so no sums are handed over.
// Both recompute sᵀ = k qᵀ (over DP); the dk warps also dpᵀ = v dOᵀ (over
// DVP).  That issues one more q·kᵀ than the kernel above, and the dk warps
// do 88 of every 144 MMAs: a simple split, not a balanced one.
template <int DP, int DVP>
__global__ void __launch_bounds__(MTHREADS)
flash_bwd_dkdv_split_kernel(const bf16* __restrict__ q,
                            const bf16* __restrict__ k,
                            const bf16* __restrict__ v,
                            const bf16* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            bf16* __restrict__ dk, bf16* __restrict__ dv,
                            int group, int Sq, int Sk, int D, int DV,
                            int causal, float scale, Strides qs, Strides ks,
                            Strides vs, Strides gs, Strides dks,
                            Strides dvs) {
  constexpr int LD = DP + 8, LDV = DVP + 8;
  constexpr int KD = DP / 16, KDV = DVP / 16, ND = DP / 8, NDV = DVP / 8;
  static_assert(NDV <= ND, "the dv warps use the first NDV accumulators");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);   // [MKV][LD]
  bf16* Vs = Ks + MKV * LD;                       // [MKV][LDV]
  bf16* Qs = Vs + MKV * LDV;                      // [2][MQ][LD]
  bf16* Gs = Qs + 2 * MQ * LD;                    // [2][MQ][LDV] dO
  float* Ls = reinterpret_cast<float*>(Gs + 2 * MQ * LDV);  // [2][MQ]
  float* Ds = Ls + 2 * MQ;                                  // [2][MQ]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;      // fragment row, column pair
  const int hk = blockIdx.x, b = blockIdx.y, k0 = blockIdx.z * MKV;
  const int Hq = gridDim.x * group, offset = Sk - Sq;
  const float scale_log2 = scale * LOG2E;

  copy_tile<DP, MKV>(Ks, k + b * ks.b + hk * ks.h, ks.s, k0, Sk, D);
  copy_tile<DVP, MKV>(Vs, v + b * vs.b + hk * vs.h, vs.s, k0, Sk, DV);
  const int qt0 = causal ? max(0, k0 - offset) / MQ : 0;
  const int nq = max(0, (Sq + MQ - 1) / MQ - qt0);
  const int iters = group * nq;       // (query head, query tile) pairs
  auto load_q = [&](int it, int stage) {
    const int h = hk * group + it / nq, q0 = (qt0 + it % nq) * MQ;
    const long long rowbase = (static_cast<long long>(b) * Hq + h) * Sq;
    copy_tile<DP>(Qs + stage * MQ * LD, q + b * qs.b + h * qs.h, qs.s, q0,
                  Sq, D);
    copy_tile<DVP>(Gs + stage * MQ * LDV, dout + b * gs.b + h * gs.h, gs.s,
                   q0, Sq, DV);
    copy_rows(Ls + stage * MQ, Ds + stage * MQ, lse + rowbase,
              delta + rowbase, q0, Sq);
  };
  if (iters > 0) load_q(0, 0);
  cp_async_commit();

  const int r0 = (warp & 1) * 16;     // the warp's 16 keys of the tile
  const bool dv_warp = warp < 2;      // warp-uniform role
  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int it = 0; it < iters; ++it) {
    const int stage = it & 1, q0 = (qt0 + it % nq) * MQ;
    if (it + 1 < iters) load_q(it + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();               // this stage (and k, v) have landed
    __syncthreads();
    const bf16* Qt = Qs + stage * MQ * LD;
    const bf16* Gt = Gs + stage * MQ * LDV;
    const float* Lt = Ls + stage * MQ;
    const float* Dt = Ds + stage * MQ;
    const bool edge = q0 + MQ > Sq || k0 + MKV > Sk ||
                      (causal && k0 + MKV - 1 > q0 + offset);
#pragma unroll 1
    for (int c = 0; c < MQ / 16; ++c) {          // 16 queries at a time
      // sᵀ = k qᵀ (and, for dk, dpᵀ = v dOᵀ) for the warp's 16 keys
      float s[2][4] = {}, dp[2][4] = {};
#pragma unroll
      for (int kd = 0; kd < KD; kd += 2) {
        uint32_t ka[2][4];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          ldsm_x4(ka[hh], Ks + (r0 + (lane & 15)) * LD + (kd + hh) * 16 +
                              (lane >> 4) * 8);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          uint32_t bq[4];
          ldsm_x4(bq, Qt + (c * 16 + j * 8 + (lane & 7)) * LD + kd * 16 +
                          (lane >> 3) * 8);
          mma_bf16(s[j], ka[0], bq[0], bq[1]);
          mma_bf16(s[j], ka[1], bq[2], bq[3]);
        }
      }
      if (!dv_warp) {
#pragma unroll
        for (int kd = 0; kd < KDV; kd += 2) {
          uint32_t va[2][4];
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            ldsm_x4(va[hh], Vs + (r0 + (lane & 15)) * LDV + (kd + hh) * 16 +
                                (lane >> 4) * 8);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            uint32_t bg[4];
            ldsm_x4(bg, Gt + (c * 16 + j * 8 + (lane & 7)) * LDV + kd * 16 +
                            (lane >> 3) * 8);
            mma_bf16(dp[j], va[0], bg[0], bg[1]);
            mma_bf16(dp[j], va[1], bg[2], bg[3]);
          }
        }
      }
      // p and ds at key r0 + gq (+8 for e >= 2), query c·16 + 8j + 2tq (+1)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = c * 16 + j * 8 + 2 * tq;
        const float2 l2 = *reinterpret_cast<const float2*>(Lt + col);
        const float2 d2 = *reinterpret_cast<const float2*>(Dt + col);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float l = (e & 1) ? l2.y : l2.x, del = (e & 1) ? d2.y : d2.x;
          float p = exp2f(fmaf(s[j][e], scale_log2, -l * LOG2E));
          if (edge) {
            const int key = k0 + r0 + gq + 8 * (e >> 1);
            const int query = q0 + col + (e & 1);
            if (query >= Sq || key >= Sk || (causal && key > query + offset))
              p = 0.f;
          }
          // the dv warps keep p, the dk warps ds
          s[j][e] = dv_warp ? p : p * (dp[j][e] - del) * scale;
        }
      }
      // dv += pᵀ dO (dv warps) or dk += dsᵀ q (dk warps) over the 16
      // queries, B fragments by ldmatrix.trans; small parts first
      uint32_t pa[PARTS][4];
      a_parts(pa, s);
      const bf16* src = dv_warp ? Gt : Qt;
      const int ld = dv_warp ? LDV : LD, nd = dv_warp ? NDV : ND;
#pragma unroll
      for (int dn = 0; dn < ND; dn += 2) {
        if (dn >= nd) break;
        uint32_t bb[4];
        ldsm_x4_t(bb, src + (c * 16 + (lane & 15)) * ld + dn * 8 +
                          (lane >> 4) * 8);
#pragma unroll
        for (int p = PARTS - 1; p >= 0; --p) {
          mma_bf16(acc[dn], pa[p], bb[0], bb[1]);
          mma_bf16(acc[dn + 1], pa[p], bb[2], bb[3]);
        }
      }
    }
    __syncthreads();                  // this stage is consumed
  }
  cp_async_wait<0>();

  bf16* out = dv_warp ? dv + b * dvs.b + hk * dvs.h
                      : dk + b * dks.b + hk * dks.h;
  const long long os = dv_warp ? dvs.s : dks.s;
  const int width = dv_warp ? DV : D;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = k0 + r0 + gq + 8 * half;
    if (key >= Sk) continue;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      const int d = j * 8 + 2 * tq;   // D, DV % 8 == 0: the pair is all in
      if (d < width)
        *reinterpret_cast<uint32_t*>(out + key * os + d) =
            pack_bf16(acc[j][2 * half], acc[j][2 * half + 1]);
    }
  }
}

template <int DP, int DVP>
__global__ void __launch_bounds__(MTHREADS)
flash_bwd_dq_mma_kernel(const bf16* __restrict__ q,
                        const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        bf16* __restrict__ dq, int group, int Sq, int Sk,
                        int D, int DV, int causal, float scale, Strides qs,
                        Strides ks, Strides vs, Strides gs, Strides dqs) {
  constexpr int LD = DP + 8, LDV = DVP + 8;
  constexpr int KD = DP / 16, KDV = DVP / 16, ND = DP / 8;
  // q's A fragments stay in registers up to DP = 128; at 192 (96 dq
  // accumulators) they are read again from shared memory each key tile
  constexpr bool KEEP_Q = DP <= 128;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);   // [MQ][LD]
  bf16* Gs = Qs + MQ * LD;                        // [MQ][LDV] dO
  bf16* Ks = Gs + MQ * LDV;                       // [2][MK][LD]
  bf16* Vs = Ks + 2 * MK * LD;                    // [2][MK][LDV]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  // the query tiles near the diagonal's end walk the most keys: the grid's
  // slowest index runs them first
  const int h = blockIdx.x, b = blockIdx.y, hk = h / group;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * MQ;
  const int offset = Sk - Sq;
  const float scale_log2 = scale * LOG2E;
  const bf16* kb = k + b * ks.b + hk * ks.h;
  const bf16* vb = v + b * vs.b + hk * vs.h;

  copy_tile<DP>(Qs, q + b * qs.b + h * qs.h, qs.s, q0, Sq, D);
  copy_tile<DVP>(Gs, dout + b * gs.b + h * gs.h, gs.s, q0, Sq, DV);
  // keys [0, kend) can be live for some row of this tile
  int kend = Sk;
  if (causal) kend = min(Sk, min(q0 + MQ, Sq) + offset);
  const int nkt = kend > 0 ? (kend + MK - 1) / MK : 0;
  auto load_kv = [&](int kt, int stage) {
    copy_tile<DP>(Ks + stage * MK * LD, kb, ks.s, kt * MK, Sk, D);
    copy_tile<DVP>(Vs + stage * MK * LDV, vb, vs.s, kt * MK, Sk, DV);
  };
  if (nkt > 0) load_kv(0, 0);
  cp_async_commit();

  // rows r0 + gq and r0 + gq + 8: lse (log2 units) and delta, 0 past Sq
  const int r0 = warp * 16;
  const long long rowbase = (static_cast<long long>(b) * gridDim.x + h) * Sq;
  float lrow[2], drow[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + r0 + gq + 8 * half;
    lrow[half] = row < Sq ? lse[rowbase + row] * LOG2E : 0.f;
    drow[half] = row < Sq ? delta[rowbase + row] : 0.f;
  }
  uint32_t qf[KEEP_Q ? KD : 1][4], gf[KDV][4];
  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int kt = 0; kt < nkt; ++kt) {
    const int stage = kt & 1, k0 = kt * MK;
    if (kt + 1 < nkt) load_kv(kt + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();               // tile kt (and q, dO) have landed
    __syncthreads();
    if (kt == 0) {
      // A fragments of q and dO (16 x 16 per step), kept for every tile
#pragma unroll
      for (int kd = 0; kd < KDV; ++kd)
        ldsm_x4(gf[kd], Gs + (r0 + (lane & 15)) * LDV + kd * 16 +
                            (lane >> 4) * 8);
      if constexpr (KEEP_Q) {
#pragma unroll
        for (int kd = 0; kd < KD; ++kd)
          ldsm_x4(qf[kd], Qs + (r0 + (lane & 15)) * LD + kd * 16 +
                              (lane >> 4) * 8);
      }
    }
    const bf16* Kt = Ks + stage * MK * LD;
    const bf16* Vt = Vs + stage * MK * LDV;
    const bool edge = k0 + MK > Sk || q0 + MQ > Sq ||
                      (causal && k0 + MK - 1 > q0 + offset);
#pragma unroll 1
    for (int c = 0; c < MK / 16; ++c) {          // 16 keys at a time
      // s = q kᵀ over DP and dp = dO vᵀ over DVP: B fragments are rows of
      // k and v
      float s[2][4] = {}, dp[2][4] = {};
#pragma unroll
      for (int kd = 0; kd < KD; kd += 2) {
        uint32_t a[2][4];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          if constexpr (KEEP_Q) {
#pragma unroll
            for (int e = 0; e < 4; ++e) a[hh][e] = qf[kd + hh][e];
          } else {
            ldsm_x4(a[hh], Qs + (r0 + (lane & 15)) * LD + (kd + hh) * 16 +
                               (lane >> 4) * 8);
          }
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          uint32_t bk[4];
          ldsm_x4(bk, Kt + (c * 16 + j * 8 + (lane & 7)) * LD + kd * 16 +
                          (lane >> 3) * 8);
          mma_bf16(s[j], a[0], bk[0], bk[1]);
          mma_bf16(s[j], a[1], bk[2], bk[3]);
        }
      }
#pragma unroll
      for (int kd = 0; kd < KDV; kd += 2) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          uint32_t bv[4];
          ldsm_x4(bv, Vt + (c * 16 + j * 8 + (lane & 7)) * LDV + kd * 16 +
                          (lane >> 3) * 8);
          mma_bf16(dp[j], gf[kd], bv[0], bv[1]);
          mma_bf16(dp[j], gf[kd + 1], bv[2], bv[3]);
        }
      }
      // ds at row r0 + gq (+8 for e >= 2), key k0 + c·16 + 8j + 2tq (+1)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int half = e >> 1;
          float p = exp2f(fmaf(s[j][e], scale_log2, -lrow[half]));
          if (edge) {
            const int key = k0 + c * 16 + j * 8 + 2 * tq + (e & 1);
            const int query = q0 + r0 + gq + 8 * half;
            if (query >= Sq || key >= Sk || (causal && key > query + offset))
              p = 0.f;
          }
          dp[j][e] = p * (dp[j][e] - drow[half]) * scale;
        }
      // dq += ds k over the 16 keys: B fragments of k by ldmatrix.trans
      uint32_t sa[PARTS][4];
      a_parts(sa, dp);
#pragma unroll
      for (int dn = 0; dn < ND; dn += 2) {
        uint32_t bk[4];
        ldsm_x4_t(bk, Kt + (c * 16 + (lane & 15)) * LD + dn * 8 +
                          (lane >> 4) * 8);
#pragma unroll
        for (int p = PARTS - 1; p >= 0; --p) {
          mma_bf16(acc[dn], sa[p], bk[0], bk[1]);
          mma_bf16(acc[dn + 1], sa[p], bk[2], bk[3]);
        }
      }
    }
    __syncthreads();                  // tile kt is consumed
  }
  cp_async_wait<0>();

  bf16* dqb = dq + b * dqs.b + h * dqs.h;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + r0 + gq + 8 * half;
    if (row >= Sq) continue;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      const int d = j * 8 + 2 * tq;
      if (d < D)
        *reinterpret_cast<uint32_t*>(dqb + row * dqs.s + d) =
            pack_bf16(acc[j][2 * half], acc[j][2 * half + 1]);
    }
  }
}

// The dk/dv kernel of an instantiation: the query-split kernel where q and
// v share the padded head dim, the output-split kernel at (192, 128).
template <int DP, int DVP>
constexpr auto dkdv_kernel() {
  if constexpr (DP == DVP)
    return flash_bwd_dkdv_mma_kernel<DP>;
  else
    return flash_bwd_dkdv_split_kernel<DP, DVP>;
}

template <int DP, int DVP>
int launch_bf16(const void* q, const void* k, const void* v, const void* o,
                const void* dout, const float* lse, void* dq, void* dk,
                void* dv, float* delta, int B, int Hq, int Hkv, int Sq,
                int Sk, int D, int DV, int causal, float scale,
                const Strides* st, cudaStream_t stream) {
  const Strides &qs = st[0], &ks = st[1], &vs = st[2], &os = st[3],
                &gs = st[4], &dqs = st[5], &dks = st[6], &dvs = st[7];
  const bf16 *qt = static_cast<const bf16*>(q),
             *kt = static_cast<const bf16*>(k),
             *vt = static_cast<const bf16*>(v),
             *gt = static_cast<const bf16*>(dout);
  const int group = Hq / Hkv;
  cudaError_t err;
  if (Sq > 0) {
    const long long rows = static_cast<long long>(B) * Hq * Sq;
    const int per = DTHREADS / (DVP / 8);
    flash_bwd_delta_bf16_kernel<DVP>
        <<<static_cast<unsigned>((rows + per - 1) / per), DTHREADS, 0,
           stream>>>(static_cast<const bf16*>(o), gt, delta, rows, Hq, Sq, DV,
                     os, gs);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  if (Sk > 0) {          // with Sq = 0 it writes dk = dv = 0
    constexpr int bytes = dkdv_smem_bytes<DP, DVP>();
    constexpr auto kernel = dkdv_kernel<DP, DVP>();
    if ((err = opt_in_smem(kernel, bytes)) != cudaSuccess)
      return static_cast<int>(err);
    const dim3 grid(Hkv, B, (Sk + MKV - 1) / MKV);
    kernel<<<grid, MTHREADS, bytes, stream>>>(
        qt, kt, vt, gt, lse, delta, static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), group, Sq, Sk, D, DV, causal, scale, qs, ks,
        vs, gs, dks, dvs);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  if (Sq > 0) {          // with Sk = 0 it writes dq = 0
    constexpr int bytes = dq_smem_bytes<DP, DVP>();
    if ((err = opt_in_smem(flash_bwd_dq_mma_kernel<DP, DVP>, bytes)) !=
        cudaSuccess)
      return static_cast<int>(err);
    const dim3 grid(Hq, B, (Sq + MQ - 1) / MQ);
    flash_bwd_dq_mma_kernel<DP, DVP><<<grid, MTHREADS, bytes, stream>>>(
        qt, kt, vt, gt, lse, delta, static_cast<bf16*>(dq), group, Sq, Sk, D,
        DV, causal, scale, qs, ks, vs, gs, dqs);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// The instantiation a call runs under, as the forward's: the first (DP,
// DVP) of (64, 64), (128, 128) and (192, 128) with D <= DP and DV <= DVP,
// as 64, 128 or 192; 0 where none takes it.
int head_dims(int D, int DV) {
  if (D < 1 || DV < 1) return 0;
  if (D <= 64 && DV <= 64) return 64;
  if (D <= MAX_D && DV <= MAX_D) return 128;
  if (D <= MAX_DQK && DV <= MAX_D) return 192;
  return 0;
}

}  // namespace

// Whether the backward takes q·k's head dim D with v's head dim DV: 1 or 0
// (the forward's pairs, ``repro_flash_takes``).
extern "C" int repro_flash_bwd_takes(int D, int DV) {
  return head_dims(D, DV) != 0;
}

// q, dq: (B, Hq, Sq, D); o, dout: (B, Hq, Sq, DV); k, dk: (B, Hkv, Sk, D);
// v, dv: (B, Hkv, Sk, DV); each addressed as base + b*s_b + h*s_h + i*s_s
// + d (the head dim contiguous), with ``strides`` holding (s_b, s_h, s_s)
// of q, k, v, o, dout, dq, dk, dv in that order.  lse: the forward's fp32
// (B, Hq, Sq), contiguous; delta: fp32 (B, Hq, Sq) scratch the caller
// allocates.  dtype 0 is float32, 1 bfloat16; bf16 needs D % 8 == 0, DV %
// 8 == 0 and 16-byte-aligned bases and strides (the wrapper checks).  (D,
// DV) must be one ``repro_flash_bwd_takes`` takes.  Three launches on
// ``stream``; returns the first nonzero cudaGetLastError(), else 0.
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, void* dq, void* dk, void* dv,
    float* delta, int dtype, int B, int Hq, int Hkv, int Sq, int Sk, int D,
    int DV, int causal, float scale, const long long* strides,
    void* stream) {
  if (B == 0 || Hq == 0) return 0;
  const int dp = head_dims(D, DV);
  if (dp == 0 || Hkv < 1 || Hq % Hkv != 0 || Sq < 0 || Sk < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Strides st[8];
  for (int t = 0; t < 8; ++t)
    st[t] = Strides{strides[3 * t], strides[3 * t + 1], strides[3 * t + 2]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_BWD_ARGS                                                     \
  q, k, v, o, dout, lse, dq, dk, dv, delta, B, Hq, Hkv, Sq, Sk, D, DV,     \
      causal, scale, st, s
  if (dtype == 0)
    return dp == 64    ? launch<64, 64, float>(REPRO_BWD_ARGS)
           : dp == 128 ? launch<128, 128, float>(REPRO_BWD_ARGS)
                       : launch<192, 128, float>(REPRO_BWD_ARGS);
  if (dtype == 1) {
    if (D % 8 != 0 || DV % 8 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    return dp == 64    ? launch_bf16<64, 64>(REPRO_BWD_ARGS)
           : dp == 128 ? launch_bf16<128, 128>(REPRO_BWD_ARGS)
                       : launch_bf16<192, 128>(REPRO_BWD_ARGS);
  }
#undef REPRO_BWD_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}

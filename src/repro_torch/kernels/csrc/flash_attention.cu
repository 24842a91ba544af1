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
// Two kernels, one per type.  Both run one block per (b, h, 64-query tile),
// walk the key tiles this query tile can see (the loop ends at the tile
// holding the last query's last live key, so dead tiles above the diagonal
// cost nothing and rows with no live key keep l = 0), read q, k, v and o
// through their batch, head and sequence strides (the head dim contiguous),
// so the model's (B, S, H, D) activations pass as permuted views with no
// copy, and pad the head dims with zeros to their instantiation's, which
// leaves every product unchanged.  v's head dim DV may differ from q's and
// k's D: each kernel is instantiated at (DP, DVP) = (64, 64), (128, 128)
// and (192, 128), the last for MLA (deepseek-v3: q·k over nope 128 + rope
// 64 = 192, v of 128).  At (192, 128) q's fragments take 12 k16 steps and
// the bf16 kernel's shared memory is (64 + 2·64)·200·2 + 2·64·136·2 =
// 111,616 bytes (opted in past 48 KB); at 128 heads the grid has 128
// blocks per 64-query tile.
//
// bf16 (the served type): FlashAttention-2 on the tensor cores.
// - 4 warps, each owning 16 query rows; q·kᵀ and p·v run on
//   mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32 with fp32 accumulators.
//   q's A fragments are loaded once (ldmatrix) and stay in registers.
// - 64-key tiles of k and v stay bf16 in shared memory, double-buffered by
//   16-byte cp.async: the next tile's copy overlaps this tile's math.  They
//   are read with ldmatrix (.trans for v).  Shared rows are padded by 8
//   elements (16 bytes), so the 8 rows of each 8x8 ldmatrix land in 8
//   distinct 4-bank groups.  16-byte copies need 16-byte-aligned rows: the
//   wrapper checks base and strides and raises otherwise.
// - The row max and row sum stay in registers: each quad of lanes holds a
//   row's scores, reduced with two shuffles; the sum is reduced once at the
//   end.  P never leaves registers: the C fragment of s = q·kᵀ is the A
//   fragment of p·v.  P goes to the MMAs in three bf16 parts, each the
//   rounding of what the parts before leave of p (each remainder is exact
//   in fp32): p to ~2^-25, fp32-level, for 3x the p·v MMAs of
//   FlashAttention-2's one bf16 p.  qwen3-0.6b's bf16 prefill logits, held
//   within 2e-2 of max|logits| of the plain path's by chip_smoke.py, moved
//   2.073e-2 with one part, 1.989e-2 with two and 1.832e-2 with three
//   (H100; PERF.md).
// - Only tiles that cross the causal diagonal or the end of the keys are
//   masked; exp2 of scores pre-scaled by scale·log2(e).
// Both kernels can also write each row's log-sum-exp of the scaled scores,
// lse = m + log(l) in natural-log units (-inf for a row with no live key),
// as fp32 (B, Hq, Sq): the training path saves it for the backward
// (csrc/flash_attention_bwd.cu).  A null pointer writes nothing: the
// serving path passes null and its arithmetic is unchanged.
// fp32 (parity checks only; no served path): SIMT, as first written.
// Thread (ty, tx) of 256 owns query rows 4·ty..4·ty+3: their scores for
// keys tx and tx+16 of a 32-key tile, their running m and l, and their
// output columns tx + 16·c, so the rescale by alpha needs no exchange.  Row
// max and row sum reduce over the 16 lanes of a half-warp with shuffles; p
// goes through shared memory to the p·v product.  expf, not __expf, and a
// division by l, as in the Pallas kernel, so fp32 results match the plain
// version to rounding.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bf16_mma.cuh"

namespace {

// The head dims the kernel takes: q·k's D and v's DV up to MAX_D each, or D
// up to MAX_DQK with DV up to MAX_D (MLA's 128 + 64 with v's 128).
constexpr int MAX_D = 128, MAX_DQK = 192;

struct Strides {
  long long b, h, s;           // element strides; the head dim's is 1
};

// ---- fp32: SIMT ----------------------------------------------------------
constexpr int BQ = 64, BK = 32, TX = 16, TY = 16, THREADS = TX * TY;
constexpr int RM = BQ / TY;    // query rows per thread (4)
constexpr int CN = BK / TX;    // score columns per thread (2)

template <int DP, int DVP>
constexpr int smem_floats() {
  return BQ * (DP + 1) + BK * (DP + 1) + BK * DVP + BQ * (BK + 1);
}

template <int DP, int DVP>
__global__ void __launch_bounds__(THREADS)
flash_f32_simt_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o,
                      float* __restrict__ lse, int group, int Sq, int Sk,
                      int D, int DV, int causal, float scale, Strides qs,
                      Strides ks, Strides vs, Strides os) {
  extern __shared__ float smem[];
  float* Qs = smem;                       // [BQ][DP + 1]
  float* Ks = Qs + BQ * (DP + 1);         // [BK][DP + 1]
  float* Vs = Ks + BK * (DP + 1);         // [BK][DVP]
  float* Ps = Vs + BK * DVP;              // [BQ][BK + 1]
  constexpr int CD = DVP / TX;            // output columns per thread

  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  // the tiles near the diagonal's end hold the most live keys: start them
  // first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / group;
  const int offset = Sk - Sq;
  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + hk * ks.h;
  const float* vb = v + b * vs.b + hk * vs.h;

  for (int e = tid; e < BQ * DP; e += THREADS) {
    const int r = e / DP, d = e % DP, gq = q0 + r;
    Qs[r * (DP + 1) + d] = (gq < Sq && d < D) ? qb[gq * qs.s + d] : 0.f;
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
      Ks[r * (DP + 1) + d] = gk < Sk && d < D ? kb[gk * ks.s + d] : 0.f;
    }
    for (int e = tid; e < BK * DVP; e += THREADS) {
      const int r = e / DVP, d = e % DVP, gk = k0 + r;
      Vs[r * DVP + d] = gk < Sk && d < DV ? vb[gk * vs.s + d] : 0.f;
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
      for (int c = 0; c < CD; ++c) vv[c] = Vs[j * DVP + tx + TX * c];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int c = 0; c < CD; ++c) acc[i][c] = fmaf(p[i], vv[c], acc[i][c]);
    }
  }

  float* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int gq = q0 + ty * RM + i;
    if (gq >= Sq) continue;
    if (lse != nullptr && tx == 0)      // m = -inf (no live key): -inf
      lse[(static_cast<long long>(b) * gridDim.y + h) * Sq + gq] =
          m[i] + logf(fmaxf(l[i], 1e-30f));
    const float den = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int c = 0; c < CD; ++c) {
      const int d = tx + TX * c;
      if (d < DV) ob[gq * os.s + d] = acc[i][c] / den;
    }
  }
}

// ---- bf16: tensor cores ----------------------------------------------------
constexpr int MQ = 64, MK = 64, MWARPS = 4, MTHREADS = 32 * MWARPS;

template <int DP, int DVP>
constexpr int mma_smem_bytes() {
  // q, then 2 stages of k and 2 of v
  return ((MQ + 2 * MK) * (DP + 8) + 2 * MK * (DVP + 8)) * 2;
}

template <int DP, int DVP>
__global__ void __launch_bounds__(MTHREADS)
flash_bf16_mma_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      __nv_bfloat16* __restrict__ o,
                      float* __restrict__ lse, int group, int Sq, int Sk,
                      int D, int DV, int causal, float scale_log2,
                      Strides qs, Strides ks, Strides vs, Strides os) {
  constexpr int LD = DP + 8;          // q and k shared row stride, elements
  constexpr int LDV = DVP + 8;        // v's
  constexpr int CH = DP / 8;          // 16-byte chunks per q or k row
  constexpr int CHV = DVP / 8;        // per v row
  constexpr int KD = DP / 16;         // k16 steps over q·k's head dim
  constexpr int ND = DVP / 8;         // n8 tiles of v's head dim
  constexpr int NS = MK / 8;          // n8 tiles of a key tile
  static_assert(KD % 2 == 0 && ND % 2 == 0, "pairs of k16 and n8 steps");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + MQ * LD;             // [2][MK][LD]
  __nv_bfloat16* Vs = Ks + 2 * MK * LD;         // [2][MK][LDV]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;      // fragment row, column pair
  // the tiles near the diagonal's end hold the most live keys: start them
  // first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * MQ;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / group;
  const int offset = Sk - Sq;
  const __nv_bfloat16* qb = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* kb = k + b * ks.b + hk * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + hk * vs.h;

#pragma unroll
  for (int i = 0; i < MQ * CH / MTHREADS; ++i) {
    const int c = tid + i * MTHREADS, r = c / CH, d = (c % CH) * 8;
    const bool in = q0 + r < Sq && d < D;
    cp_async16(Qs + r * LD + d, in ? qb + (q0 + r) * qs.s + d : qb, in);
  }
  auto load_kv = [&](int kt, int stage) {
    __nv_bfloat16* kd = Ks + stage * MK * LD;
    __nv_bfloat16* vd = Vs + stage * MK * LDV;
#pragma unroll
    for (int i = 0; i < MK * CH / MTHREADS; ++i) {
      const int c = tid + i * MTHREADS, r = c / CH, d = (c % CH) * 8;
      const int key = kt * MK + r;
      const bool in = key < Sk && d < D;
      cp_async16(kd + r * LD + d, in ? kb + key * ks.s + d : kb, in);
    }
#pragma unroll
    for (int i = 0; i < MK * CHV / MTHREADS; ++i) {
      const int c = tid + i * MTHREADS, r = c / CHV, d = (c % CHV) * 8;
      const int key = kt * MK + r;
      const bool in = key < Sk && d < DV;
      cp_async16(vd + r * LDV + d, in ? vb + key * vs.s + d : vb, in);
    }
  };
  // keys [0, kend) can be live for some row of this tile
  int kend = Sk;
  if (causal) kend = min(Sk, min(q0 + MQ, Sq) + offset);
  const int nkt = kend > 0 ? (kend + MK - 1) / MK : 0;
  if (nkt > 0) load_kv(0, 0);
  cp_async_commit();

  const int r0 = warp * 16;                     // the warp's first row
  uint32_t qf[KD][4];
  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  // rows r0 + gq and r0 + gq + 8: running max (log2 units) and this
  // lane's share of the running sum
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const int qpos0 = q0 + r0 + gq + offset;      // row's last live key

  for (int kt = 0; kt < nkt; ++kt) {
    const int stage = kt & 1, k0 = kt * MK;
    if (kt + 1 < nkt) load_kv(kt + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();               // tile kt (and q) have landed
    __syncthreads();
    if (kt == 0) {
      // A fragments of q (16 x 16 per step): lane l addresses row l % 16,
      // columns 8 * (l / 16) of the step
#pragma unroll
      for (int kd = 0; kd < KD; ++kd)
        ldsm_x4(qf[kd], Qs + (r0 + (lane & 15)) * LD + kd * 16 +
                            (lane >> 4) * 8);
    }
    const __nv_bfloat16* Kt = Ks + stage * MK * LD;
    const __nv_bfloat16* Vt = Vs + stage * MK * LDV;

    // s = q kᵀ: B fragments of kᵀ are rows of k; one ldmatrix.x4 gives
    // (b0, b1) of two k16 steps for 8 keys
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; kd += 2) {
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        uint32_t bk[4];
        ldsm_x4(bk, Kt + (j * 8 + (lane & 7)) * LD + kd * 16 +
                        (lane >> 3) * 8);
        mma_bf16(s[j], qf[kd], bk[0], bk[1]);
        mma_bf16(s[j], qf[kd + 1], bk[2], bk[3]);
      }
    }

    // mask (only tiles that cross the diagonal or the end of the keys)
    const bool edge = k0 + MK > Sk || (causal && k0 + MK - 1 > q0 + offset);
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (edge) {
          const int key = k0 + j * 8 + 2 * tq + (e & 1);
          const int last = qpos0 + 8 * (e >> 1);
          if (key >= Sk || (causal && key > last)) x = -INFINITY;
        }
        s[j][e] = x;
      }

    // online softmax over the quad that holds each row
    float alpha[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < NS; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * half], s[j][2 * half + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[half], mx);
      // a row with no live key yet keeps m = -inf: subtract 0 instead
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      alpha[half] = exp2f(m[half] - m_use);
      m[half] = m_new;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 2 * half; e < 2 * half + 2; ++e) {
          s[j][e] = exp2f(s[j][e] - m_use);
          rs += s[j][e];
        }
      l[half] = l[half] * alpha[half] + rs;
    }
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }

    // o += p v: the C fragments of s for keys 16c..16c+15 are the A
    // fragment of p; B fragments of v by ldmatrix.trans, two d tiles each
#pragma unroll
    for (int c = 0; c < MK / 16; ++c) {
      // A fragment i of p holds rows g / g+8 at keys 16c + 2t(+1) (i = 0,
      // 1) and 16c + 8 + 2t(+1) (i = 2, 3): parts[k] is the k-th bf16 part
      uint32_t parts[3][4];
      a_parts(parts, *reinterpret_cast<const float(*)[2][4]>(s[2 * c]));
#pragma unroll
      for (int dn = 0; dn < ND; dn += 2) {
        uint32_t bv[4];
        ldsm_x4_t(bv, Vt + (c * 16 + (lane & 15)) * LDV + dn * 8 +
                          (lane >> 4) * 8);
#pragma unroll
        for (int k = 2; k >= 0; --k) {          // small parts first
          mma_bf16(acc[dn], parts[k], bv[0], bv[1]);
          mma_bf16(acc[dn + 1], parts[k], bv[2], bv[3]);
        }
      }
    }
    __syncthreads();                  // tile kt is consumed
  }
  cp_async_wait<0>();

  __nv_bfloat16* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float den = l[half];
    den += __shfl_xor_sync(0xffffffffu, den, 1);
    den += __shfl_xor_sync(0xffffffffu, den, 2);
    const int row = q0 + r0 + gq + 8 * half;
    if (row >= Sq) continue;
    if (lse != nullptr && tq == 0)      // m in log2 units; -inf stays -inf
      lse[(static_cast<long long>(b) * gridDim.y + h) * Sq + row] =
          m[half] * 0.6931471805599453f + logf(fmaxf(den, 1e-30f));
    if (den == 0.f) den = 1.f;          // no live key: acc is 0
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      const int d = j * 8 + 2 * tq;     // DV % 8 == 0: the pair is all in
      if (d < DV)
        *reinterpret_cast<uint32_t*>(ob + row * os.s + d) =
            pack_bf16(acc[j][2 * half] / den, acc[j][2 * half + 1] / den);
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

struct Call {
  const void *q, *k, *v;
  void* o;
  float* lse;
  int B, Hq, Hkv, Sq, Sk, D, DV, causal;
  float scale;
  Strides qs, ks, vs, os;
  cudaStream_t stream;
};

template <int DP, int DVP>
int launch_f32(const Call& c) {
  constexpr int bytes = smem_floats<DP, DVP>() * sizeof(float);
  const cudaError_t err = opt_in_smem(flash_f32_simt_kernel<DP, DVP>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((c.Sq + BQ - 1) / BQ, c.Hq, c.B);
  flash_f32_simt_kernel<DP, DVP><<<grid, THREADS, bytes, c.stream>>>(
      static_cast<const float*>(c.q), static_cast<const float*>(c.k),
      static_cast<const float*>(c.v), static_cast<float*>(c.o), c.lse,
      c.Hq / c.Hkv, c.Sq, c.Sk, c.D, c.DV, c.causal, c.scale, c.qs, c.ks,
      c.vs, c.os);
  return static_cast<int>(cudaGetLastError());
}

template <int DP, int DVP>
int launch_bf16(const Call& c) {
  constexpr int bytes = mma_smem_bytes<DP, DVP>();
  const cudaError_t err = opt_in_smem(flash_bf16_mma_kernel<DP, DVP>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((c.Sq + MQ - 1) / MQ, c.Hq, c.B);
  flash_bf16_mma_kernel<DP, DVP><<<grid, MTHREADS, bytes, c.stream>>>(
      static_cast<const __nv_bfloat16*>(c.q),
      static_cast<const __nv_bfloat16*>(c.k),
      static_cast<const __nv_bfloat16*>(c.v),
      static_cast<__nv_bfloat16*>(c.o), c.lse, c.Hq / c.Hkv, c.Sq, c.Sk, c.D,
      c.DV, c.causal, c.scale * 1.4426950408889634f, c.qs, c.ks, c.vs, c.os);
  return static_cast<int>(cudaGetLastError());
}

// The instantiation a call runs under: the first (DP, DVP) of (64, 64),
// (128, 128) and (192, 128) with D <= DP and DV <= DVP, as 64, 128 or 192;
// 0 where none takes it.
int head_dims(int D, int DV) {
  if (D < 1 || DV < 1) return 0;
  if (D <= 64 && DV <= 64) return 64;
  if (D <= MAX_D && DV <= MAX_D) return 128;
  if (D <= MAX_DQK && DV <= MAX_D) return 192;
  return 0;
}

}  // namespace

// Whether the kernel takes q·k's head dim D with v's head dim DV: 1 or 0.
extern "C" int repro_flash_takes(int D, int DV) {
  return head_dims(D, DV) != 0;
}

// q: (B, Hq, Sq, D), k: (B, Hkv, Sk, D), v: (B, Hkv, Sk, DV), o: (B, Hq,
// Sq, DV); each addressed as base + b*s_b + h*s_h + i*s_s + d (the head dim
// contiguous).  lse: null, or fp32 (B, Hq, Sq) contiguous for each row's
// log-sum-exp.  dtype 0 is float32, 1 bfloat16; bf16 needs D % 8 == 0,
// DV % 8 == 0 and 16-byte-aligned bases and strides (the wrapper checks).
// (D, DV) must be one ``repro_flash_takes`` takes.  Returns
// cudaGetLastError() after the launch.
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* o, float* lse,
    int dtype, int B, int Hq, int Hkv, int Sq, int Sk, int D, int DV,
    int causal, float scale,
    long long qsb, long long qsh, long long qss, long long ksb,
    long long ksh, long long kss, long long vsb, long long vsh,
    long long vss, long long osb, long long osh, long long oss,
    void* stream) {
  if (B == 0 || Hq == 0 || Sq == 0) return 0;
  const int dp = head_dims(D, DV);
  if (dp == 0 || Hkv < 1 || Hq % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Call c{q, k, v, o, lse, B, Hq, Hkv, Sq, Sk, D, DV, causal, scale,
               Strides{qsb, qsh, qss}, Strides{ksb, ksh, kss},
               Strides{vsb, vsh, vss}, Strides{osb, osh, oss},
               static_cast<cudaStream_t>(stream)};
  if (dtype == 0)
    return dp == 64    ? launch_f32<64, 64>(c)
           : dp == 128 ? launch_f32<128, 128>(c)
                       : launch_f32<192, 128>(c);
  if (dtype == 1) {
    if (D % 8 != 0 || DV % 8 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    return dp == 64    ? launch_bf16<64, 64>(c)
           : dp == 128 ? launch_bf16<128, 128>(c)
                       : launch_bf16<192, 128>(c);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// KNN graph construction: out[i, :] = the k candidates j with the smallest
// squared-L2 distance to point i, ascending, ties toward the lower j.
//
// Replaces the TPU kernel src/repro/kernels/knn.py (knn / _knn_kernel),
// which forms (bm, bn) distance tiles on the MXU in VMEM and merges each
// into a running (bm, k) best list by k min/knock-out sweeps, so the
// (N, N) distance matrix never reaches HBM.
//
// What bounds it on the H100: operations.  At b6-dyn's N = 1024, F = 3,
// k = 20 the dot products are 2·N²·F = 6.3 MFLOP and forming and comparing
// the distances another 3·N² = 3.1 MFLOP, about 0.14 us at the fp32 rate,
// against 16 KB of input and 80 KB of output.  What holds a kernel back
// is the serial selection, not the arithmetic: the kernel this one
// replaced gave each lane one row and walked the candidates through a
// k-step compare-select chain that the whole warp paid for whenever one of
// its 32 rows inserted, on 32 blocks for 1024 rows.
//
// Design: one warp per query row, ROWS rows a block (128 blocks at
// N = 1024, so every SM gets work).
// - The block stages the widest tile of candidates that fits (all 1024 of
//   b6-dyn's points in one stage), at most FC features a stage, through
//   two cp.async buffers (the next stage loads while this one is used),
//   beside its rows' features and the tile's mask; any F works (partial
//   dot products wait in shared memory between feature chunks).  With
//   F <= 3 a candidate is one float4, its squared norm in the fourth
//   slot.  Each norm is summed once per block; lane l forms the distance
//   of candidate j0 + l, GROUP chunks of 32 at a time on independent
//   chains.
// - The warp keeps the row's sorted list of k (distance, index) entries
//   across its lanes, entry p in lane p % 32 (a second register past 32).
//   An entry is one 64-bit key: the distance's bits mapped to an unsigned
//   order (±0 equal, NaN above +inf) over the index, so (d, j) order is
//   one integer compare.  The k-th entry is a warp-uniform threshold.
// - Each chunk: one ballot of "key below the threshold" picks the
//   survivors, merged at once (take: ballot ranks for a few, all pairs
//   through shared memory for many, a bitonic sort into an empty list).
//   A warm list costs one ballot per chunk, with no divergence.  No
//   cross-warp merge; the row's k indices are written coalesced.
// - Where one tile holds every candidate and k <= 32, a first pass caps
//   the threshold at the k-th smallest of the lanes' smallest keys.  In
//   index order the list would take about k·(1 + ln(N / k)) survivors (89
//   at b6-dyn), and N when the farthest candidates come first; under the
//   cap about 31 at b6-dyn, whatever the order: the pass costs one more
//   sweep of distances and saves most of the merging.
// Lexicographic (d, j) order is a total order, so the result does not
// depend on the order candidates are visited: ascending distance, ties
// toward the lower index, and, when too few candidates are selectable,
// trailing +inf candidates (self, masked) in index order — exactly what a
// stable sort of the distance row gives (kernels/ref.py knn_ref).
// Distances are formed as (|x_i|² − 2·x_i·x_j) + |x_j|², every sum over F
// in index order, with __fmul_rn / __fadd_rn / __fsub_rn so that nvcc never
// contracts them into FMAs: they equal the plain version's fp32
// arithmetic bit for bit (dist below, shared by both routes).
//
// The sort route, for k above WARP_K (the warp list holds at most 64
// entries; the reference takes any k <= N).  A first kernel sums each
// point's |x_j|² once; then one block per query row forms the row's N keys
// (the same entry() and dist()), pads them to a power of two with NONE, and
// sorts them ascending by a bitonic network, one compare-exchange per
// thread and pair, a __syncthreads() between passes; the first k keys'
// indices are the row.  The keys sit in shared memory up to SORT_SMEM_KEYS
// a row (N <= 16384), else in a global scratch of SORT_SCRATCH bytes at
// most, which the launcher walks in chunks of rows (never the whole N x N).
// It is bound by operations as the warp route is (the 2·N²·F of the dot
// products), plus the sort's N·log²N / 2 compare-exchanges a row; a full
// sort where only k keys are needed is the simple design, not a fast one.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <atomic>

#include "tf32x3.cuh"   // cp.async helpers

namespace {

constexpr int ROWS = 8;                 // query rows per block, one per warp
constexpr int THREADS = ROWS * 32;
constexpr int FC = 32;                  // features per stage, at most
constexpr int SMALL_F = 3;              // up to here a candidate is one float4
constexpr int TJ_MAX = 1024;            // candidates per staged tile, at most
constexpr int WARP_K = 64;              // the warp list's largest k
constexpr int GROUP = 4;                // chunks whose keys form together
constexpr int ALL_PAIRS = 8;            // survivors from which a merge
                                        // compares all pairs
constexpr int WARP_KEYS = 96;           // a warp's merge buffer
constexpr int SMEM = 48 * 1024;         // dynamic shared memory, at most
constexpr unsigned FULL = 0xffffffffu;
using Key = unsigned long long;
constexpr Key NONE = ~0ull;             // an empty slot, above every entry

// (d, j) as one integer in lexicographic order: the distance's bits mapped
// so that unsigned order is float order (-0 as +0, NaN above +inf, where
// a stable sort puts it), then the index.
__device__ __forceinline__ Key entry(float d, int j) {
  uint32_t u = __float_as_uint(d == 0.f ? 0.f : d);
  u = d != d ? 0xffffffffu : (u & 0x80000000u) ? ~u : u | 0x80000000u;
  return static_cast<Key>(u) << 32 | static_cast<uint32_t>(j);
}

// The squared distance from |x_i|², x_i·x_j and |x_j|², in the plain
// version's order: (|x_i|² − 2·x_i·x_j) + |x_j|².
__device__ __forceinline__ float dist(float sqi, float dot, float sqj) {
  return __fadd_rn(__fsub_rn(sqi, __fmul_rn(2.f, dot)), sqj);
}

// One key per lane, sorted ascending across the warp (bitonic network).
__device__ __forceinline__ Key sort32(Key v, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1)
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const Key o = __shfl_xor_sync(FULL, v, stride);
      const bool keep_min = ((lane & stride) == 0) == ((lane & size) == 0);
      v = keep_min == (o < v) ? o : v;
    }
  return v;
}

// Take one 32-candidate chunk (this lane's key c) into the row's sorted
// list of k entries: lo = entry lane, hi = entry 32 + lane (TWO, k > 32
// only), empty slots NONE, thr = entry k - 1.  The survivors (keys below
// thr) merge at once: a survivor's new place is the count of entries and
// survivors below it, an entry's its place plus the survivors below it;
// the first k places go through the warp's buffer ws (WARP_KEYS).  A few
// survivors are placed one at a time, each by ballots; from ALL_PAIRS on,
// every lane compares its entries and survivor with all 32 lanes' keys at
// a fixed cost, read two at a time by broadcast loads (shuffles of 64-bit
// keys are the scarcer issue slot).  Into an empty list the chunk's
// survivors go sorted.  The threshold never exceeds cap.
template <bool TWO>
__device__ __forceinline__ void take(Key& lo, Key& hi, Key& thr, bool& empty,
                                     Key cap, Key c, int lane, int k,
                                     Key* ws) {
  const unsigned todo = __ballot_sync(FULL, c < thr);
  if (!todo) return;
  const Key cm = todo >> lane & 1 ? c : NONE;
  if (empty) {
    const Key v = sort32(cm, lane);
    lo = lane < k ? v : NONE;
    thr = min(cap, k <= 32 ? __shfl_sync(FULL, lo, (k - 1) & 31) : NONE);
    empty = false;
    return;
  }
  int up_lo = 0, up_hi = 0;
  __syncwarp();                 // the last take's reads are done
  if (__popc(todo) >= ALL_PAIRS) {
    ws[lane] = cm;              // [32] survivors, NONE in other lanes
    ws[32 + lane] = lo;         // [32] entries 0..31
    if (TWO) ws[64 + lane] = hi;  // [32] entries 32..63
    __syncwarp();
    int at = 0;
#pragma unroll
    for (int q = 0; q < 32; q += 2) {
      const ulonglong2 cs = *reinterpret_cast<const ulonglong2*>(ws + q);
      const ulonglong2 ls = *reinterpret_cast<const ulonglong2*>(ws + 32 + q);
      up_lo += (cs.x < lo) + (cs.y < lo);
      at += (cs.x < cm) + (cs.y < cm) + (ls.x < cm) + (ls.y < cm);
      if (TWO) {
        const ulonglong2 hs =
            *reinterpret_cast<const ulonglong2*>(ws + 64 + q);
        up_hi += (cs.x < hi) + (cs.y < hi);
        at += (hs.x < cm) + (hs.y < cm);
      }
    }
    __syncwarp();               // the keys are read; ws takes the places
    if (cm != NONE && at < k) ws[at] = cm;
  } else {
    for (unsigned m = todo; m; m &= m - 1) {
      const int src = __ffs(m) - 1;
      const Key cs = __shfl_sync(FULL, c, src);
      const bool lo_below = lo < cs, hi_below = TWO && hi < cs;
      up_lo += !lo_below;
      int at = __popc(__ballot_sync(FULL, lo_below)) +
               __popc(__ballot_sync(FULL, cm < cs));
      if (TWO) {
        up_hi += !hi_below;
        at += __popc(__ballot_sync(FULL, hi_below));
      }
      if (lane == src && at < k) ws[at] = cs;
    }
  }
  if (lane + up_lo < k) ws[lane + up_lo] = lo;
  if (TWO && lane + 32 + up_hi < k) ws[lane + 32 + up_hi] = hi;
  __syncwarp();
  lo = lane < k ? ws[lane] : NONE;
  if (TWO) hi = lane + 32 < k ? ws[lane + 32] : NONE;
  thr = min(cap, ws[k - 1]);
}

// SMALL (F <= SMALL_F): a staged candidate is one float4, its features
// zero-padded and its squared norm last.
template <bool TWO, bool SMALL>
__global__ void __launch_bounds__(THREADS)
knn_kernel(const float* __restrict__ x, const float* __restrict__ mask,
           int* __restrict__ out, int N, int F, int k, int self_loops,
           int fc, int tj) {
  extern __shared__ __align__(16) unsigned char raw[];
  // a staged row: SMALL 4 floats, else fc | 1 (odd: 32 lanes on 32 rows
  // hit 32 banks)
  const int ld = SMALL ? 4 : fc | 1;
  const int n_f = (F + fc - 1) / fc;
  Key* const bufs = reinterpret_cast<Key*>(raw);      // [ROWS][WARP_KEYS]
  float* const xs = reinterpret_cast<float*>(bufs + ROWS * WARP_KEYS);
  float* const qs = xs + 2 * tj * ld;          // xs: [2][tj][ld]
  float* const ms = qs + 2 * ROWS * fc;        // qs: [2][ROWS][fc]
  float* const sqs = ms + 2 * tj;              // ms: [2][tj] (by tile);
                                               // sqs: [tj], not SMALL
  float* const dots = sqs + tj;                // [ROWS][tj], n_f > 1 only

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.x * ROWS, i = row0 + warp;
  const bool live = i < N;
  const int stages = (N + tj - 1) / tj * n_f;

  // stage s: feature chunk s % n_f of candidate tile s / n_f, the block's
  // rows at those features, and with a tile's first chunk its mask
  auto load = [&](int s) {
    const int tile = s / n_f, j0 = tile * tj, f0 = s % n_f * fc;
    const int nf = min(fc, F - f0);
    float* xd = xs + (s & 1) * tj * ld;
    float* qd = qs + (s & 1) * ROWS * fc;
    if (SMALL) {
      for (int r = tid; r < tj; r += THREADS) {
        const int j = j0 + r;
#pragma unroll
        for (int c = 0; c < SMALL_F; ++c) {
          const bool ok = j < N && c < F;
          cp_async4(xd + r * 4 + c, ok ? x + (size_t)j * F + c : x, ok);
        }
      }
    } else {
      for (int e = tid; e < tj * nf; e += THREADS) {
        const int r = e / nf, c = e % nf, j = j0 + r;
        cp_async4(xd + r * ld + c, j < N ? x + (size_t)j * F + f0 + c : x,
                  j < N);
      }
    }
    for (int e = tid; e < ROWS * nf; e += THREADS) {
      const int r = e / nf, c = e % nf, q = row0 + r;
      cp_async4(qd + r * fc + c, q < N ? x + (size_t)q * F + f0 + c : x,
                q < N);
    }
    if (mask != nullptr && f0 == 0)
      for (int e = tid; e < tj; e += THREADS) {
        const int j = j0 + e;
        cp_async4(ms + (tile & 1) * tj + e, j < N ? mask + j : mask, j < N);
      }
    cp_async_commit();
  };
  load(0);

  float sqi = 0.f;              // |x_i|², over F in order
  Key lo = NONE, hi = NONE, thr = NONE, cap = NONE;
  bool empty = true;
  Key* const ws = bufs + warp * WARP_KEYS;
  float* const dw = dots + warp * tj;

  for (int s = 0; s < stages; ++s) {
    cp_async_wait<0>();         // stage s has landed (this thread's part)
    __syncthreads();            // ... everyone's; stage s - 1 is consumed
    if (s + 1 < stages) load(s + 1);
    const int tile = s / n_f, chunk = s % n_f, j0 = tile * tj;
    const int nf = min(fc, F - chunk * fc);
    const int nj = min(tj, N - j0);
    float* const xt = xs + (s & 1) * tj * ld;
    const float* qt = qs + (s & 1) * ROWS * fc + warp * fc;
    if (s < n_f)                // the first tile's chunks: |x_i|²
      for (int f = 0; f < nf; ++f)
        sqi = __fadd_rn(sqi, __fmul_rn(qt[f], qt[f]));
    // |x_j|² of the tile's candidates, each summed by one thread
    for (int t = tid; t < nj; t += THREADS) {
      float acc = chunk == 0 ? 0.f : sqs[t];
      for (int f = 0; f < nf; ++f)
        acc = __fadd_rn(acc, __fmul_rn(xt[t * ld + f], xt[t * ld + f]));
      (SMALL ? xt[t * 4 + 3] : sqs[t]) = acc;
    }
    if (chunk != n_f - 1) {     // a partial dot product for each candidate
      if (live)
        for (int t = lane; t < nj; t += 32) {
          float acc = chunk == 0 ? 0.f : dw[t];
          for (int f = 0; f < nf; ++f)
            acc = __fadd_rn(acc, __fmul_rn(qt[f], xt[t * ld + f]));
          dw[t] = acc;
        }
      continue;
    }
    __syncthreads();            // the tile's norms are complete
    if (!live) continue;
    const float* mt = ms + (tile & 1) * tj;
    float q[SMALL_F];
#pragma unroll
    for (int f = 0; f < SMALL_F; ++f) q[f] = SMALL && f < F ? qt[f] : 0.f;
    // the keys of chunks t0 / 32 .. + GROUP - 1, one per lane each
    // (independent chains); NONE past the tile
    auto keys = [&](int t0, Key (&c)[GROUP]) {
      float acc[GROUP], sq[GROUP];
#pragma unroll
      for (int g = 0; g < GROUP; ++g) {
        const int t = min(t0 + 32 * g + lane, nj - 1);
        if (SMALL) {            // in feature order, as the plain version
          const float4 v = reinterpret_cast<const float4*>(xt)[t];
          acc[g] = __fadd_rn(__fadd_rn(__fadd_rn(0.f, __fmul_rn(q[0], v.x)),
                                       __fmul_rn(q[1], v.y)),
                             __fmul_rn(q[2], v.z));
          sq[g] = v.w;
        } else {
          acc[g] = chunk == 0 ? 0.f : dw[t];
          sq[g] = sqs[t];
        }
      }
      if (!SMALL)
        for (int f = 0; f < nf; ++f) {
          const float qf = qt[f];
#pragma unroll
          for (int g = 0; g < GROUP; ++g) {
            const int t = min(t0 + 32 * g + lane, nj - 1);
            acc[g] = __fadd_rn(acc[g], __fmul_rn(qf, xt[t * ld + f]));
          }
        }
#pragma unroll
      for (int g = 0; g < GROUP; ++g) {
        const int t = t0 + 32 * g + lane, j = j0 + t;
        c[g] = NONE;
        if (t < nj) {
          const float d = dist(sqi, acc[g], sq[g]);
          const bool ok =
              (mask == nullptr || mt[t] > 0.f) && (self_loops || j != i);
          c[g] = entry(ok ? d : CUDART_INF_F, j);
        }
      }
    };
    // One tile holds every candidate and k <= 32: a first pass bounds
    // the row's k-th key by the k-th smallest of the lanes' smallest keys
    // (k real candidates' keys), so that the list fills from about 31
    // survivors at b6-dyn's N = 1024, k = 20, whatever the order.
    if (stages == 1 && k <= 32) {
      Key least = NONE;
#pragma unroll 1
      for (int t0 = 0; t0 < nj; t0 += 32 * GROUP) {
        Key c[GROUP];
        keys(t0, c);
#pragma unroll
        for (int g = 0; g < GROUP; ++g) least = min(least, c[g]);
      }
      const Key kth = __shfl_sync(FULL, sort32(least, lane), k - 1);
      cap = thr = kth == NONE ? NONE : kth + 1;
    }
    // GROUP chunks at a time; a group with no key below the threshold
    // costs its ballots only
#pragma unroll 1
    for (int t0 = 0; t0 < nj; t0 += 32 * GROUP) {
      Key c[GROUP];
      keys(t0, c);
      unsigned any = 0;
#pragma unroll
      for (int g = 0; g < GROUP; ++g) any |= __ballot_sync(FULL, c[g] < thr);
      if (!any) continue;
#pragma unroll
      for (int g = 0; g < GROUP; ++g)
        take<TWO>(lo, hi, thr, empty, cap, c[g], lane, k, ws);
    }
  }
  if (live) {
    int* row = out + (size_t)i * k;
    if (lane < k) row[lane] = static_cast<int>(static_cast<uint32_t>(lo));
    if (TWO && lane + 32 < k)
      row[lane + 32] = static_cast<int>(static_cast<uint32_t>(hi));
  }
}

template <bool TWO, bool SMALL>
void launch(const float* x, const float* mask, int* out, int N, int F,
            int k, int self_loops, int fc, int tj, size_t bytes,
            cudaStream_t stream) {
  knn_kernel<TWO, SMALL><<<(N + ROWS - 1) / ROWS, THREADS, bytes, stream>>>(
      x, mask, out, N, F, k, self_loops, fc, tj);
}

// ---- the sort route (k > WARP_K) ------------------------------------------
constexpr int SORT_THREADS = 512;
constexpr int NORM_THREADS = 256;
constexpr int SORT_SMEM_KEYS = 16384;           // 128 KiB of keys a block
constexpr size_t SORT_SCRATCH = size_t{256} << 20;  // global keys, at most

// sq[j] = |x_j|², summed over F in order.
__global__ void __launch_bounds__(NORM_THREADS)
knn_norms_kernel(const float* __restrict__ x, float* __restrict__ sq, int N,
                 int F) {
  const int j = blockIdx.x * NORM_THREADS + threadIdx.x;
  if (j >= N) return;
  const float* p = x + (size_t)j * F;
  float acc = 0.f;
  for (int f = 0; f < F; ++f) acc = __fadd_rn(acc, __fmul_rn(p[f], p[f]));
  sq[j] = acc;
}

// Row row0 + blockIdx.x: its npad keys (NONE past N) in shared memory
// (SHARED) or in its slice of the global scratch, sorted ascending, the
// first k indices written.
template <bool SHARED>
__global__ void __launch_bounds__(SORT_THREADS)
knn_sort_kernel(const float* __restrict__ x, const float* __restrict__ mask,
                const float* __restrict__ sq, int* __restrict__ out,
                Key* scratch, int N, int F, int k, int self_loops, int row0,
                int npad) {
  extern __shared__ __align__(16) unsigned char raw[];
  const int i = row0 + blockIdx.x;
  Key* const keys = SHARED ? reinterpret_cast<Key*>(raw)
                           : scratch + (size_t)blockIdx.x * npad;
  const float* xi = x + (size_t)i * F;
  const float sqi = sq[i];
  for (int j = threadIdx.x; j < npad; j += SORT_THREADS) {
    Key key = NONE;
    if (j < N) {
      const float* xj = x + (size_t)j * F;
      float acc = 0.f;
      for (int f = 0; f < F; ++f)
        acc = __fadd_rn(acc, __fmul_rn(xi[f], xj[f]));
      const bool ok =
          (mask == nullptr || mask[j] > 0.f) && (self_loops || j != i);
      key = entry(ok ? dist(sqi, acc, sq[j]) : CUDART_INF_F, j);
    }
    keys[j] = key;
  }
  __syncthreads();
  // bitonic network: pass (size, stride) pairs lo with lo + stride, in
  // ascending order where lo & size is 0 (the last merge: everywhere)
  for (int size = 2; size <= npad; size <<= 1)
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < npad / 2; t += SORT_THREADS) {
        const int lo = 2 * t - (t & (stride - 1)), hi = lo + stride;
        const Key a = keys[lo], b = keys[hi];
        if ((a > b) == ((lo & size) == 0)) {
          keys[lo] = b;
          keys[hi] = a;
        }
      }
      __syncthreads();
    }
  for (int p = threadIdx.x; p < k; p += SORT_THREADS)
    out[(size_t)i * k + p] = static_cast<int>(static_cast<uint32_t>(keys[p]));
}

// The sort route's padded row and, where its keys leave shared memory,
// the rows of one chunk; the scratch's bytes (norms, then keys).
struct SortPlan {
  int npad, chunk;
  size_t norm_bytes, bytes;
};

SortPlan sort_plan(int N) {
  SortPlan p{1, N, 0, 0};
  while (p.npad < N) p.npad <<= 1;
  p.norm_bytes = (static_cast<size_t>(N) * sizeof(float) + 255) / 256 * 256;
  p.bytes = p.norm_bytes;
  if (p.npad > SORT_SMEM_KEYS) {
    const size_t row = static_cast<size_t>(p.npad) * sizeof(Key);
    const size_t rows = SORT_SCRATCH / row;
    p.chunk = rows < 1 ? 1 : rows < static_cast<size_t>(N) ? (int)rows : N;
    p.bytes += row * p.chunk;
  }
  return p;
}

cudaError_t launch_sort(const float* x, const float* mask, int* out,
                        void* scratch, int N, int F, int k, int self_loops,
                        cudaStream_t stream) {
  const SortPlan p = sort_plan(N);
  float* sq = static_cast<float*>(scratch);
  knn_norms_kernel<<<(N + NORM_THREADS - 1) / NORM_THREADS, NORM_THREADS, 0,
                     stream>>>(x, sq, N, F);
  if (p.npad <= SORT_SMEM_KEYS) {
    // above 48 KB needs an opt-in, once per device (one bit each)
    static std::atomic<unsigned long long> opted{0};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
    if (!(opted.load() & bit)) {
      err = cudaFuncSetAttribute(knn_sort_kernel<true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 SORT_SMEM_KEYS * (int)sizeof(Key));
      if (err != cudaSuccess) return err;
      opted.fetch_or(bit);
    }
    knn_sort_kernel<true><<<N, SORT_THREADS, p.npad * sizeof(Key), stream>>>(
        x, mask, sq, out, nullptr, N, F, k, self_loops, 0, p.npad);
    return cudaGetLastError();
  }
  Key* keys = reinterpret_cast<Key*>(static_cast<char*>(scratch) +
                                     p.norm_bytes);
  for (int row0 = 0; row0 < N; row0 += p.chunk) {
    const int rows = N - row0 < p.chunk ? N - row0 : p.chunk;
    knn_sort_kernel<false><<<rows, SORT_THREADS, 0, stream>>>(
        x, mask, sq, out, keys, N, F, k, self_loops, row0, p.npad);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// x: (N, F) float32; mask: (N,) float32 or null (every candidate
// selectable); out: (N, k) int32; scratch: repro_knn_scratch_bytes(N, k)
// bytes of device memory (none for k <= WARP_K).  Returns
// cudaErrorInvalidValue for a k outside [1, N], else cudaGetLastError()
// after the launches.
extern "C" int repro_knn(const float* x, const float* mask, int* out,
                         void* scratch, int N, int F, int k, int self_loops,
                         void* stream) {
  if (k < 1 || k > N || F < 1 || (k > WARP_K && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (k > WARP_K)
    return static_cast<int>(
        launch_sort(x, mask, out, scratch, N, F, k, self_loops, s));
  // the widest tile of 32-candidate chunks that fits SMEM: two stages of
  // features and masks, the norms and, with F in chunks, the partial dots
  const bool small = F <= SMALL_F;
  const int fc = F < FC ? F : FC, n_f = (F + fc - 1) / fc;
  const int ld = small ? 4 : fc | 1;
  const int fixed = 8 * ROWS * WARP_KEYS + 4 * 2 * ROWS * fc;
  const int per = 4 * (2 * ld + 2 + (small ? 0 : 1) + (n_f > 1 ? ROWS : 0));
  int tj = (SMEM - fixed) / per / 32 * 32;
  tj = tj < TJ_MAX ? tj : TJ_MAX;
  tj = tj < (N + 31) / 32 * 32 ? tj : (N + 31) / 32 * 32;
  const size_t bytes = fixed + static_cast<size_t>(tj) * per;
  if (k <= 32) {
    (small ? launch<false, true> : launch<false, false>)(
        x, mask, out, N, F, k, self_loops, fc, tj, bytes, s);
  } else {
    (small ? launch<true, true> : launch<true, false>)(
        x, mask, out, N, F, k, self_loops, fc, tj, bytes, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// The scratch repro_knn needs for N points and k neighbours, in bytes.
extern "C" long long repro_knn_scratch_bytes(int N, int k) {
  if (N < 1 || k <= WARP_K) return 0;
  return static_cast<long long>(sort_plan(N).bytes);
}

// The largest k of the warp-list route; the sort route takes every k above.
extern "C" int repro_knn_warp_k() { return WARP_K; }

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
// against 16 KB of input and 80 KB of output.  The kernel is far from
// that bound: four threads share a row, each walking a quarter of its
// candidates serially, and 1024 rows fill only 32 of the 132 SMs.
//
// Design (simple and exact, not fast yet).  A block takes 32 query rows,
// one per lane, and SPLIT warps; warp w visits every SPLIT-th tile of 32
// candidates, staged in its own shared memory F_CHUNK features at a time,
// so any F works.  Each thread keeps a sorted list of (distance, index)
// pairs in registers (KT >= k slots, KT a template constant so the list
// is never indexed at run time), initialised to (+inf, INT_MAX), and
// inserts a candidate when (d, j) is lexicographically below the list's
// k-th entry.  At the end warp 0 merges the other warps' lists into its
// own.  Lexicographic order on (d, j) is a total order, so the result does
// not depend on the order candidates are visited or merged: ascending
// distance, ties toward the lower index, and, when too few candidates are
// selectable, trailing +inf candidates (self, masked) in index order —
// exactly what a stable sort of the distance row gives (kernels/ref.py
// knn_ref).  Distances are formed as (|x_i|² − 2·x_i·x_j) + |x_j|², every
// sum over F in index order, with __fmul_rn / __fadd_rn / __fsub_rn so
// that nvcc never contracts them into FMAs: they equal the plain version's
// fp32 arithmetic bit for bit.  Points are assumed finite (a NaN distance
// is never selected).
#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>

namespace {

constexpr int ROWS = 32;      // query rows per block, one per lane
constexpr int SPLIT = 4;      // warps per block, splitting the candidates
constexpr int TILE = 32;      // candidates per staged tile
constexpr int F_CHUNK = 16;   // features staged per step
constexpr int K_MAX = 64;     // the largest k (and list length)

struct WarpStage {
  float xi[ROWS][F_CHUNK + 1];
  float xj[TILE][F_CHUNK + 1];
  float dist[TILE][ROWS];
  float sqj[TILE];
  int okj[TILE];
};

union Shared {
  WarpStage stage[SPLIT];
  struct {
    float d[K_MAX][ROWS];
    int i[K_MAX][ROWS];
  } merge;
};

__device__ __forceinline__ float sq_norm(const float* __restrict__ row,
                                         int F) {
  float s = 0.f;
  for (int f = 0; f < F; ++f) s = __fadd_rn(s, __fmul_rn(row[f], row[f]));
  return s;
}

// (d, j) < (bd, bi) lexicographically.
__device__ __forceinline__ bool before(float d, int j, float bd, int bi) {
  return d < bd || (d == bd && j < bi);
}

// Insert (dc, jc) into the sorted list (d, i) if it is below the list's
// k-th entry (td, ti), which is then updated.  "Below entry l" is false up
// to the insertion point and true after it, so every slot from there on
// takes its predecessor, in one pass from the end.  Every index is a
// compile-time constant once the loops unroll: the list stays in
// registers.
template <int KT>
__device__ __forceinline__ bool push(float (&d)[KT], int (&i)[KT], float& td,
                                     int& ti, float dc, int jc, int k) {
  if (!before(dc, jc, td, ti)) return false;
  bool below = before(dc, jc, d[KT - 1], i[KT - 1]);
#pragma unroll
  for (int l = KT - 1; l > 0; --l) {
    const bool below_prev = before(dc, jc, d[l - 1], i[l - 1]);
    if (below) {
      d[l] = below_prev ? d[l - 1] : dc;
      i[l] = below_prev ? i[l - 1] : jc;
    }
    below = below_prev;
  }
  if (below) {
    d[0] = dc;
    i[0] = jc;
  }
#pragma unroll
  for (int l = 0; l < KT; ++l) {
    if (l == k - 1) {
      td = d[l];
      ti = i[l];
    }
  }
  return true;
}

template <int KT>
__global__ void __launch_bounds__(ROWS * SPLIT)
knn_kernel(const float* __restrict__ x, const float* __restrict__ mask,
           int* __restrict__ out, int N, int F, int k, int self_loops) {
  __shared__ Shared sh;
  const int lane = threadIdx.x % 32;
  const int w = threadIdx.x / 32;
  WarpStage& st = sh.stage[w];
  const int row0 = blockIdx.x * ROWS;
  const int i = row0 + lane;
  const bool live = i < N;
  const float sqi = live ? sq_norm(x + (size_t)i * F, F) : 0.f;
  // this row's list: the k smallest (distance, index) pairs seen so far
  float bd[KT];
  int bi[KT];
#pragma unroll
  for (int l = 0; l < KT; ++l) {
    bd[l] = CUDART_INF_F;
    bi[l] = INT_MAX;
  }
  float td = CUDART_INF_F;   // the k-th entry: the bar to get below
  int ti = INT_MAX;

  for (int j0 = w * TILE; j0 < N; j0 += SPLIT * TILE) {
    const int nj = min(TILE, N - j0);
    __syncwarp();                     // the last tile's reads are done
    if (lane < nj) {
      const int j = j0 + lane;
      st.sqj[lane] = sq_norm(x + (size_t)j * F, F);
      st.okj[lane] = mask == nullptr || mask[j] > 0.f;
    }
    float dot[TILE];
#pragma unroll
    for (int jj = 0; jj < TILE; ++jj) dot[jj] = 0.f;
    for (int f0 = 0; f0 < F; f0 += F_CHUNK) {
      const int nf = min(F_CHUNK, F - f0);
      __syncwarp();
      for (int e = lane; e < ROWS * nf; e += 32) {
        const int r = e / nf, c = e % nf;
        if (row0 + r < N) st.xi[r][c] = x[(size_t)(row0 + r) * F + f0 + c];
        if (r < nj) st.xj[r][c] = x[(size_t)(j0 + r) * F + f0 + c];
      }
      __syncwarp();
      if (live) {
        for (int c = 0; c < nf; ++c) {
          const float a = st.xi[lane][c];
#pragma unroll
          for (int jj = 0; jj < TILE; ++jj)
            dot[jj] = __fadd_rn(dot[jj], __fmul_rn(a, st.xj[jj][c]));
        }
      }
    }
#pragma unroll
    for (int jj = 0; jj < TILE; ++jj)
      st.dist[jj][lane] =
          __fadd_rn(__fsub_rn(sqi, __fmul_rn(2.f, dot[jj])), st.sqj[jj]);
    __syncwarp();
    if (!live) continue;
    for (int jj = 0; jj < nj; ++jj) {
      const int j = j0 + jj;
      const bool ok = st.okj[jj] && (self_loops || j != i);
      push(bd, bi, td, ti, ok ? st.dist[jj][lane] : CUDART_INF_F, j, k);
    }
  }

  // warp 0 takes in the other warps' lists, one warp at a time
  for (int s = 1; s < SPLIT; ++s) {
    __syncthreads();
    if (w == s) {
#pragma unroll
      for (int l = 0; l < KT; ++l) {
        if (l < k) {
          sh.merge.d[l][lane] = bd[l];
          sh.merge.i[l][lane] = bi[l];
        }
      }
    }
    __syncthreads();
    if (w == 0 && live) {
      for (int l = 0; l < k; ++l)     // sorted: stop at the first miss
        if (!push(bd, bi, td, ti, sh.merge.d[l][lane], sh.merge.i[l][lane],
                  k))
          break;
    }
  }
  if (w == 0 && live) {
#pragma unroll
    for (int l = 0; l < KT; ++l)
      if (l < k) out[(size_t)i * k + l] = bi[l];
  }
}

template <int KT>
void launch(const float* x, const float* mask, int* out, int N, int F,
            int k, int self_loops, cudaStream_t stream) {
  const dim3 grid((N + ROWS - 1) / ROWS);
  knn_kernel<KT><<<grid, ROWS * SPLIT, 0, stream>>>(x, mask, out, N, F, k,
                                                    self_loops);
}

}  // namespace

// x: (N, F) float32; mask: (N,) float32 or null (every candidate
// selectable); out: (N, k) int32.  Returns cudaErrorInvalidValue for a k
// outside [1, min(N, K_MAX)], else cudaGetLastError() after the launch.
extern "C" int repro_knn(const float* x, const float* mask, int* out, int N,
                         int F, int k, int self_loops, void* stream) {
  if (k < 1 || k > K_MAX || k > N || F < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (k <= 8)
    launch<8>(x, mask, out, N, F, k, self_loops, s);
  else if (k <= 16)
    launch<16>(x, mask, out, N, F, k, self_loops, s);
  else if (k <= 32)
    launch<32>(x, mask, out, N, F, k, self_loops, s);
  else
    launch<64>(x, mask, out, N, F, k, self_loops, s);
  return static_cast<int>(cudaGetLastError());
}

// The largest k the kernel takes.
extern "C" int repro_knn_max_k() { return K_MAX; }

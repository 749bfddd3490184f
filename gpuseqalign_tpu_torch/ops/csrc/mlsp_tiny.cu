// mlsp_tiny.cu — cost-only fill of many small pairs, NW/SW x linear/affine.
//
// Replaces the TPU kernel gpuseqalign_tpu/ops/pallas_tiny.py::
// pallas_mlsp_tiny_v2 (kernel body _make_tiny_kernel). It computes what
// that kernel computes for its caller — each pair's align cost and, for
// SW, its best cell — but not the TPU's layout (pairs as sublane
// sub-blocks of one (16, 128) register block, K interleaved chains, dummy
// pairs to fill them): one thread block per pair and one launch per
// bucket, so a bucket of any row count and any width runs as it is.
//
//   * The pair is one tile of its own live cells, (adjr-1) x (adjc-1):
//     neither output depends on the bucket's padded rows and columns, so
//     a block stops at its pair's corner. Thread t owns rows t, t+nt, ...
//     (groups of blockDim rows) and the block sweeps each group's
//     anti-diagonals. H (and F) pass down one row per step with
//     __shfl_up_sync inside a warp and through a double-buffered
//     shared-memory slot across warps. The bucket's
//     padded shape sets only the strides and the carried row's size.
//   * No header is loaded or stored: the top row of the first group and
//     the left column are the analytic edge (H[i,0], H[0,j]; F and E
//     -inf). Between groups the last row of a group is carried in shared
//     memory when it fits beside the rest, else in a per-pair global
//     scratch row.
//   * Outputs: cost[pair] (NW: H[adjr-1, adjc-1]; SW: the best value) and,
//     for SW, best[pair] = (v, i, j), the row-major first maximum over
//     the live cells; (0, 0, 0) if no cell is > 0. The
//     caller decides pairs with adjr < 2 or adjc < 2 itself: their NW
//     cost lies on the edge and is not written. All arithmetic is int32.
//
// What bounds it on an H100: the int32 operations of the recurrence, with
// enough pairs in flight to fill every SM (a bucket holds hundreds to
// thousands of pairs); the bytes moved are the sequences and a few words
// per pair. Each step is a shuffle, a few int32 max/add and a block
// barrier; small blocks keep the idle ramp of each row group short
// (nt - 1 of the nt + cols - 1 steps) and let many pairs share an SM.

#include <cuda_runtime.h>
#include <stddef.h>

#include <algorithm>

namespace {

constexpr int kNegInf = -(1 << 30);
constexpr int kMaxThreads = 256;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr size_t kSmemLimit = 48 * 1024;

struct Params {
  const int* subst;  // (S, S)
  const int* ys;     // (npairs, 1 + rows_p), index 0 of a row is the header
  const int* xs;     // (npairs, 1 + cols_p)
  const int* adjrs;  // (npairs,) true lengths with the header
  const int* adjcs;  // (npairs,)
  int* cost;         // (npairs,)
  int* best;         // SW: (npairs, 3)
  int* scratch;      // null, or (npairs, carry_words) carried rows
  int S, gapo, gape, rows_p, cols_p;
};

// Shared memory words before the carried row.
size_t fixed_smem_words(int S, int nt, bool sw) {
  return (size_t)S * S + 4 * (size_t)(nt / 32) + (sw ? 3 * (size_t)nt : 0);
}

__host__ __device__ size_t carry_words(int cols_p, bool affine) {
  return (affine ? 2 : 1) * ((size_t)cols_p + 1);
}

// H on the edge: H[k, 0] == H[0, k]; H[0, 0] = 0.
template <bool SW, bool AFFINE>
__device__ __forceinline__ int edge(const Params& p, int k) {
  if (SW || k == 0) return 0;
  return AFFINE ? p.gapo + k * p.gape : k * p.gapo;
}

template <bool SW, bool AFFINE>
__global__ void __launch_bounds__(kMaxThreads)
mlsp_tiny_kernel(Params p) {
  extern __shared__ int smem[];
  const int b = blockIdx.x;
  // Live rows and columns of this pair (uniform across the block).
  const int rows = min(p.adjrs[b] - 1, p.rows_p);
  const int cols = min(p.adjcs[b] - 1, p.cols_p);
  const int nt = blockDim.x;
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5, nwarps = nt >> 5;
  const int* y = p.ys + (size_t)b * (p.rows_p + 1);
  const int* x = p.xs + (size_t)b * (p.cols_p + 1);

  int* s_subst = smem;
  int* xh = s_subst + p.S * p.S;  // [nwarps][2] H of each warp's last lane
  int* xf = xh + 2 * nwarps;      // [nwarps][2] F of each warp's last lane
  int* red = xf + 2 * nwarps;     // SW: [3][nt] per-thread best
  int* top = p.scratch ? p.scratch + (size_t)b * carry_words(p.cols_p, AFFINE)
                       : red + (SW ? 3 * nt : 0);
  int* ftop = top + (p.cols_p + 1);
  for (int k = t; k < p.S * p.S; k += nt) s_subst[k] = p.subst[k];
  __syncthreads();

  int bv = 0, bi = 0, bj = 0;
  const int ngroups = rows > 0 ? (rows + nt - 1) / nt : 0;
  for (int g = 0; g < ngroups; ++g) {
    const int r0 = g * nt;
    const int nr = min(nt, rows - r0);
    const bool row_ok = t < nr;
    const bool carry = g < ngroups - 1;
    const int gi = r0 + t + 1;  // DP row of this thread

    const int* srow = s_subst;
    if (row_ok) srow = s_subst + y[gi] * p.S;
    int h_left = edge<SW, AFFINE>(p, gi), e_left = kNegInf;
    int diag = edge<SW, AFFINE>(p, gi - 1);
    int h_out = 0, f_out = 0;  // this thread's cell of the previous step
    const int nsteps = nr + cols - 1;
    for (int s = 0; s < nsteps; ++s) {
      int up_h = __shfl_up_sync(kFullMask, h_out, 1);
      int up_f = AFFINE ? __shfl_up_sync(kFullMask, f_out, 1) : 0;
      const int j = s - t + 1;  // DP column of this step's cell
      if (t == 0) {
        if (j <= cols) {
          up_h = g == 0 ? edge<SW, AFFINE>(p, j) : top[j];
          if (AFFINE) up_f = g == 0 ? kNegInf : ftop[j];
        }
      } else if (lane == 0 && s > 0) {
        up_h = xh[2 * (warp - 1) + ((s - 1) & 1)];
        if (AFFINE) up_f = xf[2 * (warp - 1) + ((s - 1) & 1)];
      }
      if (row_ok && j >= 1 && j <= cols) {
        const int sc = srow[x[j]];
        int h;
        if (AFFINE) {
          const int f = max(up_f, up_h + p.gapo) + p.gape;
          const int e = max(e_left, h_left + p.gapo) + p.gape;
          h = max(diag + sc, max(e, f));
          e_left = e;
          f_out = f;
        } else {
          h = max(diag + sc, max(up_h, h_left) + p.gapo);
        }
        if (SW) {
          h = max(h, 0);
          if (h > bv) {
            bv = h;
            bi = gi;
            bj = j;
          }
        } else if (gi == rows && j == cols) {
          p.cost[b] = h;
        }
        diag = up_h;
        h_left = h;
        h_out = h;
        if (carry && t == nr - 1) {
          top[j] = h;
          if (AFFINE) ftop[j] = f_out;
        }
      }
      if (lane == 31) {
        xh[2 * warp + (s & 1)] = h_out;
        if (AFFINE) xf[2 * warp + (s & 1)] = f_out;
      }
      __syncthreads();
    }
  }

  if (SW) {
    red[t] = bv;
    red[nt + t] = bi;
    red[2 * nt + t] = bj;
    __syncthreads();
    if (t == 0) {
      // Rows are disjoint across threads: the pair's best is the largest
      // value, ties to the smallest row, then the smallest column.
      int v = 0, i = 0, j = 0;
      for (int k = 0; k < nt; ++k) {
        const int kv = red[k], ki = red[nt + k], kj = red[2 * nt + k];
        if (kv > v || (kv == v && kv > 0 && (ki < i || (ki == i && kj < j)))) {
          v = kv;
          i = ki;
          j = kj;
        }
      }
      p.cost[b] = v;
      int* o = p.best + 3 * (size_t)b;
      o[0] = v;
      o[1] = i;
      o[2] = j;
    }
  }
}

template <bool SW, bool AFFINE>
int launch(const Params& p, int npairs, int nt, cudaStream_t stream) {
  size_t words = fixed_smem_words(p.S, nt, SW);
  if (!p.scratch) words += carry_words(p.cols_p, AFFINE);
  mlsp_tiny_kernel<SW, AFFINE>
      <<<npairs, nt, words * sizeof(int), stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Words of global scratch per pair for the carried row: 0 when it fits in
// shared memory beside the rest.
long long mlsp_tiny_scratch_words(int S, int threads, int cols_p, int sw,
                                  int affine) {
  const size_t words =
      fixed_smem_words(S, threads, sw) + carry_words(cols_p, affine);
  if (words * sizeof(int) <= kSmemLimit) return 0;
  return (long long)carry_words(cols_p, affine);
}

// Fill npairs pairs of one padded shape, one block of `threads` threads
// each, in one launch. Returns cudaGetLastError() after the launch (0 on
// success); the launch itself is asynchronous.
int mlsp_tiny(int sw, int affine, const int* subst, int S, const int* ys,
              const int* xs, int gapo, int gape, const int* adjrs,
              const int* adjcs, int rows_p, int cols_p, int npairs,
              int threads, int* cost, int* best, int* scratch, void* stream) {
  if (rows_p < 1 || cols_p < 1 || npairs < 1 || threads < 32 ||
      threads > kMaxThreads || threads % 32 ||
      (size_t)S * S * sizeof(int) > kSmemLimit / 2)
    return (int)cudaErrorInvalidValue;
  if (!scratch &&
      mlsp_tiny_scratch_words(S, threads, cols_p, sw, affine) > 0)
    return (int)cudaErrorInvalidValue;
  Params p{subst, ys, xs, adjrs, adjcs, cost, best, scratch,
           S,     gapo, gape, rows_p, cols_p};
  cudaStream_t st = (cudaStream_t)stream;
  if (sw) {
    return affine ? launch<true, true>(p, npairs, threads, st)
                  : launch<true, false>(p, npairs, threads, st);
  }
  return affine ? launch<false, true>(p, npairs, threads, st)
                : launch<false, false>(p, npairs, threads, st);
}

}  // extern "C"

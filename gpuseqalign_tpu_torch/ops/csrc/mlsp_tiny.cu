// mlsp_tiny.cu — cost-only fill of many small pairs, NW/SW x linear/affine:
// one warp a pair, its row strips in turn, no block barrier in the step
// loop.
//
// Replaces the TPU kernel gpuseqalign_tpu/ops/pallas_tiny.py::
// pallas_mlsp_tiny_v2 (kernel body _make_tiny_kernel). It computes what
// that kernel computes for its caller — each pair's align cost and, for
// SW, its best cell — but not the TPU's layout (pairs as sublane
// sub-blocks of one (16, 128) register block, K interleaved chains, dummy
// pairs to fill them):
//
//   * One warp a pair, wpb warps (pairs) a block, one launch a bucket. A
//     warp fills its pair's live cells, (adjr-1) x (adjc-1): neither
//     output depends on the bucket's padded rows and columns. The
//     substitution matrix is one copy a block in shared memory; the one
//     __syncthreads after loading it is the only block barrier.
//   * Row strips of 32*K rows, in turn in the warp. Lane l holds the K
//     consecutive rows l*K+1 .. l*K+K of the strip; at step t it takes
//     column t - l, its K rows one dependent chain, and H (and F) pass
//     down from lane to lane by __shfl_up_sync. Nothing in a step waits on
//     another warp: no barrier, no progress counter, no fence, no ticket.
//   * The strip height is chosen per pair from its live rows R:
//     ns = ceil(R / (32*kLaneRows)) strips of K = ceil(R / (32*ns)) rows a
//     lane, so the strips overshoot R by fewer than 32*ns rows (a 400-row
//     pair: two strips of 224 rows, 48 dead, where strips of 256 rows
//     would hold 112). kLaneRows 8 took 18-31% less time than 4 at every
//     bucket size measured; 16 (more registers, fewer warps an SM) was
//     slower on three specs of four (PERF.md). The last strip sweeps only
//     the steps its live lanes need, C + L for L lanes, C the pair's live
//     columns.
//   * The carry between strips is the bottom row of the strip above: H
//     (and F) of row r0, one row of cols_p + 1 words a plane, in the
//     warp's shared memory or, where a block's rows would not fit in 48
//     KB, in a global scratch row of the pair's own. It is updated in
//     place: the warp reads it 32 columns at a time, one a lane (lane 0
//     takes column t at step t by __shfl_sync), and lane 31 stores column
//     c at step c + 31, after that read. Strips follow after a __syncwarp.
//   * Steps run in chunks of 32. A chunk in which every lane's column
//     stays in 1..C (neither ramp) runs a copy of the step without the
//     selects that keep a row's state outside its columns.
//   * The SW best: each row keeps its first maximum (strict > as j rises),
//     each lane the best of its rows over every strip (ties to the
//     smaller row), and the warp reduces (the value, then the smaller i,
//     then the smaller j) by shuffles: the row-major first maximum over
//     the live cells, (0, 0, 0) when no cell is > 0.
//   * The caller decides pairs with adjr < 2 or adjc < 2 itself: their NW
//     cost lies on the edge and is not written. All arithmetic is int32
//     with kNegInf = -(2^30) as -inf.
//
// What bounds it on an H100: int32 operations, 3/4/6/7 SASS instructions
// a live cell (PERF.md), with many pairs in flight on every SM; the bytes
// moved are the sequences and a few words a pair. A step's shuffles,
// letter and carry reads are shared by K cells, and nothing in it waits
// on another warp. A bucket of few pairs leaves most of the card idle and
// runs at the latency of one warp's strips in turn: parallel/batch.py
// sends such buckets to the pipelined strips of strip_fill.cu (K5).

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kNegInf = -(1 << 30);
constexpr unsigned kFull = 0xffffffffu;
// Warps (pairs) a block at most, and the rows a lane a strip holds at
// most (ops/tiny_cuda.py mirrors both).
constexpr int kMaxWarps = 4;
constexpr int kLaneRows = 8;
// Words of a warp's ring of column letters: the chunk the lanes read and
// the two chunks ahead of it, a power of two.
constexpr int kRing = 128;
// Shared memory a block uses at most: the carry rows move to global
// scratch before a block would need more.
constexpr size_t kSmemLimit = 48 * 1024;

struct Params {
  const int* subst;  // (S, S)
  const int* ys;     // (npairs, 1 + rows_p), index 0 of a row is the header
  const int* xs;     // (npairs, 1 + cols_p)
  const int* adjrs;  // (npairs,) true lengths with the header
  const int* adjcs;  // (npairs,)
  int* cost;         // (npairs,)
  int* best;         // SW: (npairs, 3)
  int* scratch;      // null, or (npairs, carry_words) carry rows
  int S, gapo, gape, rows_p, cols_p, npairs, wpb;
};

__host__ __device__ size_t carry_words(int cols_p, bool affine) {
  return (affine ? 2 : 1) * ((size_t)cols_p + 1);
}

// Words of a block's shared memory: the substitution matrix, a letter
// ring a warp and, with carry, a carry row a warp.
__host__ __device__ size_t smem_words(int S, int wpb, int cols_p,
                                      bool affine, bool carry) {
  return (size_t)S * S + (size_t)wpb * kRing +
         (carry ? (size_t)wpb * carry_words(cols_p, affine) : 0);
}

// H on the edge: H[k, 0] == H[0, k]; H[0, 0] = 0.
template <bool SW, bool AFFINE>
__device__ __forceinline__ int edge(int k, int gapo, int gape) {
  if (SW || k == 0) return 0;
  return AFFINE ? gapo + k * gape : k * gapo;
}

// A lane's K rows of the strip in flight.
template <int K>
struct Rows {
  int srow[K];  // offset of the row letter's substitution row
  int h[K], e[K], f[K];
  int bv[K], bj[K];  // SW: each row's first maximum and its column
};

// The state a strip's steps carry from one to the next.
struct Step {
  int c0;    // this lane's column at the step
  int xq;    // the letter of the next step's column
  int dtop;  // row 0's diagonal: the cell above it one step back
  int up_h;  // H (and F) of the last row of the lane above
  int up_f;
};

// n steps of a strip; CHECK: some lane's column leaves 1..C in them, so
// a row's state is kept by select where it does.
template <int K, bool SW, bool AFFINE, bool CHECK>
__device__ __forceinline__ void sweep(Rows<K>& r, Step& st, int n, int ch,
                                      int chf, const int* s_subst,
                                      const int* ring, int* top, int* ftop,
                                      int C, int gapo, int gape,
                                      unsigned swmask, bool produce,
                                      int lane) {
  const int gog = gapo + gape;
#pragma unroll 1
  for (int j = 0; j < n; ++j, ++st.c0) {
    const int top_h = __shfl_sync(kFull, ch, j);
    const int top_f = AFFINE ? __shfl_sync(kFull, chf, j) : 0;
    const int u0 = lane == 0 ? top_h : st.up_h;
    const int uf0 = lane == 0 ? top_f : st.up_f;
    const int xc = st.xq;
    st.xq = ring[(st.c0 + 1) & (kRing - 1)];
    const bool v = CHECK ? (unsigned)(st.c0 - 1) < (unsigned)C : true;
    int d = st.dtop;  // the chain's diagonal, row by row
    int u = u0;       // the chain's cell above
    st.dtop = u0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int sc = s_subst[r.srow[k] + xc];
      int hn, en = 0, fn = 0;
      // max(a, b) + g == max(a + g, b + g): the adds fuse into VIADDMNMX
      // and the chain through u is one max-add and one max deep.
      if (AFFINE) {
        fn = max((k ? r.f[k - 1] : uf0) + gape, u + gog);
        en = max(r.e[k] + gape, r.h[k] + gog);
        hn = max(max(d + sc, en), fn);
      } else {
        hn = max(max(d + sc, r.h[k] + gapo), u + gapo);
      }
      if (SW) hn = max(hn, 0);
      d = r.h[k];
      u = hn;
      if (SW) {
        const bool better = v && (swmask >> k & 1) && hn > r.bv[k];
        r.bv[k] = better ? hn : r.bv[k];
        r.bj[k] = better ? st.c0 : r.bj[k];
      }
      r.h[k] = v ? hn : r.h[k];
      if (AFFINE) {
        r.e[k] = v ? en : r.e[k];
        r.f[k] = fn;  // read only at this column, by the rows below
      }
    }
    st.up_h = __shfl_up_sync(kFull, r.h[K - 1], 1);
    if (AFFINE) st.up_f = __shfl_up_sync(kFull, r.f[K - 1], 1);
    if (produce && v) {  // this strip's bottom row: the next one's carry
      top[st.c0] = r.h[K - 1];
      if (AFFINE) ftop[st.c0] = r.f[K - 1];
    }
  }
}

// One warp's pair of R x C live cells in ns strips of 32*K rows.
template <int K, bool SW, bool AFFINE>
__device__ __forceinline__ void fill_pair(const Params& p,
                                          const int* s_subst, int* ring,
                                          int* top, int b, int R, int C,
                                          int ns, int lane) {
  const int* y = p.ys + (size_t)b * (p.rows_p + 1);
  const int* x = p.xs + (size_t)b * (p.cols_p + 1);
  int* ftop = top + (p.cols_p + 1);
  int lv = 0, li = 0, lj = 0;  // SW: the lane's best so far
  int cost = 0;                // NW: H[R, C], on the lane of row R
  for (int s = 0; s < ns; ++s) {
    const int r0 = s * 32 * K;
    const int nr = min(32 * K, R - r0);
    const int L = (nr + K - 1) / K;  // lanes with a live row
    // Every strip but the last is whole and feeds the one below.
    const bool produce = lane == 31 && s + 1 < ns;
    Rows<K> r;
    unsigned swmask = 0;  // live rows (a ragged strip has fewer)
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int lk = lane * K + k;
      const int i = r0 + lk + 1;
      const bool live = lk < nr;
      r.srow[k] = (live ? __ldg(y + i) : 0) * p.S;
      r.h[k] = edge<SW, AFFINE>(i, p.gapo, p.gape);
      r.e[k] = kNegInf;
      r.f[k] = kNegInf;
      r.bv[k] = 0;
      r.bj[k] = 0;
      if (live) swmask |= 1u << k;
    }
    // Columns 0..63 of the letters; chunk [t+64, t+96) is loaded at step t.
    __syncwarp();
    ring[lane] = __ldg(x + min(lane, C));
    ring[32 + lane] = __ldg(x + min(32 + lane, C));
    __syncwarp();
    Step st;
    st.c0 = -lane;
    st.xq = ring[0];
    st.dtop = 0;
    st.up_h = __shfl_up_sync(kFull, r.h[K - 1], 1);
    st.up_f = AFFINE ? __shfl_up_sync(kFull, r.f[K - 1], 1) : 0;
    const int T = C + L;
    for (int t0 = 0; t0 < T; t0 += 32) {
      {
        const int cx = t0 + 64 + lane;
        const int xv = cx <= C ? __ldg(x + cx) : 0;
        __syncwarp();
        ring[cx & (kRing - 1)] = xv;
        __syncwarp();
      }
      // Row r0 at columns t0 .. t0+31, one a lane: the top edge for the
      // first strip, else the carry (its column 0 the left edge).
      const int cc = t0 + lane;
      int ch = 0, chf = kNegInf;
      if (s == 0) {
        ch = edge<SW, AFFINE>(cc, p.gapo, p.gape);
      } else if (cc == 0) {
        ch = edge<SW, AFFINE>(r0, p.gapo, p.gape);
      } else if (cc <= C) {
        ch = top[cc];
        if (AFFINE) chf = ftop[cc];
      }
      if (t0 >= 32 && t0 + 31 <= C) {
        sweep<K, SW, AFFINE, false>(r, st, 32, ch, chf, s_subst, ring, top,
                                    ftop, C, p.gapo, p.gape, swmask,
                                    produce, lane);
      } else {
        sweep<K, SW, AFFINE, true>(r, st, min(32, T - t0), ch, chf, s_subst,
                                   ring, top, ftop, C, p.gapo, p.gape,
                                   swmask, produce, lane);
      }
    }
    __syncwarp();  // the carry row, before the next strip reads it
    if (SW) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (r.bv[k] > lv) {
          lv = r.bv[k];
          li = r0 + lane * K + k + 1;
          lj = r.bj[k];
        }
      }
    } else if (s + 1 == ns) {
      const int lk = R - 1 - r0;  // row R of the last strip
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (lane * K + k == lk) cost = r.h[k];
      if (lane == lk / K) p.cost[b] = cost;
    }
  }
  if (SW) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const int v2 = __shfl_down_sync(kFull, lv, off);
      const int i2 = __shfl_down_sync(kFull, li, off);
      const int j2 = __shfl_down_sync(kFull, lj, off);
      if (v2 > lv || (v2 == lv && v2 > 0 && (i2 < li || (i2 == li && j2 < lj)))) {
        lv = v2;
        li = i2;
        lj = j2;
      }
    }
    if (lane == 0) {
      p.cost[b] = lv;
      int* o = p.best + 3 * (size_t)b;
      o[0] = lv;
      o[1] = li;
      o[2] = lj;
    }
  }
}

// fill_pair at the pair's own rows a lane, k in K..kLaneRows.
template <int K, bool SW, bool AFFINE>
__device__ __forceinline__ void fill_pair_k(int k, const Params& p,
                                            const int* s_subst, int* ring,
                                            int* top, int b, int R, int C,
                                            int ns, int lane) {
  if (k == K) {
    fill_pair<K, SW, AFFINE>(p, s_subst, ring, top, b, R, C, ns, lane);
  } else if constexpr (K < kLaneRows) {
    fill_pair_k<K + 1, SW, AFFINE>(k, p, s_subst, ring, top, b, R, C, ns,
                                   lane);
  }
}

template <bool SW, bool AFFINE>
__global__ void __launch_bounds__(32 * kMaxWarps)
mlsp_tiny_kernel(Params p) {
  extern __shared__ int smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int* s_subst = smem;
  int* ring = smem + p.S * p.S + warp * kRing;
  for (int k = threadIdx.x; k < p.S * p.S; k += blockDim.x)
    s_subst[k] = p.subst[k];
  // Every ring slot holds a letter before its column is loaded: the step
  // looks one up for columns outside the pair too.
  for (int k = lane; k < kRing; k += 32) ring[k] = 0;
  __syncthreads();
  const int b = blockIdx.x * p.wpb + warp;
  if (b >= p.npairs) return;
  const size_t cw = carry_words(p.cols_p, AFFINE);
  int* top = p.scratch ? p.scratch + (size_t)b * cw
                       : smem + p.S * p.S + p.wpb * kRing + warp * cw;
  const int R = min(p.adjrs[b] - 1, p.rows_p);
  const int C = min(p.adjcs[b] - 1, p.cols_p);
  if (R < 1 || C < 1) return;
  const int ns = (R + 32 * kLaneRows - 1) / (32 * kLaneRows);
  const int K = (R + 32 * ns - 1) / (32 * ns);
  fill_pair_k<1, SW, AFFINE>(K, p, s_subst, ring, top, b, R, C, ns, lane);
}

template <bool SW, bool AFFINE>
int launch(const Params& p, cudaStream_t stream) {
  const size_t words =
      smem_words(p.S, p.wpb, p.cols_p, AFFINE, p.scratch == nullptr);
  const unsigned blocks = (unsigned)((p.npairs + p.wpb - 1) / p.wpb);
  mlsp_tiny_kernel<SW, AFFINE>
      <<<blocks, 32 * p.wpb, words * sizeof(int), stream>>>(p);
  return (int)cudaGetLastError();
}

// Words of global scratch a pair for its carry row: 0 when a block of wpb
// warps holds its carry rows in shared memory beside the rest
// (ops/tiny_cuda.py::scratch_words mirrors it).
size_t scratch_words(int S, int wpb, int cols_p, bool affine) {
  if (smem_words(S, wpb, cols_p, affine, true) * sizeof(int) <= kSmemLimit)
    return 0;
  return carry_words(cols_p, affine);
}

}  // namespace

extern "C" {

// Fill npairs pairs of one padded shape in one launch: one warp a pair,
// wpb warps a block, strips of at most 32*kLaneRows rows.
// scratch: null, or npairs carry rows (scratch_words ints each) where a
// block's do not fit in shared memory. cost (npairs,) receives each
// pair's cost, for SW best (npairs, 3) its best cell. Returns
// cudaGetLastError() after the launch (0 on success); the launch itself
// is asynchronous.
int mlsp_tiny(int sw, int affine, int wpb, const int* subst,
              int S, const int* ys, const int* xs, int gapo, int gape,
              const int* adjrs, const int* adjcs, int rows_p, int cols_p,
              int npairs, int* cost, int* best, int* scratch, void* stream) {
  if (rows_p < 1 || cols_p < 1 || npairs < 1 || S < 1 || wpb < 1 ||
      wpb > kMaxWarps || !cost || (sw && !best) ||
      smem_words(S, wpb, cols_p, affine, false) * sizeof(int) > kSmemLimit ||
      (!scratch && scratch_words(S, wpb, cols_p, affine) > 0))
    return (int)cudaErrorInvalidValue;
  Params p{subst, ys,   xs,   adjrs,  adjcs,  cost,   best,
           scratch, S,  gapo, gape, rows_p, cols_p, npairs, wpb};
  cudaStream_t st = (cudaStream_t)stream;
  if (sw) return affine ? launch<true, true>(p, st) : launch<true, false>(p, st);
  return affine ? launch<false, true>(p, st) : launch<false, false>(p, st);
}

}  // extern "C"

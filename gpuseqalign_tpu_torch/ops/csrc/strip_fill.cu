// strip_fill.cu — persistent row-strip DP fill for NW/SW x linear/affine,
// one launch a call.
//
// Four entries, each replacing one TPU kernel:
//   strip_fill_pair    K1, gpuseqalign_tpu/ops/pallas_wavefront2.py::
//                      pallas_mlsp_v2 (one pair's tile headers); with
//                      bodyoff = 1 the same fill with the DP cells
//                      skipped, a measuring instrument
//                      (bench/vpu_probe.py::probe_gridcost)
//   strip_fill_dense   K3, pallas_wavefront2.py::pallas_dense_v2 (one
//                      pair's H window, header row and column included)
//   strip_fill_batch   K5, pallas_wavefront2.py::pallas_mlsp_batch_v2 (a
//                      bucket of same-shape pairs)
//   strip_fill_banded  K7, gpuseqalign_tpu/ops/pallas_banded.py::
//                      banded_pass (one pass or more over one column band)
// They compute the TPU kernels' outputs (the tile headers of
// ops/mlsp_plain.py, the banded grids of ops/banded_plain.py, H as
// ops/dense_plain.py::rowscan_dense fills it, the NW cost and the SW
// best), but the schedule is designed for the H100, not carried over from
// the TPU kernels' grids:
//
//   * Row strips. A matrix (a band's pass, or a pair) is cut into strips
//     of SH = 32*K rows. One warp sweeps one strip across all its columns
//     in one pass; lane l holds the K consecutive rows l*K+1 .. l*K+K of
//     the strip. H (and F) pass down from lane to lane by __shfl_up_sync.
//     There is no block barrier in the step loop. A lane's K rows take
//     the same column in a step, one dependent chain of K cells, and lanes
//     are one column apart. (A layout with row k at column c - k, K
//     independent cells a step, was slower on every shape measured: PERF.md.)
//   * The carry between strips is the strip's bottom row: H (and F) of
//     row (s+1)*SH. Where SH is a multiple of tile_h that row is a
//     tile-header row, hrows[(s+1)*SH/tile_h] (frows), so it needs no
//     memory of its own; in the dense fill it is a row of H itself, with F
//     in a carry scratch; otherwise (and in the cost-only batch call, which
//     writes no header) it goes to a carry scratch of one row a strip, H
//     and, for affine gaps, F. A carry row has the padded width 1 + cols
//     (every pair of a bucket alike), so one offset serves every pair.
//   * The pipeline between strips through device memory: strip s has a
//     progress counter. Its producer (the lane that owns its bottom row;
//     in the dense fill the whole warp, after each chunk of H it stores)
//     stores the carry and, every kPublishCols columns and at the last
//     one, runs __threadfence() and a release store of the column count
//     (st.release.gpu). The consumer warp reads the carry 32 columns at a
//     time, one column a lane with ld.global.cg, after acquire loads
//     (ld.acquire.gpu) of the counter; it polls only when a chunk passes
//     the count it last saw, so a step never polls.
//   * Forward progress without a cooperative launch: a warp takes work
//     items (matrix m, strip s) from an atomic ticket, in the order warps
//     start. Ticket t is strip t / nmat of matrix t % nmat, so strip s of a
//     matrix always has a lower ticket than strip s+1, and a warp only
//     ever waits on a warp that took its ticket earlier and so is already
//     running. The grid is the resident capacity (occupancy x SMs),
//     capped at the work; warps loop over tickets until none is left. The
//     banded and batch entries run 4 warps a block, the pair and dense
//     entries as many as the caller asks (PERF.md: 1 ran fastest). A
//     hand-over inside a block, warp to warp through shared memory, was
//     slower on the card than this one through device memory for most
//     specs (PERF.md), and left the kernel.
//   * One launch a call: the wrapper zeroes the counters and the ticket
//     in a scratch of its own on every call (bands of the giant engine run
//     concurrently on several streams).
//   * The cost-only batch call (headers = 0) and the dense fill fill live
//     cells only: a pair's strips cover its rows 1..adjr-1 and columns
//     1..adjc-1, the analytic edge comes from the formulas, the NW cost is
//     the last cell and the SW best is taken over live cells. This is
//     exact: H[i, j] depends only on cells above and to the left, so no
//     padded cell can change the cost or the best. headers = 1 fills the
//     padded grid and writes the tile headers, as the plain version does.
//   * The dense fill's stores: each warp stages its cells in shared
//     memory, SH rows by two 32-column chunks (lanes are a column apart,
//     so a step touches two chunks). When its last lane leaves a chunk,
//     the warp stores the chunk row by row, lane j column c0 + j: one
//     128-byte row segment a store instruction. Offsets are 64-bit (H
//     passes 2^31 cells near 46k^2).
//   * The SW best: each row keeps its first maximum (strict > as j
//     rises), a lane takes the best of its rows (ties to the smaller row),
//     and the warp reduces (value, then the smaller i, then the smaller
//     j): one (v, i, j) a strip, reduced by the wrapper (mlsp_cuda.
//     tile_best), which takes the row-major first maximum over any
//     partition of the matrix. The dense fill leaves the best to the
//     caller, which scans H.
//
// The substitution matrix sits in shared memory, a lane's row letters are
// a row offset into it each, offsets into the header grids are 64-bit,
// and all arithmetic is int32 with kNegInf = -(2^30) as -inf. The column
// letters reach a warp through a ring in shared memory, 32 at a time with
// ld.global.cg, two chunks ahead of use: nothing in the step loop reads
// through L1, which the acquire loads of the counters invalidate.
//
// What bounds the fill on an H100: its least time is int32 operations (a
// few instructions a cell, PERF.md) over the cells its outputs need, or
// for the dense fill the bytes of H; its time is the latency of one
// warp's step times the columns of a strip, plus the pipeline's lag: every
// strip runs behind the one above it, so a matrix of n strips runs n
// stages. The design keeps every strip of every matrix of the call in
// flight at once, one chain a warp, with no barrier; what remains in a
// step is the shuffles, the chain of K cells and the stores (PERF.md).

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kNegInf = -(1 << 30);
constexpr unsigned kFull = 0xffffffffu;
// Warps a block of the banded and batch entries; the pair and dense
// entries take theirs from the caller, up to kMaxWarps. The launch bound
// and the letter rings sized for kMaxWarps (so the matrix sits at a fixed
// offset) kept the banded and batch fills at their speed (PERF.md).
constexpr int kWarps = 4;
constexpr int kMaxWarps = 4;
constexpr size_t kSmemDefault = 48 * 1024;
// Shared memory a block may opt in to on an H100.
constexpr size_t kSmemMax = 232448;
// Words of a warp's ring of column letters: the chunk the lanes read and
// the two chunks ahead of it, a power of two.
constexpr int kRing = 128;
// Columns a strip's producer fills between two progress stores through
// device memory (32 and 64 timed alike on the card, 128 slower: PERF.md).
constexpr int kPublishCols = 32;
// Columns of a dense warp's staging buffer: two 32-column chunks.
constexpr int kStageCols = 64;

struct Args {
  const int* subst;  // (S, S)
  const int* y;      // matrix m's rows at y + m * ystride, 1 + rows words:
                     // index 0 is the header element
  const int* x;      // nmat x (1 + cols)
  const int* adjrs;  // matrix m's true rows at adjrs[m * rstride], or
                     // null: adjr/adjc below
  const int* adjcs;  // (nmat,)
  int* hrows;   // headers: nmat x (nhrows, 1 + cols)
  int* hcols;   // headers: nmat x (rows, hstride)
  int* frows;   // affine
  int* ecols;   // affine
  int* tbest;   // SW: (nmat, ns, 3)
  int* cost;    // batch NW: (nmat,)
  int* carry;   // null (carry in hrows), (1 + AFFINE, nmat, ns, 1 + cols),
                // or the dense fill's F rows (ns, 1 + cols)
  int* prog;    // [0] the ticket, then (nmat, ns) progress counters
  int* hout;    // dense: H (rows + 1, hpitch)
  size_t hpitch;
  int S, gapo, gape, adjr, adjc;
  int nmat, rows, cols, th, tw;
  int nhrows;   // header rows a matrix: trows (batch) or trows + 1
  int hstride;  // words a header column row: tcols (batch) or tcols + 1
  int ns;       // strips a matrix
  int wpb;      // warps a block
  int ystride;  // 1 + rows (a row a matrix), or 0 (one for every matrix)
  int rstride;  // 1, or 0 with ystride 0
};

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

// H[0, j] and H[i, 0] of the matrix's own edge (the live-cell fills).
template <bool SW, bool AFFINE>
__device__ __forceinline__ int edge(int k, int gapo, int gape) {
  if (SW || k == 0) return 0;
  return AFFINE ? gapo + k * gape : k * gapo;
}

// Words of a block's dynamic shared memory: kMaxWarps letter rings, the
// substitution matrix and the dense staging buffers.
// ops/strip_cuda.py::smem_bytes mirrors it.
__host__ __device__ __forceinline__ size_t smem_words(int K, bool dense,
                                                      int S, int wpb) {
  return (size_t)kMaxWarps * kRing + (size_t)S * S +
         (dense ? (size_t)wpb * 32 * K * kStageCols : 0);
}

// One warp's strip: see the header comment. HDR: the padded grid and its
// headers; otherwise live cells only, and with DENSE every cell stored to
// H. BODYOFF: the DP cells skipped, all else kept.
template <int K, bool SW, bool AFFINE, bool HDR, bool DENSE, bool BODYOFF>
__device__ __forceinline__ void strip(const Args& a, const int* s_subst,
                                      int* ring, int* stage, int m, int s,
                                      int lane) {
  const int adjr = a.adjrs ? a.adjrs[(size_t)m * a.rstride] : a.adjr;
  const int adjc = a.adjcs ? a.adjcs[m] : a.adjc;
  const int R = HDR ? a.rows : adjr - 1;  // DP rows filled
  const int C = HDR ? a.cols : adjc - 1;  // DP columns filled
  const int SH = 32 * K;
  const int r0 = s * SH;
  if (R < 1 || C < 1 || r0 >= R) return;
  const int nr = min(SH, R - r0);
  const size_t width = (size_t)a.cols + 1;
  const int* y = a.y + (size_t)m * a.ystride;
  const int* x = a.x + (size_t)m * width;
  int* hrows = nullptr;
  int* hcols = nullptr;
  int* frows = nullptr;
  int* ecols = nullptr;
  if (HDR) {
    hrows = a.hrows + (size_t)m * a.nhrows * width;
    hcols = a.hcols + (size_t)m * a.rows * a.hstride;
    if (AFFINE) {
      frows = a.frows + (size_t)m * a.nhrows * width;
      ecols = a.ecols + (size_t)m * a.rows * a.hstride;
    }
  }
  int* prog = a.prog + 1 + (size_t)m * a.ns;
  // The carry of strip s-1 (this strip's top row) and this strip's own;
  // F's plane follows H's.
  const size_t carry_plane = (size_t)a.nmat * a.ns * width;
  const int* cin_h = nullptr;
  const int* cin_f = nullptr;
  int* cout_h = nullptr;
  int* cout_f = nullptr;
  if (DENSE) {  // H's own row r0, F from the carry rows
    cin_h = a.hout + (size_t)r0 * a.hpitch;
    if (AFFINE) {
      cin_f = a.carry + (size_t)(s - 1) * width;
      cout_f = a.carry + (size_t)s * width;
    }
  } else if (a.carry) {
    cin_h = a.carry + ((size_t)m * a.ns + s - 1) * width;
    cout_h = a.carry + ((size_t)m * a.ns + s) * width;
    if (AFFINE) {
      cin_f = cin_h + carry_plane;
      cout_f = cout_h + carry_plane;
    }
  } else if (HDR) {
    cin_h = hrows + (size_t)(r0 / a.th) * width;
    cin_f = AFFINE ? frows + (size_t)(r0 / a.th) * width : nullptr;
  }
  if (s == 0) {  // the matrix's top row: the caller's, or the edge formula
    cin_h = hrows;
    cin_f = frows;
  }
  // H[r0, 0]: the left edge of the row above the strip.
  const int corner = HDR ? (r0 == 0 ? hrows[0] : hcols[(size_t)(r0 - 1) * a.hstride])
                         : edge<SW, AFFINE>(r0, a.gapo, a.gape);
  // Whether this strip's bottom row goes to a strip below: from its last
  // lane, or (dense) from the warp's chunk stores.
  const bool feeds = nr == SH && r0 + SH < R;
  const bool produce = lane == 31 && feeds;

  // This lane's rows. A lane holds at most one row on a tile-row
  // boundary (tile_h >= K, see strip_rows on the host): row hk, whose H
  // (and F) go to the header row hrp (frp).
  int srow[K];  // offset of the row letter's substitution row
  int h[K], e[K], f[K], bv[K], bj[K];
  unsigned livemask = 0;  // rows of the strip (a ragged strip has fewer)
  unsigned swmask = 0;    // rows whose cells count for the SW best
  int kcost = -1;         // the row of the NW cost cell
  int hk = -1;
  int* hrp = nullptr;  // hrows (frows) row of row hk
  int* frp = nullptr;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int lk = lane * K + k;
    const int i = r0 + lk + 1;
    const bool live = lk < nr;
    srow[k] = (live ? y[i] : 0) * a.S;
    h[k] = 0;
    e[k] = kNegInf;
    if (live) {
      livemask |= 1u << k;
      if (!HDR || i < adjr) swmask |= 1u << k;
      if (HDR) {
        h[k] = hcols[(size_t)(i - 1) * a.hstride];
        if (AFFINE) e[k] = ecols[(size_t)(i - 1) * a.hstride];
        if (i % a.th == 0 && i / a.th < a.nhrows) {
          hk = k;
          hrp = hrows + (size_t)(i / a.th) * width;
          if (AFFINE) frp = frows + (size_t)(i / a.th) * width;
        }
      } else {
        h[k] = edge<SW, AFFINE>(i, a.gapo, a.gape);
      }
      if (!SW && i == adjr - 1) kcost = k;
    }
    f[k] = kNegInf;
    bv[k] = 0;
    bj[k] = 0;
  }
  const bool capture = HDR && !SW && a.cost != nullptr && kcost >= 0;
  // The first header column of this lane's rows.
  int* hcp = HDR ? hcols + (size_t)(r0 + lane * K) * a.hstride : nullptr;
  int* ecp = HDR && AFFINE ? ecols + (size_t)(r0 + lane * K) * a.hstride
                           : nullptr;
  // This lane's first staged cell (dense): row lane*K, column 0.
  int* stp = DENSE ? stage + lane * K * kStageCols : nullptr;

  // The dense fill's chunk [cb, cb + 32) of every row, from the staging
  // buffer to H, one row a store; then, if a strip below reads this
  // strip's bottom row from H, the column count is published.
  auto flush = [&](int cb) {
    __syncwarp();
    const int c = cb + lane;
    if (c >= 1 && c <= C) {
      int* dst = a.hout + (size_t)(r0 + 1) * a.hpitch + c;
      const int* src = stage + (c & (kStageCols - 1));
#pragma unroll 8
      for (int r = 0; r < nr; ++r)
        dst[(size_t)r * a.hpitch] = src[r * kStageCols];
    }
    if (feeds) {
      __threadfence();  // every lane's stores, and lane 31's F carry
      __syncwarp();
      if (lane == 0) st_release(prog + s, min(cb + 31, C));
    }
    __syncwarp();
  };

  // Column of this lane's rows at step t: t - lane. Tile-column
  // position of that column, kept incrementally: cm = c mod tw, cj = c div
  // tw (floor).
  int c0 = -lane;
  int cj = c0 >= 0 ? c0 / a.tw : -((-c0 + a.tw - 1) / a.tw);
  int cm = c0 - cj * a.tw;
  const int hcol_last = a.hstride - 1;  // the last header column stored
  int seen = s == 0 ? C : 0;
  int ch = 0, chf = kNegInf;  // this lane's column of the carry chunk
  // Columns 0..63 of the letters; chunk [t+64, t+96) is loaded at step t.
  __syncwarp();
  ring[lane] = __ldcg(x + min(lane, C));
  ring[32 + lane] = __ldcg(x + min(32 + lane, C));
  __syncwarp();
  int xq = ring[0];  // letter of row 0's next column
  const int T = C + 32;
  // H (and F) of the last row of the lane above, for the next step: each
  // step shuffles them as soon as its cells are done, ahead of its stores.
  int up_h = __shfl_up_sync(kFull, h[K - 1], 1);
  int up_f = AFFINE ? __shfl_up_sync(kFull, f[K - 1], 1) : 0;

  int dtop = 0;  // row 0's diagonal: the cell above it one step back
  int t0 = 0;
  // Chunks of 32 steps: the chunk's letters and carry are fetched before
  // its steps, which do the cells, the shuffles and a few stores alone.
  // Steps past T (the last chunk's tail) touch no cell.
  for (; t0 < T; t0 += 32) {
    {
      const int cx = t0 + 64 + lane;
      const int v = cx <= C ? __ldcg(x + cx) : 0;
      __syncwarp();
      ring[cx & (kRing - 1)] = v;
      __syncwarp();
    }
    if (t0 <= C) {
      // The next 32 columns of the row above, one a lane.
      if (s > 0) {
        const int need = min(t0 + 31, C);
        while (seen < need) seen = ld_acquire(prog + s - 1);
      }
      const int cc = t0 + lane;
      if (cc > C) {
        ch = 0;
        chf = kNegInf;
      } else if (cc == 0) {
        ch = corner;
        chf = kNegInf;
      } else if (cin_h) {
        ch = __ldcg(cin_h + cc);
        chf = AFFINE ? __ldcg(cin_f + cc) : kNegInf;
      } else {  // the live-cell fill's top edge
        ch = edge<SW, AFFINE>(cc, a.gapo, a.gape);
        chf = kNegInf;
      }
    }
#pragma unroll 1
    for (int j = 0; j < 32; ++j, ++c0) {
      const int top_h = __shfl_sync(kFull, ch, j);
      const int top_f = AFFINE ? __shfl_sync(kFull, chf, j) : 0;
      const int u0 = lane == 0 ? top_h : up_h;
      const int uf0 = lane == 0 ? top_f : up_f;
      const int xc = xq;
      xq = ring[(c0 + 1) & (kRing - 1)];
      // Every row computed, no branch: a row outside columns 1..C keeps
      // its state by select, and a dead row of a ragged strip computes
      // values nothing reads.
      const bool v = (unsigned)(c0 - 1) < (unsigned)C;
      int d = dtop;  // the chain's diagonal, row by row
      int u = u0;    // the chain's cell above, unselected: a row outside
                     // 1..C discards its cell, and so does the one below
      dtop = u0;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int sc = s_subst[srow[k] + xc];
        if (BODYOFF) {  // no DP cell: one add a row, off the chain
          h[k] = v ? u0 + sc : h[k];
          continue;
        }
        const int uf = k ? f[k - 1] : uf0;
        int hn, en = 0, fn = 0;
        if (AFFINE) {
          fn = max(uf, u + a.gapo) + a.gape;
          en = max(e[k], h[k] + a.gapo) + a.gape;
          hn = max(d + sc, max(en, fn));
        } else {
          hn = max(d + sc, max(u, h[k]) + a.gapo);
        }
        if (SW) hn = max(hn, 0);
        d = h[k];
        u = hn;
        if (SW && !DENSE) {
          const bool better = v && (swmask >> k & 1) &&
                              (HDR ? c0 < adjc : true) && hn > bv[k];
          bv[k] = better ? hn : bv[k];
          bj[k] = better ? c0 : bj[k];
        }
        h[k] = v ? hn : h[k];
        if (AFFINE) {
          e[k] = v ? en : e[k];
          f[k] = fn;
        }
      }
      up_h = __shfl_up_sync(kFull, h[K - 1], 1);
      if (AFFINE) up_f = __shfl_up_sync(kFull, f[K - 1], 1);

      // The stores of this step: each a branch taken by few lanes.
      if (HDR && cm == 0 && cj >= 1 && cj <= hcol_last && v) {
        // A tile-column boundary: every live row.
#pragma unroll
        for (int k = 0; k < K; ++k) {
          if (livemask >> k & 1) {
            hcp[(size_t)k * a.hstride + cj] = h[k];
            if (AFFINE) ecp[(size_t)k * a.hstride + cj] = e[k];
          }
        }
      }
      if (HDR && hk >= 0) {  // the row on a tile-row boundary
        int hv = h[0], fv = f[0];
#pragma unroll
        for (int k = 1; k < K; ++k) {
          hv = k == hk ? h[k] : hv;
          fv = k == hk ? f[k] : fv;
        }
        if (v) {
          hrp[c0] = hv;
          if (AFFINE) frp[c0] = fv;
        }
      }
      if (DENSE) {  // stage the cells; a chunk is stored once it is whole
#pragma unroll
        for (int k = 0; k < K; ++k)
          stp[k * kStageCols + (c0 & (kStageCols - 1))] = h[k];
      }
      if (capture) {  // the NW cost cell
#pragma unroll
        for (int k = 0; k < K; ++k)
          if (k == kcost && c0 == adjc - 1) a.cost[m] = h[k];
      }
      if (produce && v) {  // this strip's bottom row: the next strip's carry
        if (cout_h) cout_h[c0] = h[K - 1];
        if (AFFINE && cout_f) cout_f[c0] = f[K - 1];
        if (!DENSE && ((c0 & (kPublishCols - 1)) == 0 || c0 == C)) {
          __threadfence();
          st_release(prog + s, c0);
        }
      }
      if (HDR) {
        if (++cm == a.tw) {
          cm = 0;
          ++cj;
        }
      }
    }
    if (DENSE && t0 >= 32 && t0 - 32 <= C) flush(t0 - 32);
  }
  // The last chunk (t0 - 32 >= C: its columns up to C are whole).
  if (DENSE && t0 - 32 <= C) flush(t0 - 32);

  if (!HDR && !DENSE && !SW && a.cost != nullptr) {
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (k == kcost) a.cost[m] = h[k];
  }
  if (SW && !DENSE) {
    // The lane's best: ties to the smaller row, then the warp's.
    int v = 0, bi = 0, bjj = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (bv[k] > v) {
        v = bv[k];
        bi = r0 + lane * K + k + 1;
        bjj = bj[k];
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const int v2 = __shfl_down_sync(kFull, v, off);
      const int i2 = __shfl_down_sync(kFull, bi, off);
      const int j2 = __shfl_down_sync(kFull, bjj, off);
      if (v2 > v || (v2 == v && v2 > 0 && (i2 < bi || (i2 == bi && j2 < bjj)))) {
        v = v2;
        bi = i2;
        bjj = j2;
      }
    }
    if (lane == 0) {
      int* o = a.tbest + 3 * ((size_t)m * a.ns + s);
      o[0] = v;
      o[1] = bi;
      o[2] = bjj;
    }
  }
}

template <int K, bool SW, bool AFFINE, bool HDR, bool DENSE, bool BODYOFF>
__global__ void __launch_bounds__(32 * kMaxWarps) strip_kernel(Args a) {
  extern __shared__ int smem[];
  const int wpb = a.wpb;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int* ring = smem + warp * kRing;
  int* s_subst = smem + kMaxWarps * kRing;
  int* stage = s_subst + a.S * a.S + (size_t)warp * 32 * K * kStageCols;
  for (int k = threadIdx.x; k < a.S * a.S; k += blockDim.x)
    s_subst[k] = a.subst[k];
  // Every ring slot holds a letter, also before its column is loaded: the
  // step loop looks one up for cells outside the matrix too.
  for (int k = threadIdx.x; k < wpb * kRing; k += blockDim.x) smem[k] = 0;
  __syncthreads();
  const int items = a.nmat * a.ns;
  for (;;) {
    int t = 0;
    if (lane == 0) t = atomicAdd(a.prog, 1);
    t = __shfl_sync(kFull, t, 0);
    if (t >= items) break;
    strip<K, SW, AFFINE, HDR, DENSE, BODYOFF>(a, s_subst, ring, stage,
                                              t % a.nmat, t / a.nmat, lane);
  }
}

template <int K, bool SW, bool AFFINE, bool HDR, bool DENSE, bool BODYOFF>
int launch(const Args& a, cudaStream_t stream) {
  auto kern = strip_kernel<K, SW, AFFINE, HDR, DENSE, BODYOFF>;
  const size_t smem = smem_words(K, DENSE, a.S, a.wpb) * sizeof(int);
  const int threads = 32 * a.wpb;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaSuccess;
  if (smem > kSmemDefault)
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                        threads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  // The call's strips, wpb a block.
  long long blocks = ((long long)a.nmat * a.ns + a.wpb - 1) / a.wpb;
  if (blocks > (long long)per_sm * sms) blocks = (long long)per_sm * sms;
  if (blocks < 1) blocks = 1;
  kern<<<(unsigned)blocks, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int K, bool HDR, bool DENSE, bool BODYOFF>
int dispatch_spec(int sw, int affine, const Args& a, cudaStream_t st) {
  if (sw) return affine ? launch<K, true, true, HDR, DENSE, BODYOFF>(a, st)
                        : launch<K, true, false, HDR, DENSE, BODYOFF>(a, st);
  return affine ? launch<K, false, true, HDR, DENSE, BODYOFF>(a, st)
                : launch<K, false, false, HDR, DENSE, BODYOFF>(a, st);
}

template <bool HDR, bool DENSE, bool BODYOFF = false>
int dispatch(int K, int sw, int affine, const Args& a, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (K) {
    case 1: return dispatch_spec<1, HDR, DENSE, BODYOFF>(sw, affine, a, st);
    case 2: return dispatch_spec<2, HDR, DENSE, BODYOFF>(sw, affine, a, st);
    case 4: return dispatch_spec<4, HDR, DENSE, BODYOFF>(sw, affine, a, st);
    case 8: return dispatch_spec<8, HDR, DENSE, BODYOFF>(sw, affine, a, st);
  }
  return (int)cudaErrorInvalidValue;
}

// Whether the schedule arguments are ones the fill takes: K rows a lane
// (1, 2, 4, 8), 1..kMaxWarps warps a block and a block's shared memory
// within what it may opt in to, th >= K (a lane holds at most one
// tile-row boundary). Each entry checks its carry scratch itself.
bool valid_sched(int K, int th, int tw, int S, int wpb, bool dense) {
  return (K == 1 || K == 2 || K == 4 || K == 8) && th >= K && tw >= 1 &&
         S >= 1 && wpb >= 1 && wpb <= kMaxWarps &&
         smem_words(K, dense, S, wpb) * sizeof(int) <= kSmemMax;
}

Args base_args(const int* subst, int S, const int* y, const int* x,
               int gapo, int gape, int* prog) {
  Args a{};
  a.subst = subst;
  a.y = y;
  a.x = x;
  a.prog = prog;
  a.S = S;
  a.gapo = gapo;
  a.gape = gape;
  a.nmat = 1;
  a.wpb = kWarps;
  return a;
}

}  // namespace

extern "C" {

// The banded pass (K7): one launch over the strips of one column band's
// pass of trows tile rows (th rows each) and tcols tile columns (tw
// columns each), K rows a lane (strips of 32*K rows). The grids are
// banded_plain's: hrows/frows (trows + 1, 1 + cols), hcols/ecols (trows,
// th, tcols + 1), cols = tcols*tw; the caller writes the band's inputs
// into row 0 and column 0 (H[r, 0] of row r >= 1 at hcols[(r-1), 0], E
// likewise). Every strip stores its cells' header values, so row trows
// is the next pass's carry and hcols[..., tcols] the next band's halo.
// adjr/adjc are band-local (the SW live mask); tbest (ns, 3) receives
// each strip's band-local SW best. prog: 1 + ns ints, zeroed; carry: null
// when 32*K is a multiple of th, else (1 + affine) * ns * (1 + cols) ints.
int strip_fill_banded(int sw, int affine, int K, const int* subst, int S,
                      const int* y, const int* x, int gapo, int gape,
                      int adjr, int adjc, int th, int tw, int trows,
                      int tcols, int* hrows, int* hcols, int* frows,
                      int* ecols, int* tbest, int* carry, int* prog,
                      void* stream) {
  if (trows < 1 || tcols < 1 || !prog ||
      !valid_sched(K, th, tw, S, kWarps, false) ||
      (!carry && (32 * K) % th) || (sw && !tbest) ||
      (affine && (!frows || !ecols)))
    return (int)cudaErrorInvalidValue;
  Args a = base_args(subst, S, y, x, gapo, gape, prog);
  a.hrows = hrows;
  a.hcols = hcols;
  a.frows = frows;
  a.ecols = ecols;
  a.tbest = tbest;
  a.carry = carry;
  a.adjr = adjr;
  a.adjc = adjc;
  a.rows = trows * th;
  a.cols = tcols * tw;
  a.th = th;
  a.tw = tw;
  a.nhrows = trows + 1;
  a.hstride = tcols + 1;
  a.ns = (a.rows + 32 * K - 1) / (32 * K);
  return dispatch<true, false>(K, sw, affine, a, stream);
}

// The batched fill (K5): one launch over the strips of every pair of a
// bucket of npairs same-shape pairs. ys (npairs, 1 + rows_p), xs (npairs,
// 1 + cols_p), adjrs/adjcs (npairs,); rows_p = trows*th, cols_p =
// tcols*tw. With headers = 1 every pair's padded grid is filled and its
// tile headers written in mlsp_plain's layout, pair-major (hrows/frows
// (trows, 1 + cols_p), hcols/ecols (trows, th, tcols), edge written by
// the caller); with headers = 0 only live cells are filled and no header
// is written. For a pair with adjr >= 2 and adjc >= 2 the NW cost
// H[adjr-1, adjc-1] goes to cost[pair] (SW: not written); tbest (npairs,
// ns, 3), zeroed, receives each strip's SW best. prog: 1 + npairs*ns
// ints, zeroed; carry: (1 + affine) * npairs * ns * (1 + cols_p) ints, or
// null with headers where 32*K is a multiple of th. Pair b's row letters
// are ys[b * ys_stride ...] and its rows adjrs[b * adjrs_stride]: strides
// 1 + rows_p and 1 for a stacked bucket, 0 and 0 for one query against
// every pair (a database search).
int strip_fill_batch(int sw, int affine, int K, int headers,
                     const int* subst, int S, const int* ys, const int* xs,
                     int gapo, int gape, const int* adjrs, const int* adjcs,
                     int th, int tw, int trows, int tcols, int npairs,
                     int ys_stride, int adjrs_stride,
                     int* hrows, int* hcols, int* frows, int* ecols,
                     int* tbest, int* cost, int* carry, int* prog,
                     void* stream) {
  if (trows < 1 || tcols < 1 || npairs < 1 || !prog || !adjrs || !adjcs ||
      (ys_stride != 0 && ys_stride < trows * th + 1) || adjrs_stride < 0 ||
      !valid_sched(K, th, tw, S, kWarps, false) ||
      (!carry && (!headers || (32 * K) % th)) || (sw && !tbest) ||
      (!sw && !cost) ||
      (headers && (!hrows || !hcols || (affine && (!frows || !ecols)))))
    return (int)cudaErrorInvalidValue;
  Args a = base_args(subst, S, ys, xs, gapo, gape, prog);
  a.adjrs = adjrs;
  a.adjcs = adjcs;
  a.hrows = hrows;
  a.hcols = hcols;
  a.frows = frows;
  a.ecols = ecols;
  a.tbest = tbest;
  a.cost = sw ? nullptr : cost;
  a.carry = carry;
  a.nmat = npairs;
  a.rows = trows * th;
  a.cols = tcols * tw;
  a.th = th;
  a.tw = tw;
  a.nhrows = trows;
  a.hstride = tcols;
  a.ns = (a.rows + 32 * K - 1) / (32 * K);
  a.ystride = ys_stride;
  a.rstride = adjrs_stride;
  const long long items = (long long)npairs * a.ns;
  if (items > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (headers) return dispatch<true, false>(K, sw, affine, a, stream);
  return dispatch<false, false>(K, sw, affine, a, stream);
}

// One pair's tile headers (K1): the padded grid of trows x tcols tiles of
// th x tw, in mlsp_plain's layout (hrows/frows (trows, 1 + cols_p),
// hcols/ecols (trows, th, tcols), the edge written by the caller), strips
// of 32*K rows, wpb warps a block. tbest (ns, 3), zeroed, receives each
// strip's SW best.
// prog: 1 + ns ints, zeroed; carry: (1 + affine) * ns * (1 + cols_p) ints,
// or null where 32*K is a multiple of th. bodyoff = 1 skips the DP cells
// (the outputs are then not an alignment's).
int strip_fill_pair(int sw, int affine, int K, int wpb, int bodyoff,
                    const int* subst, int S, const int* y, const int* x,
                    int gapo, int gape, int adjr, int adjc, int th, int tw,
                    int trows, int tcols, int* hrows, int* hcols, int* frows,
                    int* ecols, int* tbest, int* carry, int* prog,
                    void* stream) {
  if (trows < 1 || tcols < 1 || !prog || !hrows || !hcols ||
      !valid_sched(K, th, tw, S, wpb, false) ||
      (!carry && (32 * K) % th) || (sw && !tbest) ||
      (affine && (!frows || !ecols)))
    return (int)cudaErrorInvalidValue;
  Args a = base_args(subst, S, y, x, gapo, gape, prog);
  a.hrows = hrows;
  a.hcols = hcols;
  a.frows = frows;
  a.ecols = ecols;
  a.tbest = tbest;
  a.carry = carry;
  a.adjr = adjr;
  a.adjc = adjc;
  a.rows = trows * th;
  a.cols = tcols * tw;
  a.th = th;
  a.tw = tw;
  a.nhrows = trows;
  a.hstride = tcols;
  a.ns = (a.rows + 32 * K - 1) / (32 * K);
  a.wpb = wpb;
  if (bodyoff) return dispatch<true, false, true>(K, sw, affine, a, stream);
  return dispatch<true, false>(K, sw, affine, a, stream);
}

// One pair's H window (K3): H (adjr, adjc) row-major, the header row and
// column written by the caller, every live cell (1..adjr-1 x 1..adjc-1)
// by the fill, in strips of 32*K rows, wpb warps a block. y holds >= adjr
// letters, x >= adjc (index 0 the header element). adjr, adjc >= 2. prog:
// 1 + ns ints, zeroed, ns = ceil((adjr - 1) / (32*K)); carry: for affine
// gaps ns * adjc ints (F of each strip's bottom row), else null.
int strip_fill_dense(int sw, int affine, int K, int wpb, const int* subst,
                     int S, const int* y, const int* x, int gapo, int gape,
                     int adjr, int adjc, int* H, int* carry, int* prog,
                     void* stream) {
  if (adjr < 2 || adjc < 2 || !prog || !H || (affine && !carry) ||
      !valid_sched(K, K, 1, S, wpb, true))
    return (int)cudaErrorInvalidValue;
  Args a = base_args(subst, S, y, x, gapo, gape, prog);
  a.hout = H;
  a.hpitch = (size_t)adjc;
  a.carry = carry;
  a.adjr = adjr;
  a.adjc = adjc;
  a.rows = adjr - 1;
  a.cols = adjc - 1;
  a.th = K;  // no tiles: th and tw only pass valid_sched and the
  a.tw = 1;  // step's tile counters
  a.ns = (a.rows + 32 * K - 1) / (32 * K);
  a.wpb = wpb;
  return dispatch<false, true>(K, sw, affine, a, stream);
}

}  // extern "C"

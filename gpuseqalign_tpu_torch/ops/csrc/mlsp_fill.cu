// mlsp_fill.cu — tile-diagonal DP fill for NW/SW x linear/affine: sparse
// (mlsp) tile headers, or the dense H matrix.
//
// Replaces four TPU kernels that share one body
// (gpuseqalign_tpu/ops/pallas_wavefront2.py::_make_kernel):
// pallas_mlsp_v2, one pair (mlsp_fill_diag), pallas_mlsp_batch_v2, a
// bucket of same-shape pairs (mlsp_fill_batch_diag, _make_kernel(batch=
// True)), pallas_dense_v2, the full H of one pair (mlsp_fill_dense_diag,
// _make_kernel(dense=True)), and gpuseqalign_tpu/ops/pallas_banded.py::
// banded_pass, one pass or more over one column band of a giant pair
// (mlsp_fill_banded_diag, _make_kernel(banded=True)).
// The sparse entries compute the same thing — the DP matrix's tile
// headers, not the matrix — but not the TPU's layout (lanes = rows, the
// K-chain echelon, packed substitution planes): the design is the
// original reference's gpu7/gpu8 mlsp form. The dense entry is the same
// sweep with each thread also storing its cell of the H window straight
// to device memory (no wavefront history to unskew, as the TPU kernel
// has): the headers still carry the fill between tiles.
//
//   * One launch per tile anti-diagonal d = it + jt, on the caller's
//     stream; trows + tcols - 1 launches fill the matrix. A tile on
//     diagonal d reads only headers written by diagonals d-1 and d-2 (or
//     the analytic edge the wrapper wrote), so stream order is the only
//     synchronisation between launches.
//   * One thread block per tile. Thread t owns tile row t (looping over
//     groups of blockDim rows when the tile is taller) and the block
//     sweeps the tile's anti-diagonals. H (and F) pass down one row per
//     step with __shfl_up_sync inside a warp and through a double-buffered
//     shared-memory slot across warps; the top row of a group is a
//     shared-memory row buffer (global scratch for very wide tiles).
//   * Outputs are exactly what the host layout (_mlsp_store) consumes:
//     the tile's bottom row -> hrows[it+1], its right column ->
//     hcols[it, :, jt+1], plus frows/ecols for affine and the tile's best
//     (v, i, j) for SW. All arithmetic is int32.
//   * The batched entry runs the same body with blockIdx.y as the pair:
//     every array is pair-major with the single-pair layout per pair, the
//     true lengths come from device arrays, and the thread that owns the
//     pair's cell (adjr-1, adjc-1) writes its NW cost. One launch per tile
//     anti-diagonal covers every pair of the bucket (gridDim.y pairs).
//   * The dense entry stores every live cell (gi < adjr, gj < adjc) to
//     H[gi * adjc + gj], with 64-bit offsets (H passes 2^31 cells near
//     46k x 46k). Padded cells are computed, never stored; the SW best is
//     left to the caller, which scans H.
//   * The banded entry runs the body on a band's own header grid, one row
//     and one column wider: the caller writes the band's top row (the
//     previous pass's last row) and its left column (the halo from the
//     band to its left, E too for affine) where K1 has the analytic edge,
//     and every tile also stores the two outputs K1 drops, the right
//     column of the last tile column (the next band's halo) and the
//     bottom row of the last tile row (the next pass's carry). Lengths
//     and the SW mask are band-local; offsets stay 64-bit.
//   * mlsp_fill_bodyoff_diag is mlsp_fill_diag with the DP step skipped
//     (a BODYOFF flag): the same launches, loads and output stores, timed
//     against the whole fill by bench/vpu_probe.py::probe_gridcost to
//     split K1's time into step body and machinery. No path calls it.
//
// What bounds the sparse entries on an H100: not bytes (O(rows*cols/tile)
// header traffic) but the serial dependency chain of the DP — each
// anti-diagonal step is a shuffle, a few int32 max/add and a block
// barrier, and only min(trows, tcols) tiles run at once, so most SMs idle
// on the short diagonals. The int32 operation count per cell is their
// work bound (PERF.md); the banded entry is bound the same way, a serial
// chain per tile and int32 operations over every padded cell of the
// band (the K7 note: making it fast, a pass in flight per band on a
// persistent grid, is later work). The dense entry's bound is bytes: 4
// per cell of H. Its stores are one cell per thread per step, a row pitch
// apart
// within a warp (uncoalesced; L2 merges a row's neighbouring cells from
// consecutive steps before they reach device memory); the same serial
// chain still sets its time. This design keeps every dependency on chip
// (registers, shuffles, shared memory); making it fast (a persistent
// echelon of row blocks, packed 16-bit lanes, several tiles per block,
// staged row-wise H stores) is later work.

#include <cuda_runtime.h>
#include <stddef.h>

#include <algorithm>

namespace {

constexpr int kNegInf = -(1 << 30);
constexpr int kMaxThreads = 256;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr size_t kSmemLimit = 48 * 1024;
constexpr int kMaxGridY = 65535;

struct Params {
  const int* subst;  // (S, S)
  const int* y;      // (1 + rows_p), index 0 is the header element
  const int* x;      // (1 + cols_p)
  int* hrows;        // (trows, 1 + cols_p)
  int* hcols;        // (trows, th, tcols)
  int* frows;        // affine: (trows, 1 + cols_p)
  int* ecols;        // affine: (trows, th, tcols)
  int* tbest;        // SW: (trows * tcols, 3)
  int* scratch;      // null, or (tcols, 2 * (tw + 1)) top-row buffers
  int S, gapo, gape, adjr, adjc, th, tw, trows, tcols;
  // Batched fill only: per-pair true lengths (npairs,) and NW costs.
  const int* adjrs;
  const int* adjcs;
  int* cost;
  // Dense fill only: the full H window (adjr, adjc), row-major.
  int* dense;
};

int block_threads(int th) {
  return std::min(kMaxThreads, ((th + 31) / 32) * 32);
}

// Shared memory words before the top-row buffers.
size_t fixed_smem_words(int S, int nt, bool sw) {
  return (size_t)S * S + 4 * (size_t)(nt / 32) + (sw ? 3 * (size_t)nt : 0);
}

size_t top_words(int tw, bool affine) {
  return (affine ? 2 : 1) * ((size_t)tw + 1);
}

// Pair b of a batched fill: every array is pair-major, and each pair's
// block has the single-pair layout.
__device__ Params pair_params(Params p, int b) {
  const size_t rows_p = (size_t)p.trows * p.th;
  const size_t cols_p = (size_t)p.tcols * p.tw;
  const size_t hdr_row = (size_t)p.trows * (cols_p + 1);
  const size_t hdr_col = rows_p * p.tcols;
  p.y += b * (rows_p + 1);
  p.x += b * (cols_p + 1);
  p.hrows += b * hdr_row;
  p.hcols += b * hdr_col;
  if (p.frows) {
    p.frows += b * hdr_row;
    p.ecols += b * hdr_col;
  }
  if (p.tbest) p.tbest += b * 3 * (size_t)p.trows * p.tcols;
  if (p.scratch) p.scratch += b * 2 * (size_t)p.tcols * (p.tw + 1);
  p.cost += b;
  p.adjr = p.adjrs[b];
  p.adjc = p.adjcs[b];
  return p;
}

template <bool SW, bool AFFINE, bool BATCH, bool DENSE, bool BANDED,
          bool BODYOFF = false>
__global__ void __launch_bounds__(kMaxThreads)
mlsp_tile_kernel(Params args, int d, int it_lo) {
  extern __shared__ int smem[];
  const Params p = BATCH ? pair_params(args, blockIdx.y) : args;
  const int it = it_lo + blockIdx.x;
  const int jt = d - it;
  const int th = p.th, tw = p.tw;
  const int nt = blockDim.x;
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5, nwarps = nt >> 5;

  int* s_subst = smem;
  int* xh = s_subst + p.S * p.S;  // [nwarps][2] H of each warp's last lane
  int* xf = xh + 2 * nwarps;      // [nwarps][2] F of each warp's last lane
  int* red = xf + 2 * nwarps;     // SW: [3][nt] per-thread best
  int* top = p.scratch ? p.scratch + (size_t)jt * 2 * (tw + 1)
                       : red + (SW ? 3 * nt : 0);
  int* ftop = top + (tw + 1);

  const size_t width = (size_t)p.tcols * tw + 1;
  const size_t col0 = (size_t)jt * tw;
  // A band's header grid keeps one more column, its right edge.
  const int hstride = p.tcols + (BANDED ? 1 : 0);
  const int* hrow_in = p.hrows + (size_t)it * width + col0;
  for (int k = t; k < p.S * p.S; k += nt) s_subst[k] = p.subst[k];
  for (int j = t; j <= tw; j += nt) {
    top[j] = hrow_in[j];
    if (AFFINE) ftop[j] = p.frows[(size_t)it * width + col0 + j];
  }
  __syncthreads();

  int bv = 0, bi = 0, bj = 0;
  const int ngroups = (th + nt - 1) / nt;
  for (int g = 0; g < ngroups; ++g) {
    const int r0 = g * nt;
    const int nr = min(nt, th - r0);
    const bool row_ok = t < nr;
    const bool last_group = g == ngroups - 1;
    const int li = r0 + t + 1;     // tile-local DP row, 1..th
    const int gi = it * th + li;   // global DP row
    // hcols[it, li-1, jt]: this row's left header (and the right column's
    // slot is the next element).
    const size_t hc = ((size_t)it * th + (li - 1)) * hstride + jt;

    const int* srow = s_subst;
    int h_left = 0, e_left = kNegInf, diag = 0;
    if (row_ok) {
      srow = s_subst + p.y[gi] * p.S;
      h_left = p.hcols[hc];
      if (AFFINE) e_left = p.ecols[hc];
      diag = li == 1 ? hrow_in[0] : p.hcols[hc - hstride];
    }
    if (BODYOFF) {
      // The machinery alone (bench/vpu_probe.py::probe_gridcost): the
      // same launches and loads and the tile's outputs stored once, no DP
      // step. The values are not an alignment's.
      if (row_ok && jt + 1 < p.tcols) {
        p.hcols[hc + 1] = h_left + diag + srow[0];
        if (AFFINE) p.ecols[hc + 1] = e_left;
      }
      if (last_group && it + 1 < p.trows) {
        for (int j = t + 1; j <= tw; j += nt) {
          const size_t o = (size_t)(it + 1) * width + col0 + j;
          p.hrows[o] = top[j];
          if (AFFINE) p.frows[o] = ftop[j];
        }
      }
      continue;
    }
    int h_out = 0, f_out = 0;  // this thread's cell of the previous step
    const int nsteps = nr + tw - 1;
    for (int s = 0; s < nsteps; ++s) {
      int up_h = __shfl_up_sync(kFullMask, h_out, 1);
      int up_f = AFFINE ? __shfl_up_sync(kFullMask, f_out, 1) : 0;
      const int j = s - t + 1;  // tile-local column of this step's cell
      if (t == 0) {
        if (j <= tw) {
          up_h = top[j];
          if (AFFINE) up_f = ftop[j];
        }
      } else if (lane == 0 && s > 0) {
        up_h = xh[2 * (warp - 1) + ((s - 1) & 1)];
        if (AFFINE) up_f = xf[2 * (warp - 1) + ((s - 1) & 1)];
      }
      if (row_ok && j >= 1 && j <= tw) {
        const int gj = (int)col0 + j;
        const int sc = srow[p.x[gj]];
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
        if (BATCH && !SW && gi == p.adjr - 1 && gj == p.adjc - 1) *p.cost = h;
        if (SW) {
          h = max(h, 0);
          if (h > bv && gi < p.adjr && gj < p.adjc) {
            bv = h;
            bi = gi;
            bj = gj;
          }
        }
        if (DENSE && gi < p.adjr && gj < p.adjc)
          p.dense[(size_t)gi * p.adjc + gj] = h;
        diag = up_h;
        h_left = h;
        h_out = h;
        if (j == tw && (BANDED || jt + 1 < p.tcols)) {
          p.hcols[hc + 1] = h;
          if (AFFINE) p.ecols[hc + 1] = e_left;
        }
        if (t == nr - 1) {
          if (!last_group) {
            top[j] = h;
            if (AFFINE) ftop[j] = f_out;
          } else if (BANDED || it + 1 < p.trows) {
            const size_t o = (size_t)(it + 1) * width + col0 + j;
            p.hrows[o] = h;
            if (AFFINE) p.frows[o] = f_out;
          }
        }
      }
      if (lane == 31) {
        xh[2 * warp + (s & 1)] = h_out;
        if (AFFINE) xf[2 * warp + (s & 1)] = f_out;
      }
      __syncthreads();
    }
  }

  if (SW && !DENSE) {
    red[t] = bv;
    red[nt + t] = bi;
    red[2 * nt + t] = bj;
    __syncthreads();
    if (t == 0) {
      // Rows are disjoint across threads: the tile's best is the largest
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
      int* o = p.tbest + 3 * ((size_t)it * p.tcols + jt);
      o[0] = v;
      o[1] = i;
      o[2] = j;
    }
  }
}

template <bool SW, bool AFFINE, bool BATCH, bool DENSE, bool BANDED,
          bool BODYOFF = false>
int launch(const Params& p, int d, int npairs, cudaStream_t stream) {
  const int it_lo = std::max(0, d - p.tcols + 1);
  const int it_hi = std::min(d, p.trows - 1);
  const int nt = block_threads(p.th);
  size_t words = fixed_smem_words(p.S, nt, SW);
  if (!p.scratch) words += top_words(p.tw, AFFINE);
  const dim3 grid(it_hi - it_lo + 1, npairs);
  mlsp_tile_kernel<SW, AFFINE, BATCH, DENSE, BANDED, BODYOFF>
      <<<grid, nt, words * sizeof(int), stream>>>(p, d, it_lo);
  return (int)cudaGetLastError();
}

template <bool BATCH, bool DENSE, bool BANDED, bool BODYOFF = false>
int dispatch(int sw, int affine, const Params& p, int d, int npairs,
             void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (sw) {
    return affine ? launch<true, true, BATCH, DENSE, BANDED, BODYOFF>(
                        p, d, npairs, st)
                  : launch<true, false, BATCH, DENSE, BANDED, BODYOFF>(
                        p, d, npairs, st);
  }
  return affine ? launch<false, true, BATCH, DENSE, BANDED, BODYOFF>(
                      p, d, npairs, st)
                : launch<false, false, BATCH, DENSE, BANDED, BODYOFF>(
                      p, d, npairs, st);
}

}  // namespace

extern "C" {

// Words of global scratch the fill needs for its top-row buffers: 0 when
// they fit in shared memory beside the rest.
long long mlsp_fill_scratch_words(int S, int th, int tw, int tcols, int sw,
                                  int affine) {
  const size_t words =
      fixed_smem_words(S, block_threads(th), sw) + top_words(tw, affine);
  if (words * sizeof(int) <= kSmemLimit) return 0;
  return (long long)tcols * 2 * ((long long)tw + 1);
}

// Whether the shape arguments are ones the fill takes.
static bool valid_args(int sw, int affine, int S, int th, int tw, int trows,
                       int tcols, int d, const int* scratch) {
  if (th < 1 || tw < 1 || d < 0 || d > trows + tcols - 2 ||
      (size_t)S * S * sizeof(int) > kSmemLimit / 2)
    return false;
  return scratch || mlsp_fill_scratch_words(S, th, tw, tcols, sw, affine) == 0;
}

// Launch the tiles of anti-diagonal d. Returns cudaGetLastError() after
// the launch (0 on success); the launch itself is asynchronous.
int mlsp_fill_diag(int sw, int affine, const int* subst, int S, const int* y,
                   const int* x, int gapo, int gape, int adjr, int adjc,
                   int th, int tw, int trows, int tcols, int d, int* hrows,
                   int* hcols, int* frows, int* ecols, int* tbest,
                   int* scratch, void* stream) {
  if (!valid_args(sw, affine, S, th, tw, trows, tcols, d, scratch))
    return (int)cudaErrorInvalidValue;
  Params p{subst, y,     x,   hrows, hcols, frows, ecols, tbest, scratch,
           S,     gapo,  gape, adjr, adjc,  th,    tw,    trows, tcols};
  return dispatch<false, false, false>(sw, affine, p, d, 1, stream);
}

// The batched fill: the tiles of anti-diagonal d of every pair of a bucket
// of npairs same-shape pairs. ys (npairs, 1 + rows_p), xs (npairs,
// 1 + cols_p), adjrs/adjcs/cost (npairs,); each output and the scratch
// hold npairs single-pair blocks back to back. For a pair with
// adjr >= 2 and adjc >= 2 the NW cost H[adjr-1, adjc-1] is written to
// cost[pair]; cost is not written for SW or for a shorter pair.
int mlsp_fill_batch_diag(int sw, int affine, const int* subst, int S,
                         const int* ys, const int* xs, int gapo, int gape,
                         const int* adjrs, const int* adjcs, int th, int tw,
                         int trows, int tcols, int d, int npairs, int* hrows,
                         int* hcols, int* frows, int* ecols, int* tbest,
                         int* cost, int* scratch, void* stream) {
  if (npairs < 1 || npairs > kMaxGridY ||
      !valid_args(sw, affine, S, th, tw, trows, tcols, d, scratch))
    return (int)cudaErrorInvalidValue;
  Params p{subst, ys,   xs,   hrows, hcols, frows, ecols, tbest, scratch,
           S,     gapo, gape, 0,     0,     th,    tw,    trows, tcols,
           adjrs, adjcs, cost};
  return dispatch<true, false, false>(sw, affine, p, d, npairs, stream);
}

// The dense fill: the tiles of anti-diagonal d of one pair, as
// mlsp_fill_diag, and every cell of the pair's H window (adjr, adjc)
// stored to H (row-major; row 0 and column 0 are the caller's). The tile
// headers still carry the fill from tile to tile; tbest is not written.
// Needs 2 <= adjr <= 1 + trows*th and 2 <= adjc <= 1 + tcols*tw.
int mlsp_fill_dense_diag(int sw, int affine, const int* subst, int S,
                         const int* y, const int* x, int gapo, int gape,
                         int adjr, int adjc, int th, int tw, int trows,
                         int tcols, int d, int* hrows, int* hcols,
                         int* frows, int* ecols, int* H, int* scratch,
                         void* stream) {
  if (!H || adjr < 2 || adjc < 2 ||
      (long long)adjr - 1 > (long long)trows * th ||
      (long long)adjc - 1 > (long long)tcols * tw ||
      !valid_args(sw, affine, S, th, tw, trows, tcols, d, scratch))
    return (int)cudaErrorInvalidValue;
  Params p{subst, y,     x,    hrows, hcols, frows,   ecols,   nullptr,
           scratch, S,   gapo, gape,  adjr,  adjc,    th,      tw,
           trows, tcols, nullptr, nullptr, nullptr, H};
  return dispatch<false, true, false>(sw, affine, p, d, 1, stream);
}

// The banded fill (K7): the tiles of anti-diagonal d of one column band
// of trows tile rows (one pass or more) and tcols tile columns. The grids
// are one wider than mlsp_fill_diag's: hrows/frows (trows + 1, 1 + cols),
// hcols/ecols (trows, th, tcols + 1). The caller writes the band's inputs
// in place of the analytic edge: its top row (and F) into row 0 and its
// left column (and E) into column 0 of hrows and hcols. Every tile stores
// its bottom row and its right column, so row trows is the next pass's
// carry and hcols[..., tcols] the next band's halo. adjr and adjc are
// band-local (adjc <= 1 + cols); tbest holds band-local (v, i, j).
int mlsp_fill_banded_diag(int sw, int affine, const int* subst, int S,
                          const int* y, const int* x, int gapo, int gape,
                          int adjr, int adjc, int th, int tw, int trows,
                          int tcols, int d, int* hrows, int* hcols,
                          int* frows, int* ecols, int* tbest, int* scratch,
                          void* stream) {
  if (!valid_args(sw, affine, S, th, tw, trows, tcols, d, scratch))
    return (int)cudaErrorInvalidValue;
  Params p{subst, y,     x,   hrows, hcols, frows, ecols, tbest, scratch,
           S,     gapo,  gape, adjr, adjc,  th,    tw,    trows, tcols};
  return dispatch<false, false, true>(sw, affine, p, d, 1, stream);
}

// mlsp_fill_diag with the step body skipped (BODYOFF): the launches,
// loads and output stores of the fill, for timing its machinery against
// the whole (bench/vpu_probe.py::probe_gridcost). The outputs are not an
// alignment's.
int mlsp_fill_bodyoff_diag(int sw, int affine, const int* subst, int S,
                           const int* y, const int* x, int gapo, int gape,
                           int adjr, int adjc, int th, int tw, int trows,
                           int tcols, int d, int* hrows, int* hcols,
                           int* frows, int* ecols, int* tbest, int* scratch,
                           void* stream) {
  if (!valid_args(sw, affine, S, th, tw, trows, tcols, d, scratch))
    return (int)cudaErrorInvalidValue;
  Params p{subst, y,     x,   hrows, hcols, frows, ecols, tbest, scratch,
           S,     gapo,  gape, adjr, adjc,  th,    tw,    trows, tcols};
  return dispatch<false, false, false, true>(sw, affine, p, d, 1, stream);
}

}  // extern "C"

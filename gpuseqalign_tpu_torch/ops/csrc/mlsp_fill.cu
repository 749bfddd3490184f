// mlsp_fill.cu — sparse (mlsp) tile-header fill for NW/SW x linear/affine.
//
// Replaces the TPU kernel gpuseqalign_tpu/ops/pallas_wavefront2.py::
// pallas_mlsp_v2 (kernel body _make_kernel). It computes the same thing —
// the DP matrix's tile headers, not the matrix — but not the TPU's layout
// (lanes = rows, the K-chain echelon, packed substitution planes): the
// design is the original reference's gpu7/gpu8 mlsp form.
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
//
// What bounds it on an H100: not bytes (O(rows*cols/tile) header traffic)
// but the serial dependency chain of the DP — each anti-diagonal step is
// a shuffle, a few int32 max/add and a block barrier, and only
// min(trows, tcols) tiles run at once, so most SMs idle on the short
// diagonals. The int32 operation count per cell is the work bound
// (PERF.md). This design keeps every dependency on chip (registers,
// shuffles, shared memory) and touches device memory only for headers;
// making it fast (a persistent echelon of row blocks, packed 16-bit
// lanes, several tiles per block) is later work.

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
  const int* y;      // (1 + rows_p), index 0 is the header element
  const int* x;      // (1 + cols_p)
  int* hrows;        // (trows, 1 + cols_p)
  int* hcols;        // (trows, th, tcols)
  int* frows;        // affine: (trows, 1 + cols_p)
  int* ecols;        // affine: (trows, th, tcols)
  int* tbest;        // SW: (trows * tcols, 3)
  int* scratch;      // null, or (tcols, 2 * (tw + 1)) top-row buffers
  int S, gapo, gape, adjr, adjc, th, tw, trows, tcols;
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

template <bool SW, bool AFFINE>
__global__ void __launch_bounds__(kMaxThreads)
mlsp_tile_kernel(Params p, int d, int it_lo) {
  extern __shared__ int smem[];
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
    const size_t hc = ((size_t)it * th + (li - 1)) * p.tcols + jt;

    const int* srow = s_subst;
    int h_left = 0, e_left = kNegInf, diag = 0;
    if (row_ok) {
      srow = s_subst + p.y[gi] * p.S;
      h_left = p.hcols[hc];
      if (AFFINE) e_left = p.ecols[hc];
      diag = li == 1 ? hrow_in[0] : p.hcols[hc - p.tcols];
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
        if (SW) {
          h = max(h, 0);
          if (h > bv && gi < p.adjr && gj < p.adjc) {
            bv = h;
            bi = gi;
            bj = gj;
          }
        }
        diag = up_h;
        h_left = h;
        h_out = h;
        if (j == tw && jt + 1 < p.tcols) {
          p.hcols[hc + 1] = h;
          if (AFFINE) p.ecols[hc + 1] = e_left;
        }
        if (t == nr - 1) {
          if (!last_group) {
            top[j] = h;
            if (AFFINE) ftop[j] = f_out;
          } else if (it + 1 < p.trows) {
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

  if (SW) {
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

template <bool SW, bool AFFINE>
int launch(const Params& p, int d, cudaStream_t stream) {
  const int it_lo = std::max(0, d - p.tcols + 1);
  const int it_hi = std::min(d, p.trows - 1);
  const int nt = block_threads(p.th);
  size_t words = fixed_smem_words(p.S, nt, SW);
  if (!p.scratch) words += top_words(p.tw, AFFINE);
  mlsp_tile_kernel<SW, AFFINE>
      <<<it_hi - it_lo + 1, nt, words * sizeof(int), stream>>>(p, d, it_lo);
  return (int)cudaGetLastError();
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

// Launch the tiles of anti-diagonal d. Returns cudaGetLastError() after
// the launch (0 on success); the launch itself is asynchronous.
int mlsp_fill_diag(int sw, int affine, const int* subst, int S, const int* y,
                   const int* x, int gapo, int gape, int adjr, int adjc,
                   int th, int tw, int trows, int tcols, int d, int* hrows,
                   int* hcols, int* frows, int* ecols, int* tbest,
                   int* scratch, void* stream) {
  if (th < 1 || tw < 1 || d < 0 || d > trows + tcols - 2 ||
      (size_t)S * S * sizeof(int) > kSmemLimit / 2)
    return (int)cudaErrorInvalidValue;
  if (!scratch && mlsp_fill_scratch_words(S, th, tw, tcols, sw, affine) > 0)
    return (int)cudaErrorInvalidValue;
  Params p{subst, y,     x,   hrows, hcols, frows, ecols, tbest, scratch,
           S,     gapo,  gape, adjr, adjc,  th,    tw,    trows, tcols};
  cudaStream_t st = (cudaStream_t)stream;
  if (sw) {
    return affine ? launch<true, true>(p, d, st) : launch<true, false>(p, d, st);
  }
  return affine ? launch<false, true>(p, d, st) : launch<false, false>(p, d, st);
}

}  // extern "C"

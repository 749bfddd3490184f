// wavefront.cu — row-block wavefront fill for NW linear gap: tile headers
// (K2) or the whole wavefront history (K4).
//
// Replaces two TPU kernels that share one body
// (gpuseqalign_tpu/ops/pallas_wavefront.py::_make_kernel):
// pallas_mlsp_nw_lg, the sparse fill of one pair (MLSP = true), and
// pallas_dense_nw_lg, its dense fill (MLSP = false). The outputs are the
// TPU kernel's, element for element (ops/wavefront_plain.py states the
// contract), with NEG_INF_I32 wherever the TPU kernel left scratch.
//
//   * The DP rows come in blocks of R; row block b sweeps its rows
//     anti-diagonally in NS = R + cols_p - 1 steps: at step c, row r of
//     the block holds cell (b*R + r + 1, c - r + 1) and reads the
//     pre-skewed profile pskew[b, c, r], so each step's profile is one
//     contiguous row of R ints.
//   * One launch per row block, one thread block a launch, in stream
//     order: block b reads its top row, H[b*R, j], from the row that
//     block b-1 stored (K2's output hrow[b-1]; K4's carry buffer), and
//     block 0 takes the analytic H[0, j] = j*gapo. B launches a fill.
//   * Thread t owns K consecutive rows (R/K threads, K in {1,...,16}).
//     A row's up neighbour of the previous step comes from the same
//     thread's registers, or from the thread above by __shfl_up_sync
//     inside a warp and through a double-buffered shared-memory slot
//     across warps (K1's hand-off, ops/csrc/mlsp_fill.cu); one block
//     barrier a step. The diagonal is the up value of the step before.
//   * The profile of step c + D is loaded at step c into a ring of D
//     registers, so its latency is off the serial chain (D steps ahead);
//     thread 0 keeps the top row the same way.
//   * Stores: K4 stores every cell of every step (K consecutive ints a
//     thread, coalesced across the warp) and fills the steps past NS
//     with NEG_INF_I32 off the chain. K2 stores a cell to hcol[b, k] when
//     its column is k*TW (a counter per thread, no division in the
//     step), and the thread of row R-1 stores the block's bottom row.
//     The TPU's moving one-lane select and 128-wide row windows are VMEM
//     artefacts with no counterpart here. Offsets are 64-bit: vhist
//     passes 2^31 ints at 23728 x 23728.
//
// What bounds it on an H100: not bytes (K2 reads the 2.3 GB profile once
// at 23728^2, K4 also writes as much) but the serial chain — a shuffle,
// three int32 operations a cell and a block barrier a step, B * NS steps
// in a row on ONE SM of 132, since row block b+1 waits for all of block
// b. This design keeps every dependency on chip and each launch simple;
// making it fast (persistent blocks that take row blocks in turn and wait
// on a progress flag of the block above, so that row blocks run as a
// pipeline on many SMs; the substitution looked up in the kernel in place
// of pskew) is later work.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kNegInf = -(1 << 30);
constexpr int kMaxThreads = 1024;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr unsigned kFullMask = 0xffffffffu;

struct Params {
  const int* pskew;  // this block's (nspad, R) profile
  const int* top;    // H[b*R, 0..cols_p] (block b-1's row), or null
  int* hrow;         // this block's bottom row, hrow_len ints
  int* hcol;         // MLSP: this block's (ct, R) header columns
  int* vhist;        // !MLSP: this block's (nspad, R) history
  int b, R, cols_p, nspad, hrow_len, tw, ct, gapo;
};

// Rows a thread for a row block of R rows (0 if none): the fewest that
// keep the block at 256 threads or under (a cheaper barrier than 1024),
// else at 1024 or under; R/K is always a whole number of warps.
int rows_per_thread(int R) {
  if (R < 128 || R % 128) return 0;
  for (int k = 1; k <= 16; k *= 2)
    if (R % (32 * k) == 0 && R / k <= 256) return k;
  for (int k = 1; k <= 4; k *= 2)
    if (R / k <= kMaxThreads) return k;
  return 0;
}

template <int K>
__device__ __forceinline__ void load_rows(const int* p, int (&v)[K]) {
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int q = 0; q < K / 4; ++q) {
      const int4 w = __ldg(reinterpret_cast<const int4*>(p) + q);
      v[4 * q] = w.x;
      v[4 * q + 1] = w.y;
      v[4 * q + 2] = w.z;
      v[4 * q + 3] = w.w;
    }
  } else if constexpr (K == 2) {
    const int2 w = __ldg(reinterpret_cast<const int2*>(p));
    v[0] = w.x;
    v[1] = w.y;
  } else {
    v[0] = __ldg(p);
  }
}

template <int K>
__device__ __forceinline__ void store_rows(int* p, const int (&v)[K]) {
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int q = 0; q < K / 4; ++q)
      reinterpret_cast<int4*>(p)[q] =
          make_int4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  } else if constexpr (K == 2) {
    *reinterpret_cast<int2*>(p) = make_int2(v[0], v[1]);
  } else {
    p[0] = v[0];
  }
}

// Thread 0's top-row value at column j: block b-1's row, or j*gapo for
// block 0. Columns past cols_p feed no live cell; clamp the read.
__device__ __forceinline__ int top_at(const Params& p, int j) {
  return p.top ? __ldg(p.top + min(j, p.cols_p)) : j * p.gapo;
}

// D steps of the profile (and of the top row) in flight: K*D registers.
// Only K = 2 and K = 4 run above 256 threads (rows_per_thread).
template <int K, int D, bool MLSP>
__global__ void __launch_bounds__(K == 2 || K == 4 ? kMaxThreads : 256)
wavefront_kernel(Params p) {
  __shared__ int xh[2 * kMaxWarps];  // [warp][2]: lane 31's last row
  const int nt = blockDim.x;
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int R = p.R, cols_p = p.cols_p, g = p.gapo;
  const int r0 = t * K;              // this thread's first block-local row
  const int i0 = p.b * R + r0 + 1;   // ... and its DP row
  const int ns = R + cols_p - 1;
  const int nsteps = (ns + D - 1) / D * D;  // <= nspad - 128 + D - 1

  // Off the chain: every output element the sweep does not store.
  for (int j = t; j < p.hrow_len; j += nt) {
    if (j == 0)
      p.hrow[0] = (p.b + 1) * R * g;
    else if (j > cols_p)
      p.hrow[j] = kNegInf;
  }
  if (MLSP) {
    // hcol[0] (column 0 is the header, never a cell of the sweep) and
    // every column block past cols_p.
    const int k_past = cols_p / p.tw + 1;
    for (int k = 0; k < p.ct; k = k ? k + 1 : k_past)
      for (int r = t; r < R; r += nt) p.hcol[(size_t)k * R + r] = kNegInf;
  } else {
    // Steps from nsteps on hold no live cell (c - r >= cols_p).
    const size_t end = (size_t)p.nspad * R;
    for (size_t e = (size_t)nsteps * R + t; e < end; e += nt)
      p.vhist[e] = kNegInf;
  }
  if (t < 2 * kMaxWarps) xh[t] = 0;

  int v1[K];  // each row's chain value at the previous step
  int dg[K];  // each row's up value of the previous step: this step's diag
#pragma unroll
  for (int k = 0; k < K; ++k) {
    v1[k] = (i0 + k) * g;      // j <= 0: the header value H[i, 0]
    dg[k] = (i0 + k - 1) * g;  // row 0 of block 0..B-1: H[b*R, 0]
  }
  int ring[D][K];
  int topv[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    load_rows<K>(p.pskew + (size_t)d * R + r0, ring[d]);
    topv[d] = t == 0 ? top_at(p, d + 1) : 0;
  }
  // Column of row r0 at step c is c - r0 + 1 = jt0 * tw + jm0, 0 <= jm0 <
  // tw; row r0 + k sits on a tile column (j = jt0 * tw) when jm0 == k.
  const int j_first = 1 - r0;
  int jt0 = j_first >= 0 ? j_first / p.tw : -((p.tw - 1 - j_first) / p.tw);
  int jm0 = j_first - jt0 * p.tw;
  __syncthreads();

  for (int c0 = 0; c0 < nsteps; c0 += D) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const int c = c0 + d;
      int s[K];
#pragma unroll
      for (int k = 0; k < K; ++k) s[k] = ring[d][k];
      int up_in = __shfl_up_sync(kFullMask, v1[K - 1], 1);
      if (lane == 0)
        up_in = t == 0 ? topv[d] : xh[2 * (warp - 1) + ((c - 1) & 1)];
      // Refill the ring slot with step c + D (< nsteps + D <= nspad).
      load_rows<K>(p.pskew + (size_t)(c + D) * R + r0, ring[d]);
      if (t == 0) topv[d] = top_at(p, c + D + 1);

      const int jr = c - r0 + 1;  // column of row r0 + k is jr - k
      int out[K];
#pragma unroll
      for (int k = K - 1; k >= 0; --k) {
        const int up = k ? v1[k - 1] : up_in;
        const int j = jr - k;
        int h = max(dg[k] + s[k], max(up, v1[k]) + g);
        if (j <= 0) h = (i0 + k) * g;
        dg[k] = up;
        v1[k] = h;
        out[k] = j >= 1 && j <= cols_p ? h : kNegInf;
      }
      if (MLSP) {
        if (jm0 < K && jt0 >= 1 && jt0 * p.tw <= cols_p) {
#pragma unroll
          for (int k = 0; k < K; ++k)
            if (jm0 == k) p.hcol[(size_t)jt0 * R + r0 + k] = v1[k];
        }
        if (++jm0 == p.tw) {
          jm0 = 0;
          ++jt0;
        }
      } else {
        store_rows<K>(p.vhist + (size_t)c * R + r0, out);
      }
      if (t == nt - 1) {
        const int j = jr - (K - 1);
        if (j >= 1 && j <= cols_p) p.hrow[j] = v1[K - 1];
      }
      if (lane == 31) xh[2 * warp + (c & 1)] = v1[K - 1];
      __syncthreads();
    }
  }
}

template <int K, int D, bool MLSP>
int launch(const Params& p, cudaStream_t stream) {
  wavefront_kernel<K, D, MLSP><<<1, p.R / K, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

template <bool MLSP>
int dispatch(int K, const Params& p, cudaStream_t stream) {
  switch (K) {
    case 1:
      return launch<1, 16, MLSP>(p, stream);
    case 2:
      return launch<2, 8, MLSP>(p, stream);
    case 4:
      return launch<4, 4, MLSP>(p, stream);
    case 8:
      return launch<8, 4, MLSP>(p, stream);
    case 16:
      return launch<16, 4, MLSP>(p, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Launch row block b of a fill of B blocks of R rows over cols_p columns.
// pskew (B, nspad, R); hrow (B, hrow_len): block b stores H[(b+1)*R, j]
// for j <= cols_p and NEG_INF_I32 beyond, and reads hrow[b-1] as its top
// row. mlsp != 0: hcol (B, ct, R) with tile width tw (K2); else vhist
// (B, nspad, R) (K4; tw and ct unused). Launches must come in order of b
// on one stream. Returns cudaGetLastError() after the launch (0 on
// success); the launch itself is asynchronous.
int wavefront_fill_block(int mlsp, const int* pskew, int B, int nspad,
                         int R, int cols_p, int tw, int ct, int gapo, int b,
                         int* hrow, int hrow_len, int* hcol, int* vhist,
                         void* stream) {
  const int K = rows_per_thread(R);
  if (K == 0 || b < 0 || b >= B || cols_p < 1 || !pskew || !hrow ||
      hrow_len < cols_p + 1 || (long long)nspad < (long long)R + cols_p + 127)
    return (int)cudaErrorInvalidValue;
  if (mlsp ? (!hcol || tw < 1 || (long long)ct * tw <= cols_p) : !vhist)
    return (int)cudaErrorInvalidValue;
  const size_t blk = (size_t)nspad * R;
  Params p{pskew + b * blk,
           b ? hrow + (size_t)(b - 1) * hrow_len : nullptr,
           hrow + (size_t)b * hrow_len,
           mlsp ? hcol + (size_t)b * ct * R : nullptr,
           mlsp ? nullptr : vhist + b * blk,
           b, R, cols_p, nspad, hrow_len, mlsp ? tw : 1, ct, gapo};
  cudaStream_t st = (cudaStream_t)stream;
  return mlsp ? dispatch<true>(K, p, st) : dispatch<false>(K, p, st);
}

}  // extern "C"

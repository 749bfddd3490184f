// wavefront.cu — NW linear-gap wavefront fill in row strips, one launch a
// fill: tile headers (K2) or the whole wavefront history (K4).
//
// Replaces two TPU kernels that share one body
// (gpuseqalign_tpu/ops/pallas_wavefront.py::_make_kernel):
// pallas_mlsp_nw_lg, the sparse fill of one pair (MLSP = true), and
// pallas_dense_nw_lg, its dense fill (MLSP = false). The outputs are the
// TPU kernel's, element for element (ops/wavefront_plain.py states the
// contract), with NEG_INF_I32 wherever the TPU kernel left scratch.
//
//   * The input is the TPU kernel's: the DP rows come in blocks of R, and
//     row r of block b holds cell (b*R + r + 1, c - r + 1) at step c and
//     reads the pre-skewed profile pskew[b, c, r], so each step's profile
//     is one contiguous run of R ints.
//   * Row strips. A block is cut into strips of SH = 32*K rows (K =
//     kLaneRows = 4: strips of 128 rows, which divide every R the wrappers
//     take), one warp a strip (a block of one warp). Lane l holds the K
//     consecutive rows
//     l*K .. l*K+K-1 of its strip, so a warp-step reads one contiguous run
//     of 32*K ints of pskew (K ints a lane, 16-byte loads streamed with
//     ld.global.cs D steps ahead into a ring of registers, the same lines
//     prefetched into L2 64 steps ahead) and gives each lane K independent
//     cells. A row's up neighbour of the step before comes from the same
//     lane's registers, or from the lane above by __shfl_up_sync; the
//     diagonal is the up value of the step before. There is no shared
//     memory and no block barrier.
//   * A strip sweeps only its live steps: strip s of a block covers steps
//     s*SH .. s*SH + SH + cols_p - 2 (rounded up to whole 32-step chunks),
//     where every block used to sweep R + cols_p - 1.
//   * The carry between strips is the bottom row of the strip above, by
//     column. The last strip of block b stores it as hrow[b] (K2's output;
//     K4's carry rows, one a block), every other strip into a carry row of
//     its own (cols_p + 1 ints). Strip 0 of block 0 takes the analytic
//     H[0, j] = j*gapo.
//   * The pipeline through device memory, as in strip_fill.cu: strip g
//     (strips numbered block-major) has a progress counter. Its last lane
//     stores each column of the strip's bottom row and, after each chunk
//     of 32 steps, a release store of the column count (st.release.gpu,
//     which orders the lane's own stores of the row before it; a
//     __threadfence() before it only slowed the step). The strip below
//     reads the carry 32 columns at a time, one column a lane with
//     ld.global.cg, after an acquire load of the counter (ld.acquire.gpu),
//     and fetches the next chunk 16 steps before it needs it, so the
//     load's latency is off the step loop; it polls only when a chunk
//     passes the count it last saw.
//   * Forward progress without a cooperative launch: warps take strips
//     from an atomic ticket in strip order, so a warp only waits on a
//     strip whose ticket was taken earlier, by a warp that is running. The
//     grid is the resident capacity, capped at the number of strips; the
//     wrapper zeroes the ticket and the counters on every call.
//   * Every output element is written once, each store in the step loop a
//     predicated store with no branch. K2: a lane finds once a chunk the
//     step at which its rows meet a tile column (tw >= 32 + K: at most one
//     a chunk), and the warp runs the chunk's copy without stores unless
//     one of its lanes stores in it; the last strip of a block stores the
//     block's bottom row. K4: the history at every swept step (K ints a
//     lane, 32*K contiguous a warp-step, streaming stores). After its
//     sweep the warp writes NEG_INF_I32 to the rest of its rows: K2's hcol
//     at k = 0 and past cols_p, hrow[b] at 0 (the header value) and past
//     cols_p, K4's history at the steps outside the sweep. Offsets are
//     64-bit: vhist passes 2^31 ints at 23728 x 23728.
//
// What bounds it on an H100: the bytes are the profile read once (2.3 GB
// at 23728^2) and, for K4, the history written once (as much again), which
// 3.35 TB/s moves in 0.7 / 1.5 ms. The fill's time is a strip's step
// latency times the critical path of the wavefront: a strip's sweep plus,
// for each strip handed over, its SH rows of skew, the chunk and the
// fetch-ahead (48 steps) and the latency of the hand-over. All strips of
// the fill are in flight at once, one warp each, so the step's latency,
// not the card's issue rate or bandwidth, sets the time (PERF.md).

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kNegInf = -(1 << 30);
constexpr unsigned kFull = 0xffffffffu;
// Rows a lane holds (K), and so the strip height 32*K; steps of the
// profile in flight a lane (D): K*D = 64 registers.
constexpr int kLaneRows = 4;
constexpr int kDepth = 16;
constexpr int kStrip = 32 * kLaneRows;
// Columns between two progress stores, and of a carry chunk.
constexpr int kChunk = 32;
// The step of a chunk at which a lane fetches its column of the next
// chunk's carry.
constexpr int kFetchAt = 16;
// Steps of the profile between the L2 prefetch and the step's own load.
constexpr int kPrefetchAhead = 64;

template <bool B>
struct Flag {
  static constexpr bool value = B;
};

struct Params {
  const int* pskew;  // (B, nspad, R)
  int* hrow;         // (B, hrow_len): H[(b+1)*R, j]; K2's output, K4's carry
  int* carry;        // (B * (per_block - 1), cols_p + 1), or null
  int* hcol;         // MLSP: (B, ct, R)
  int* vhist;        // !MLSP: (B, nspad, R)
  int* prog;         // [0] the ticket, [1 + g] strip g's column count
  int B, R, cols_p, nspad, hrow_len, tw, ct, gapo, per_block;
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

// K consecutive ints, 16 bytes at a time (K is a multiple of 4).
template <int K>
__device__ __forceinline__ void load_rows(const int* p, int (&v)[K]) {
#pragma unroll
  for (int q = 0; q < K / 4; ++q) {
    const int4 w = __ldcs(reinterpret_cast<const int4*>(p) + q);
    v[4 * q] = w.x;
    v[4 * q + 1] = w.y;
    v[4 * q + 2] = w.z;
    v[4 * q + 3] = w.w;
  }
}

template <int K>
__device__ __forceinline__ void store_rows(int* p, const int (&v)[K]) {
#pragma unroll
  for (int q = 0; q < K / 4; ++q)
    __stcs(reinterpret_cast<int4*>(p) + q,
           make_int4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]));
}

// Strip g of the fill (block b = g / per_block, strip s of the block):
// see the header comment. D steps of the profile in flight: K*D registers.
template <int K, int D, bool MLSP>
__device__ __forceinline__ void strip(const Params& p, int g, int lane) {
  static_assert(K % 4 == 0 && kChunk % D == 0 && kFetchAt % D == 0 &&
                    D % (32 / K) == 0,
                "a chunk is whole groups of D steps, a group whole "
                "prefetches");
  constexpr int SH = 32 * K;
  const int R = p.R, cols_p = p.cols_p, gap = p.gapo;
  const int b = g / p.per_block;
  const int s = g - b * p.per_block;
  const int q0 = s * SH;          // the strip's first block-local row
  const int rl = q0 + lane * K;   // this lane's first block-local row
  const int i0 = b * R + rl + 1;  // ... and its DP row
  const size_t width = (size_t)cols_p + 1;
  const size_t blk = (size_t)p.nspad * R;
  const int T = SH + cols_p - 1;  // the strip's live steps
  const int T32 = (T + kChunk - 1) / kChunk * kChunk;
  const int inner = p.per_block - 1;  // carry rows a block
  // The strip's top row (the bottom row of strip g - 1) and its own.
  const int* top = nullptr;
  const int* cnt = p.prog + g;  // strip g - 1's counter
  if (g > 0)
    top = s ? p.carry + (size_t)(b * inner + s - 1) * width
            : p.hrow + (size_t)(b - 1) * p.hrow_len;
  int* bot = s == inner ? p.hrow + (size_t)b * p.hrow_len
                        : p.carry + (size_t)(b * inner + s) * width;
  int* pub = p.prog + 1 + g;
  int* hcol = MLSP ? p.hcol + (size_t)b * p.ct * R : nullptr;
  const int k_past = cols_p / p.tw + 1;  // the first tile column past cols_p

  // This lane's column of the carry chunk that serves steps t0..t0+31:
  // H[top, t0 + 1 + lane].
  int seen = 0;
  auto fetch = [&](int t0) -> int {
    const int j = t0 + 1 + lane;
    if (!top) return j * gap;
    if (t0 >= cols_p) return 0;
    const int need = min(t0 + kChunk, cols_p);
    while (seen < need) seen = ld_acquire(cnt);
    return j <= cols_p ? __ldcg(top + j) : 0;
  };

  const int* pp = p.pskew + b * blk + (size_t)q0 * R + rl;
  int ring[D][K];
#pragma unroll
  for (int d = 0; d < D; ++d) load_rows<K>(pp + (size_t)d * R, ring[d]);
  pp += (size_t)D * R;
  // The L2 prefetch kPrefetchAhead steps ahead: one instruction covers
  // 32/K steps of the strip's K 128-byte lines, lane l the line l % K of
  // step l / K.
  constexpr int kPfSteps = 32 / K;
  const int* pf = p.pskew + b * blk +
                  (size_t)(q0 + kPrefetchAhead + lane / K) * R + q0 +
                  32 * (lane % K);
  const int* pf_end = p.pskew + (b + 1) * blk;
  int* vp = MLSP ? nullptr : p.vhist + b * blk + (size_t)q0 * R + rl;

  int v1[K];  // each row's value at the previous step
  int dg[K];  // each row's up value of the previous step: this step's diag
#pragma unroll
  for (int k = 0; k < K; ++k) {
    v1[k] = (i0 + k) * gap;      // j <= 0: the header value H[i, 0]
    dg[k] = (i0 + k - 1) * gap;  // H[i - 1, 0]
  }
  int jr = 1 - lane * K;  // column of this lane's row k at this step: jr - k
  int ch = 0;             // this lane's column of the current carry chunk

  // One chunk of 32 steps from step t0; with ST (K2), row k of the lane
  // stores its cell to hp[k] at the chunk's step hit + k.
  auto chunk = [&](auto st, int t0, int hit, int* hp) -> int {
    constexpr bool ST = decltype(st)::value;
    int chn = 0;
#pragma unroll 1
    for (int d0 = 0; d0 < kChunk; d0 += D) {
      if (d0 == kFetchAt) chn = fetch(t0 + kChunk);
#pragma unroll
      for (int d = 0; d < D; ++d) {
        int sc[K];
#pragma unroll
        for (int k = 0; k < K; ++k) sc[k] = ring[d][k];
        // Refill the slot with the step D ahead (< nspad: see the entry).
        load_rows<K>(pp, ring[d]);
        pp += R;
        if (d % kPfSteps == 0) {
          if (pf < pf_end)
            asm volatile("prefetch.global.L2 [%0];" :: "l"(pf));
          pf += (size_t)kPfSteps * R;
        }
        int up_in = __shfl_up_sync(kFull, v1[K - 1], 1);
        const int top_h = __shfl_sync(kFull, ch, d0 + d);
        if (lane == 0) up_in = top_h;
        int out[K];
#pragma unroll
        for (int k = K - 1; k >= 0; --k) {
          const int up = k ? v1[k - 1] : up_in;
          const int j = jr - k;
          int h = max(dg[k] + sc[k], max(up, v1[k]) + gap);
          if (j <= 0) h = (i0 + k) * gap;
          dg[k] = up;
          v1[k] = h;
          out[k] = (unsigned)(j - 1) < (unsigned)cols_p ? h : kNegInf;
        }
        // The step's stores, each one predicated store with no branch.
        if (ST) {
          const int e = d0 + d - hit;  // the row on its tile column
          int hv = v1[0];
#pragma unroll
          for (int k = 1; k < K; ++k) hv = e == k ? v1[k] : hv;
          if ((unsigned)e < (unsigned)K) hp[e] = hv;
        }
        if (!MLSP) {
          store_rows<K>(vp, out);
          vp += R;
        }
        // The strip's bottom row, the next strip's top: column jr - K + 1.
        if (lane == 31 && (unsigned)(jr - K) < (unsigned)cols_p)
          bot[jr - K + 1] = v1[K - 1];
        ++jr;
      }
    }
    return chn;
  };

  ch = fetch(0);
  for (int t0 = 0; t0 < T32; t0 += kChunk) {
    int chn;
    if (MLSP) {
      // The first tile column m*tw that row K-1 of the lane has not yet
      // passed: row k reaches it at the chunk's step hit + k, and a tile
      // column (tw >= 32 + K) meets a lane's rows in at most one chunk
      // each. The warp takes the chunk's copy without stores unless one
      // of its lanes stores in it.
      const int lo = jr - K + 1;
      const int m = lo > 0 ? (lo + p.tw - 1) / p.tw : -(-lo / p.tw);
      const int hit = m * p.tw - jr;
      const bool st = m >= 1 && m < k_past && hit < kChunk;
      int* hp = hcol + (size_t)max(m, 0) * R + rl;
      if (__any_sync(kFull, st))
        chn = chunk(Flag<true>{}, t0, st ? hit : kChunk, hp);
      else
        chn = chunk(Flag<false>{}, t0, 0, hp);
    } else {
      chn = chunk(Flag<false>{}, t0, 0, nullptr);
    }
    // Publish the bottom row's columns stored so far, up to jr - K. As SH
    // is a multiple of 32, a chunk's last step stores column 32*m + 1, so
    // the strip below, which waits for 32*m, waits for no later chunk.
    // The release store orders this lane's stores of the row before it.
    if (lane == 31 && jr - K >= 1) st_release(pub, min(jr - K, cols_p));
    ch = chn;
  }

  // Off the chain: the elements of this strip's rows the sweep does not
  // store.
  if (MLSP) {
    for (int k = 0; k < p.ct; k = k ? k + 1 : k_past)
      for (int r = lane; r < SH; r += 32)
        hcol[(size_t)k * R + q0 + r] = kNegInf;
    if (s == inner) {
      if (lane == 0) bot[0] = (b + 1) * R * gap;
      for (int j = cols_p + 1 + lane; j < p.hrow_len; j += 32)
        bot[j] = kNegInf;
    }
  } else {
    int neg[K];
#pragma unroll
    for (int k = 0; k < K; ++k) neg[k] = kNegInf;
    int* v0 = p.vhist + b * blk + rl;
    for (int c = 0; c < q0; ++c) store_rows<K>(v0 + (size_t)c * R, neg);
    for (int c = q0 + T32; c < p.nspad; ++c)
      store_rows<K>(v0 + (size_t)c * R, neg);
  }
}

template <int K, int D, bool MLSP>
__global__ void __launch_bounds__(32) wavefront_kernel(Params p) {
  const int lane = threadIdx.x;
  const int n = p.B * p.per_block;
  for (;;) {
    int g = 0;
    if (lane == 0) g = atomicAdd(p.prog, 1);
    g = __shfl_sync(kFull, g, 0);
    if (g >= n) break;
    strip<K, D, MLSP>(p, g, lane);
  }
}

template <int K, int D, bool MLSP>
int launch(const Params& p, cudaStream_t stream) {
  auto kern = wavefront_kernel<K, D, MLSP>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, 32, 0);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  long long blocks = (long long)p.B * p.per_block;
  if (blocks > (long long)per_sm * sms) blocks = (long long)per_sm * sms;
  kern<<<(unsigned)blocks, 32, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// One fill of B row blocks of R rows (a multiple of 128) over cols_p
// columns, in strips of 128 rows, one launch. pskew (B, nspad, R), 16-byte
// aligned, with nspad >= R + cols_p + 127; hrow (B, hrow_len),
// hrow_len >= cols_p + 1: the last strip of block b stores H[(b+1)*R, j]
// for 1 <= j <= cols_p, which block b+1 reads as its top row (mlsp != 0:
// also the header value at j = 0 and NEG_INF_I32 past cols_p). carry:
// B * (R / 128 - 1) rows of cols_p + 1 ints (null if that is 0). prog:
// 1 + B * R / 128 ints, zeroed. mlsp != 0: hcol (B, ct, R) with tile
// width tw >= 36 and ct * tw > cols_p (K2); else vhist (B, nspad, R)
// (K4; tw and ct unused). Returns cudaGetLastError() after the launch (0
// on success); the launch itself is asynchronous.
int wavefront_fill(int mlsp, const int* pskew, int B, int nspad, int R,
                   int cols_p, int tw, int ct, int gapo, int* hrow,
                   int hrow_len, int* carry, int* hcol, int* vhist,
                   int* prog, void* stream) {
  if (R < kStrip || R % kStrip || B < 1 || cols_p < 1 || !pskew || !hrow ||
      !prog || hrow_len < cols_p + 1 ||
      (long long)nspad < (long long)R + cols_p + 127 ||
      (long long)B * (R / kStrip) > 0x7fffffffLL || (R > kStrip && !carry))
    return (int)cudaErrorInvalidValue;
  if (mlsp ? !hcol || tw < kChunk + kLaneRows || (long long)ct * tw <= cols_p
           : !vhist)
    return (int)cudaErrorInvalidValue;
  Params p{pskew, hrow, carry, mlsp ? hcol : nullptr,
           mlsp ? nullptr : vhist, prog, B, R, cols_p, nspad, hrow_len,
           mlsp ? tw : 1, ct, gapo, R / kStrip};
  cudaStream_t st = (cudaStream_t)stream;
  return mlsp ? launch<kLaneRows, kDepth, true>(p, st)
              : launch<kLaneRows, kDepth, false>(p, st);
}

}  // extern "C"

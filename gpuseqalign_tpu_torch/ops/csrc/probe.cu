// probe.cu — step-body probes of the port's DP kernels on an H100 (K8a–d).
//
// Measuring instruments, not path kernels: nothing of the alignment path
// calls them. They replace the VPU probe family of
// gpuseqalign_tpu/bench/vpu_probe.py:
//
//   probe_chain            _chain_kernel (:57; probe_ops :85 and
//                          probe_skeleton :121)
//   probe_fullstep         probe_fullstep (:176)
//   probe_fullstep_affine  probe_fullstep_affine (:538)
//   probe_int16            probe_int16 (:996)
//
// Each kernel runs a timed chain whose final state its plain PyTorch
// version (ops/probe_plain.py) reproduces bit for bit, so the compiler
// cannot drop the chain (every state starts from a device input and ends
// in a stored output) and a rate is never read off a wrong computation.
// The TPU probes ran one (16, 128) block on one core and carried the DP
// by lane and sublane rolls; here the Hopper primitive that plays each
// TPU primitive's role is timed instead, and the DP step is the one the
// port's fills run (strip_fill.cu, mlsp_tiny.cu), not the TPU block's:
//
//   * probe_chain: each thread holds NCH independent int32 chains and runs
//     `iters` iterations of one body (kMaxAdd2 max(st + a, a + 7); the
//     same through DPX __viaddmax_s32; a > 0 ? st : a; (st >> 2) + a; a warp
//     rotation by one lane with __shfl_sync in place of the lane roll; a
//     rotation by one warp through a double-buffered shared-memory slot
//     and __syncthreads in place of the sublane roll), then stores the max
//     over its chains. The two skeleton bodies are the warp strip below
//     with the substitution score replaced by the input and no header
//     I/O: strip k of a block scores a + k, and the max over the block's
//     strips of each row's H at the last column is stored.
//   * probe_fullstep / probe_fullstep_affine: the fills' faithful nw_lg /
//     sw_lg and nw_ag / sw_ag step over real letters, the warp row strip:
//       - One warp a strip of 32*R rows and `iters` columns, K strips (K
//         warps) a block. Lane l holds rows l*R+1 .. l*R+R; at step t it
//         takes column t + 1 - l for its R rows, one dependent chain, and
//         H (and F) pass down from lane to lane by __shfl_up_sync. The
//         analytic NW edge gives row 0 (lane 0) and column 0.
//       - No block barrier and no cross-warp slot in the step loop: the
//         one __syncthreads follows the load of the substitution matrix
//         into shared memory, once a block.
//       - Column letters as K6 reads them: the warp loads 32 letters a
//         chunk of 32 steps, one a lane, one chunk ahead, into a window of
//         64 in its shared memory, which every lane reads at a fixed
//         offset a step; a lane's R row letters, pre-multiplied by S, sit
//         in registers, and each cell looks its score up in the shared
//         substitution matrix (s_subst[srow + x], as the fills do).
//       - Steps run in chunks of 32. A chunk in which every lane's column
//         lies in 1..iters runs a copy of the step without the selects
//         that keep a row's state outside its columns.
//       - Lane 31 holds the strip's bottom row: it stages H (and F) of it
//         in shared memory each step, and the warp stores 32 columns a
//         chunk, coalesced. H (and E) of the last column, and for SW each
//         row's first maximum (strict > as the column rises), are stored
//         once, after the last step.
//     Ablation variants are template flags: no lookup (the score a + k),
//     no header stores, one warp (strips of 32 rows, R = 1), the SW body.
//   * probe_int16: twelve add+max chains in int32, in packed int16x2
//     (__vadd2, __vmaxs2) and in DPX __viaddmax_s16x2. Halfwords wrap.
//
// What bounds them: instruction issue (operations; one warp instruction a
// clock a scheduler, bench/vpu_probe.py::ISSUE_INSNS_PER_S). For the
// strips that is 3/4/6/7 SASS instructions a cell (nw_lg / sw_lg / nw_ag /
// sw_ag, bench/vpu_probe.py::INSNS_PER_CELL) over every cell of every strip; the
// bytes they move (the letters, the headers, the last column) are well
// under that bound. The chains touch device memory only for their input
// and one output word a thread. The grid is the caller's: one block
// measures a step's latency, SM count x blocks per SM measures the card.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kNegInf = -(1 << 30);
// Threads a block at most, and rows a strip at most (32 R, R <= 8).
constexpr int kMaxThreads = 256;
// Words of a warp's window of column letters: two chunks of 32.
constexpr int kWin = 64;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr size_t kSmemLimit = 48 * 1024;

enum ChainBody {
  kMaxAdd2 = 0,
  kViAddMax = 1,
  kSelect = 2,
  kShiftAdd2 = 3,
  kShfl = 4,
  kXWarp = 5,
  kSkeletonLg = 6,
  kSkeletonAg = 7,
};

enum StepVariant { kBase = 0, kNoLookup = 1, kNoHeader = 2, kOneWarp = 3, kSw = 4 };

enum Int16Mode { kI32 = 0, kI16x2 = 1, kI16x2Dpx = 2 };

constexpr int kInt16Chains = 12;

// ---------------------------------------------------------------- K8a --

template <int BODY, int NCH>
__global__ void __launch_bounds__(kMaxThreads)
chain_kernel(const int* __restrict__ a_in, int* __restrict__ out, int iters) {
  extern __shared__ int slot[];  // kXWarp: [2][NCH][blockDim]
  const int nt = blockDim.x, t = threadIdx.x;
  const size_t g = (size_t)blockIdx.x * nt + t;
  const int a = a_in[g];
  const int a7 = a + 7;
  const int src = ((t & 31) + 1) & 31;  // kShfl: the next lane of the warp
  const int from = (t + 32) % nt;       // kXWarp: the same lane, next warp
  int st[NCH];
#pragma unroll
  for (int k = 0; k < NCH; ++k) st[k] = a + k;
  for (int i = 0; i < iters; ++i) {
    // kSelect: the mask a > 0 of the JAX body, read anew each iteration so
    // that the compiler cannot hoist the select out of the loop.
    int av = a;
    if constexpr (BODY == kSelect) asm volatile("mov.b32 %0, %1;" : "=r"(av) : "r"(a));
    if constexpr (BODY == kXWarp) {
      int* buf = slot + (i & 1) * NCH * nt;
#pragma unroll
      for (int k = 0; k < NCH; ++k) buf[k * nt + t] = st[k];
      __syncthreads();
#pragma unroll
      for (int k = 0; k < NCH; ++k) st[k] = buf[k * nt + from];
    } else {
#pragma unroll
      for (int k = 0; k < NCH; ++k) {
        if constexpr (BODY == kMaxAdd2) st[k] = max(st[k] + a, a7);
        if constexpr (BODY == kViAddMax) st[k] = __viaddmax_s32(st[k], a, a7);
        if constexpr (BODY == kSelect) st[k] = av > 0 ? st[k] : av;
        if constexpr (BODY == kShiftAdd2) st[k] = (st[k] >> 2) + a;
        if constexpr (BODY == kShfl) st[k] = __shfl_sync(kFullMask, st[k], src);
      }
    }
  }
  int m = st[0];
#pragma unroll
  for (int k = 1; k < NCH; ++k) m = max(m, st[k]);
  out[g] = m;
}

// ----------------------------------------------------- K8a skeleton, K8b, K8c --

struct StripArgs {
  const int* subst;  // LOOKUP: (S, S)
  const int* y;      // LOOKUP: (blocks, K, nt) row letters
  const int* x;      // LOOKUP: (K, 1 + iters) column letters, x[k][0] unused
  const int* a;      // !LOOKUP: (blocks, nt); strip k of row i scores a + k
  int S, gapo, gape, iters;
  int* hcol;  // (blocks, K, nt): H[i, iters], the strip's right column
  int* ecol;  // AFFINE: E[i, iters]
  int* hrow;  // HEADER: (blocks, K, iters): H[nt, j], the bottom row
  int* frow;  // HEADER && AFFINE: F[nt, j]
  int* best;  // SW: (blocks, K, nt, 3): (v, i, j) of each row's best cell
  int* out;   // OUTMAX: (blocks, nt): max over strips of H[i, iters]
};

// H[0, n] and H[n, 0] of the analytic edge (n >= 1).
template <bool AFFINE, bool SW>
__device__ __forceinline__ int edge(int n, int gapo, int gape) {
  if (SW) return 0;
  return AFFINE ? gapo + n * gape : n * gapo;
}

// Words of a warp's shared memory: its window of column letters and the
// staged bottom row (H, and F for affine gaps).
__host__ __device__ constexpr int warp_words(bool lookup, bool header,
                                             bool affine) {
  return (lookup ? kWin : 0) + (header ? (affine ? 2 : 1) * 32 : 0);
}

// A lane's R rows of the strip.
template <int R>
struct Rows {
  int srow[R];  // LOOKUP: offset of the row letter's substitution row;
                // else the row's constant score
  int h[R], e[R], f[R];
  int bv[R], bj[R];  // SW: each row's first maximum and its column
};

// The state a lane carries from step to step.
struct Lane {
  int c;     // this lane's column at the step
  int top;   // lane 0: H[0, c], the top edge
  int dtop;  // H of the row above the lane's first, one column back
  int up_h;  // H (and F) of the row above the lane's first, this column
  int up_f;
};

// One step of a lane: column c of its R rows. CHECK: the column may lie
// outside 1..iters, where a row keeps its state (select). Lane 31 stages
// its last row at sl[j] (H) and sl[32 + j] (F).
template <bool AFFINE, bool SW, bool LOOKUP, bool HEADER, bool CHECK, int R>
__device__ __forceinline__ void step(Rows<R>& r, Lane& w, int xc,
                                     const int* s_subst, int iters,
                                     int gapo, int gape, int* sl, int j,
                                     bool stager, bool lane0) {
  const int gog = gapo + gape;
  const int u0 = lane0 ? w.top : w.up_h;
  const int uf0 = lane0 ? kNegInf : w.up_f;
  const bool v = CHECK ? (unsigned)(w.c - 1) < (unsigned)iters : true;
  int d = w.dtop;  // the chain's diagonal, row by row
  int u = u0;      // the chain's cell above
  w.dtop = u0;
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int sc = LOOKUP ? s_subst[r.srow[k] + xc] : r.srow[k];
    int hn, en = 0, fn = 0;
    // max(a, b) + g == max(a + g, b + g): each add that feeds a max fuses
    // with it into one VIADDMNMX.
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
      const bool better = v && hn > r.bv[k];
      r.bv[k] = better ? hn : r.bv[k];
      r.bj[k] = better ? w.c : r.bj[k];
    }
    r.h[k] = v ? hn : r.h[k];
    if (AFFINE) {
      r.e[k] = v ? en : r.e[k];
      r.f[k] = fn;  // read only at this column, by the rows below
    }
  }
  w.up_h = __shfl_up_sync(kFullMask, r.h[R - 1], 1);
  if (AFFINE) w.up_f = __shfl_up_sync(kFullMask, r.f[R - 1], 1);
  if (HEADER && stager) {
    sl[j] = r.h[R - 1];
    if (AFFINE) sl[32 + j] = r.f[R - 1];
  }
  if (!SW) w.top += AFFINE ? gape : gapo;
  ++w.c;
}

// One warp a strip of 32*R rows x iters columns, K = blockDim.x / 32
// strips a block: strip (blockIdx.x, warp) of the layout.
template <bool AFFINE, bool SW, bool LOOKUP, bool HEADER, bool OUTMAX, int R>
__global__ void __launch_bounds__(kMaxThreads)
strip_kernel(StripArgs p) {
  extern __shared__ int smem[];
  constexpr int nt = 32 * R;
  const int K = blockDim.x >> 5;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ss = LOOKUP ? p.S * p.S : 0;
  int* s_subst = smem;
  int* win = smem + ss + warp * warp_words(LOOKUP, HEADER, AFFINE);
  int* stage = win + (LOOKUP ? kWin : 0);
  if (LOOKUP) {
    for (int k = threadIdx.x; k < ss; k += blockDim.x) s_subst[k] = p.subst[k];
    __syncthreads();
  }

  const int iters = p.iters, gapo = p.gapo, gape = p.gape;
  const size_t strip = (size_t)blockIdx.x * K + warp;
  const int row0 = lane * R;  // the lane's rows: row0 + 1 .. row0 + R
  Rows<R> r;
#pragma unroll
  for (int k = 0; k < R; ++k) {
    r.srow[k] = LOOKUP ? p.y[strip * nt + row0 + k] * p.S
                       : p.a[(size_t)blockIdx.x * nt + row0 + k] + warp;
    r.h[k] = edge<AFFINE, SW>(row0 + k + 1, gapo, gape);
    r.e[k] = kNegInf;
    r.f[k] = kNegInf;
    r.bv[k] = 0;
    r.bj[k] = 0;
  }
  Lane w;
  w.c = 1 - lane;
  w.top = edge<AFFINE, SW>(1, gapo, gape);
  w.dtop = 0;  // H[0, 0]
  w.up_h = __shfl_up_sync(kFullMask, r.h[R - 1], 1);
  w.up_f = kNegInf;
  const bool stager = lane == 31, lane0 = lane == 0;

  // Letters of columns t0 - 31 + lane (xlo) and t0 + 1 + lane (xhi) of
  // the chunk of steps t0 .. t0 + 31; the lane reads column t0 + j + 1 -
  // lane at step j from slot j + 32 - lane of the window.
  const int* xk = p.x + (size_t)warp * (iters + 1);
  auto letter = [&](int c) {
    return LOOKUP && c >= 1 && c <= iters ? __ldg(xk + c) : 0;
  };
  int xlo = 0, xhi = letter(1 + lane);
  int* const wl = win + 32 - lane;
  // Lane 31's stage, addressed from its window pointer (win + 1 + 63 ==
  // stage), so that the step's store shares the letter load's register.
  int* const sl = LOOKUP ? wl + kWin - 1 : stage;
  const int T = iters + 31;  // steps: lane 31 takes column iters last
  for (int t0 = 0; t0 < T; t0 += 32) {
    const int xnext = letter(t0 + 33 + lane);
    __syncwarp();  // the last chunk's window and stage reads are done
    if (LOOKUP) {
      win[lane] = xlo;
      win[32 + lane] = xhi;
      __syncwarp();
    }
    if (t0 >= 32 && t0 + 32 <= iters) {
#pragma unroll 4
      for (int j = 0; j < 32; ++j)
        step<AFFINE, SW, LOOKUP, HEADER, false, R>(
            r, w, LOOKUP ? wl[j] : 0, s_subst, iters, gapo, gape, sl, j,
            stager, lane0);
    } else {
      const int n = min(32, T - t0);
#pragma unroll 1
      for (int j = 0; j < n; ++j)
        step<AFFINE, SW, LOOKUP, HEADER, true, R>(
            r, w, LOOKUP ? wl[j] : 0, s_subst, iters, gapo, gape, sl, j,
            stager, lane0);
    }
    if (HEADER) {
      // Lane 31 took column t0 - 30 + j at step j; lane l stores slot l.
      __syncwarp();
      const int c = t0 - 30 + lane;
      if (c >= 1 && c <= iters) {
        const size_t o = strip * iters + c - 1;
        p.hrow[o] = stage[lane];
        if (AFFINE) p.frow[o] = stage[32 + lane];
      }
    }
    xlo = xhi;
    xhi = xnext;
  }

  const size_t o = strip * nt + row0;
  if (OUTMAX) {
    // The max over the block's strips, row by row, through shared memory.
    int* s_out = smem + ss + K * warp_words(LOOKUP, HEADER, AFFINE);
#pragma unroll
    for (int k = 0; k < R; ++k) s_out[warp * nt + row0 + k] = r.h[k];
    __syncthreads();
    for (int i = threadIdx.x; i < nt; i += blockDim.x) {
      int m = s_out[i];
      for (int s2 = 1; s2 < K; ++s2) m = max(m, s_out[s2 * nt + i]);
      p.out[(size_t)blockIdx.x * nt + i] = m;
    }
  } else {
#pragma unroll
    for (int k = 0; k < R; ++k) {
      p.hcol[o + k] = r.h[k];
      if (AFFINE) p.ecol[o + k] = r.e[k];
    }
  }
  if (SW) {
#pragma unroll
    for (int k = 0; k < R; ++k) {
      int* b = p.best + 3 * (o + k);
      b[0] = r.bv[k];
      b[1] = r.bv[k] > 0 ? row0 + k + 1 : 0;
      b[2] = r.bj[k];
    }
  }
}

// ---------------------------------------------------------------- K8d --

template <int MODE>
__global__ void __launch_bounds__(kMaxThreads)
int16_kernel(const int* __restrict__ a_in, int* __restrict__ out, int iters) {
  const size_t g = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if constexpr (MODE == kI32) {
    const int a = a_in[g], a7 = a + 7;
    int st[kInt16Chains];
#pragma unroll
    for (int k = 0; k < kInt16Chains; ++k) st[k] = a + k;
    for (int i = 0; i < iters; ++i) {
#pragma unroll
      for (int k = 0; k < kInt16Chains; ++k) st[k] = max(st[k] + a, a7);
    }
    int m = st[0];
#pragma unroll
    for (int k = 1; k < kInt16Chains; ++k) m = max(m, st[k]);
    out[g] = m;
  } else {
    // Two int16 lanes a word; every operation wraps per halfword.
    const unsigned a = (unsigned)a_in[g];
    const unsigned a7 = __vadd2(a, 0x00070007u);
    unsigned st[kInt16Chains];
#pragma unroll
    for (int k = 0; k < kInt16Chains; ++k) st[k] = __vadd2(a, k * 0x00010001u);
    for (int i = 0; i < iters; ++i) {
#pragma unroll
      for (int k = 0; k < kInt16Chains; ++k) {
        if constexpr (MODE == kI16x2) {
          st[k] = __vmaxs2(__vadd2(st[k], a), a7);
        } else {
          st[k] = __viaddmax_s16x2(st[k], a, a7);
        }
      }
    }
    unsigned m = st[0];
#pragma unroll
    for (int k = 1; k < kInt16Chains; ++k) m = __vmaxs2(m, st[k]);
    out[g] = (int)m;
  }
}

// ---------------------------------------------------------- dispatch --

// A kernel, its threads a block and the dynamic shared memory it needs.
struct Kernel {
  const void* fn;
  int threads;
  size_t smem;
};

template <int BODY>
const void* chain_fn(int nch) {
  switch (nch) {
    case 1: return (const void*)chain_kernel<BODY, 1>;
    case 12: return (const void*)chain_kernel<BODY, 12>;
  }
  return nullptr;
}

template <bool AFFINE, bool SW, bool LOOKUP, bool HEADER, bool OUTMAX>
Kernel strip_fn(int K, int nt, int S) {
  const void* fn = nullptr;
  switch (nt) {
    case 32: fn = (const void*)strip_kernel<AFFINE, SW, LOOKUP, HEADER, OUTMAX, 1>; break;
    case 64: fn = (const void*)strip_kernel<AFFINE, SW, LOOKUP, HEADER, OUTMAX, 2>; break;
    case 128: fn = (const void*)strip_kernel<AFFINE, SW, LOOKUP, HEADER, OUTMAX, 4>; break;
    case 256: fn = (const void*)strip_kernel<AFFINE, SW, LOOKUP, HEADER, OUTMAX, 8>; break;
  }
  if (K != 1 && K != 2 && K != 4 && K != 6 && K != 8) fn = nullptr;
  const size_t words = (LOOKUP ? (size_t)S * S : 0) +
                       (size_t)K * warp_words(LOOKUP, HEADER, AFFINE) +
                       (OUTMAX ? (size_t)K * nt : 0);
  return {fn, 32 * K, sizeof(int) * words};
}

// The skeleton bodies of probe_chain: the warp strip, constant scores, no
// header I/O, the max over strips stored.
Kernel skeleton_kernel(bool affine, int K, int nt) {
  return affine ? strip_fn<true, false, false, false, true>(K, nt, 0)
                : strip_fn<false, false, false, false, true>(K, nt, 0);
}

Kernel chain(int body, int nch, int nt) {
  switch (body) {
    case kMaxAdd2: return {chain_fn<kMaxAdd2>(nch), nt, 0};
    case kViAddMax: return {chain_fn<kViAddMax>(nch), nt, 0};
    case kSelect: return {chain_fn<kSelect>(nch), nt, 0};
    case kShiftAdd2: return {chain_fn<kShiftAdd2>(nch), nt, 0};
    case kShfl: return {chain_fn<kShfl>(nch), nt, 0};
    case kXWarp:
      return {chain_fn<kXWarp>(nch), nt, sizeof(int) * 2 * (size_t)nch * nt};
    case kSkeletonLg: return skeleton_kernel(false, nch, nt);
    case kSkeletonAg: return skeleton_kernel(true, nch, nt);
  }
  return {nullptr, 0, 0};
}

template <bool AFFINE>
Kernel fullstep(int variant, int K, int nt, int S) {
  switch (variant) {
    case kBase: return strip_fn<AFFINE, false, true, true, false>(K, nt, S);
    case kNoLookup: return strip_fn<AFFINE, false, false, true, false>(K, nt, S);
    case kNoHeader: return strip_fn<AFFINE, false, true, false, false>(K, nt, S);
    case kOneWarp:  // the base body at strips of one row a lane
      return strip_fn<AFFINE, false, true, true, false>(K, nt == 32 ? nt : 0, S);
    case kSw: return strip_fn<AFFINE, true, true, true, false>(K, nt, S);
  }
  return {nullptr, 0, 0};
}

Kernel int16(int mode, int nt) {
  switch (mode) {
    case kI32: return {(const void*)int16_kernel<kI32>, nt, 0};
    case kI16x2: return {(const void*)int16_kernel<kI16x2>, nt, 0};
    case kI16x2Dpx: return {(const void*)int16_kernel<kI16x2Dpx>, nt, 0};
  }
  return {nullptr, 0, 0};
}

// entry: 0 probe_chain (sel = body, K = chains; the skeletons' K = strips
// a block), 1 probe_fullstep, 2 probe_fullstep_affine (sel = variant, K =
// strips a block), 3 probe_int16 (sel = mode). nt: threads a block of the
// chain bodies and of probe_int16, rows a strip of the strip kernels.
Kernel select_kernel(int entry, int sel, int K, int nt, int S) {
  if (nt < 32 || nt > kMaxThreads || nt % 32) return {nullptr, 0, 0};
  switch (entry) {
    case 0: return chain(sel, K, nt);
    case 1: return fullstep<false>(sel, K, nt, S);
    case 2: return fullstep<true>(sel, K, nt, S);
    case 3: return int16(sel, nt);
  }
  return {nullptr, 0, 0};
}

int launch(Kernel k, int blocks, void** args, void* stream) {
  if (!k.fn || blocks < 1 || k.smem > kSmemLimit)
    return (int)cudaErrorInvalidValue;
  const cudaError_t rc = cudaLaunchKernel(k.fn, dim3(blocks), dim3(k.threads),
                                          args, k.smem, (cudaStream_t)stream);
  return rc != cudaSuccess ? (int)rc : (int)cudaGetLastError();
}

int strip_launch(int entry, int variant, int K, StripArgs p, int blocks,
                 int nt, void* stream) {
  if (p.iters < 1 || p.S < 1 || p.S * p.S * sizeof(int) > kSmemLimit / 2)
    return (int)cudaErrorInvalidValue;
  void* args[] = {&p};
  return launch(select_kernel(entry, variant, K, nt, p.S), blocks, args,
                stream);
}

}  // namespace

extern "C" {

// K8a: out (blocks * nt,) = the max over nch chains of `iters` iterations
// of `body` per thread, nt threads a block. a (blocks * nt,). nch is 1 or
// 12 for bodies 0-5. The skeletons (6, 7) run nch strips (warps) a block,
// nch 1, 2, 4, 6 or 8, of nt rows (32, 64, 128 or 256) and `iters`
// columns with the gap costs gapo and gape, and store the max over
// strips; returns a cudaError (0 on success).
int probe_chain(int body, int nch, const int* a, int gapo, int gape,
                int iters, int blocks, int nt, int* out, void* stream) {
  if (iters < 0) return (int)cudaErrorInvalidValue;
  if (body == kSkeletonLg || body == kSkeletonAg) {
    StripArgs p{};
    p.a = a;
    p.S = 1;
    p.gapo = gapo;
    p.gape = gape;
    p.iters = iters;
    p.out = out;
    return strip_launch(0, body, nch, p, blocks, nt, stream);
  }
  void* args[] = {&a, &out, &iters};
  return launch(select_kernel(0, body, nch, nt, 0), blocks, args, stream);
}

// K8b: K strips (warps) a block, each of nt rows (32, 64, 128 or 256; 32
// for variant 3, onewarp) x iters columns, nw_lg or sw_lg (variant 4),
// with the outputs of the StripArgs comment. best is null unless variant
// is 4; hrow is not written by variant 2 (noheader).
int probe_fullstep(int variant, int K, const int* subst, int S, const int* y,
                   const int* x, const int* a, int gapo, int iters,
                   int blocks, int nt, int* hcol, int* hrow, int* best,
                   void* stream) {
  StripArgs p{subst, y, x, a, S, gapo, 0, iters,
              hcol, nullptr, hrow, nullptr, best, nullptr};
  return strip_launch(1, variant, K, p, blocks, nt, stream);
}

// K8c: as probe_fullstep for the affine (Gotoh) body, nw_ag or sw_ag.
int probe_fullstep_affine(int variant, int K, const int* subst, int S,
                          const int* y, const int* x, const int* a, int gapo,
                          int gape, int iters, int blocks, int nt, int* hcol,
                          int* ecol, int* hrow, int* frow, int* best,
                          void* stream) {
  StripArgs p{subst, y, x, a, S, gapo, gape, iters,
              hcol, ecol, hrow, frow, best, nullptr};
  return strip_launch(2, variant, K, p, blocks, nt, stream);
}

// K8d: out (blocks * nt,) = the max over 12 chains of `iters` iterations
// of max(c + a, a + 7): mode 0 int32, 1 int16x2 (__vadd2, __vmaxs2),
// 2 int16x2 DPX (__viaddmax_s16x2).
int probe_int16(int mode, const int* a, int iters, int blocks, int nt,
                int* out, void* stream) {
  if (iters < 0) return (int)cudaErrorInvalidValue;
  void* args[] = {&a, &out, &iters};
  return launch(select_kernel(3, mode, 0, nt, 0), blocks, args, stream);
}

// What the compiler made of one probe kernel (entry and sel as in
// select_kernel): info = {registers a thread, local memory bytes a thread
// (spills), resident blocks a SM at its threads a block, dynamic shared
// bytes}.
int probe_kernel_info(int entry, int sel, int K, int nt, int S, int* info) {
  const Kernel k = select_kernel(entry, sel, K, nt, S);
  if (!k.fn) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t rc = cudaFuncGetAttributes(&attr, k.fn);
  if (rc != cudaSuccess) return (int)rc;
  int blocks = 0;
  rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k.fn,
                                                     k.threads, k.smem);
  if (rc != cudaSuccess) return (int)rc;
  info[0] = attr.numRegs;
  info[1] = (int)attr.localSizeBytes;
  info[2] = blocks;
  info[3] = (int)k.smem;
  return 0;
}

}  // extern "C"

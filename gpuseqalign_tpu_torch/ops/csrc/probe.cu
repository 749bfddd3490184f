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
// TPU primitive's role is timed instead:
//
//   * probe_chain: each thread holds NCH independent int32 chains and runs
//     `iters` iterations of one body (kMaxAdd2 max(st + a, a + 7); the
//     same through DPX __viaddmax_s32; a > 0 ? st : a; (st >> 2) + a; a warp
//     rotation by one lane with __shfl_sync in place of the lane roll; a
//     rotation by one warp through a double-buffered shared-memory slot
//     and __syncthreads in place of the sublane roll, K1's cross-warp
//     hand-off), then stores the max over its chains. The two skeleton
//     bodies are K1's step (mlsp_fill.cu, the step loop of
//     mlsp_tile_kernel) with the substitution score replaced by the input
//     and no header I/O: thread t is DP row t + 1 of a strip of blockDim
//     rows and `iters` columns with the analytic NW edge, each chain an
//     independent strip (chain k scores a + k), H (and F) passed down by
//     __shfl_up_sync and the cross-warp slot.
//   * probe_fullstep / probe_fullstep_affine: K1's faithful nw_lg/sw_lg
//     and nw_ag/sw_ag step over real letters — the shared-memory
//     substitution row lookup srow[x[j]], the max/add recurrence, the SW
//     clamp with its best capture, and the right-column and bottom-row
//     stores — K independent strips per block, with ablation variants as
//     template flags (no lookup, no header stores, one warp and so no
//     cross-warp slot or barrier, the SW body).
//   * probe_int16: twelve add+max chains in int32, in packed int16x2
//     (__vadd2, __vmaxs2) and in DPX __viaddmax_s16x2. Halfwords wrap.
//
// What bounds them: int32 issue (operations). The loops touch device
// memory only for the fullstep's column letters (L1 hits: every block
// reads the same K rows of letters) and its header stores (a few words a
// step), so the rate read is the step body's issue and latency. The grid
// is the caller's: one block measures the chain's latency, SM count x
// blocks per SM measures the card.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kNegInf = -(1 << 30);
constexpr int kMaxThreads = 256;
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
  const int* a;      // !LOOKUP: (blocks, nt); chain k of row t scores a + k
  int S, gapo, gape, iters;
  int* hcol;  // (blocks, K, nt): H[i, iters], the strip's right column
  int* ecol;  // AFFINE: E[i, iters]
  int* hrow;  // HEADER: (blocks, K, iters): H[nt, j], the bottom row
  int* frow;  // HEADER && AFFINE: F[nt, j]
  int* best;  // SW: (blocks, K, nt, 3): (v, i, j) of each row's best cell
  int* out;   // OUTMAX: (blocks, nt): max over chains of H[i, iters]
};

// H[0, j] and H[i, 0] of the analytic edge (j, i >= 1).
template <bool AFFINE, bool SW>
__device__ __forceinline__ int edge(int n, int gapo, int gape) {
  if (SW) return 0;
  return AFFINE ? gapo + n * gape : n * gapo;
}

// One strip of blockDim rows x iters columns for each of K chains, the
// step of mlsp_fill.cu's mlsp_tile_kernel (one row group, one tile).
template <bool AFFINE, bool SW, bool LOOKUP, bool HEADER, bool ONEWARP,
          bool OUTMAX, int K>
__global__ void __launch_bounds__(kMaxThreads)
strip_kernel(StripArgs p) {
  extern __shared__ int smem[];
  const int nt = blockDim.x, t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5, nwarps = nt >> 5;
  int* s_subst = smem;
  int* xh = smem + (LOOKUP ? p.S * p.S : 0);  // [nwarps][2][K]
  int* xf = xh + 2 * K * nwarps;              // AFFINE: [nwarps][2][K]
  if (LOOKUP)
    for (int k = t; k < p.S * p.S; k += nt) s_subst[k] = p.subst[k];
  __syncthreads();

  const int iters = p.iters, gapo = p.gapo, gape = p.gape;
  const int i = t + 1;  // this thread's DP row
  const size_t row0 = (size_t)blockIdx.x * K * nt + t;  // chain k: + k * nt
  int srow[K], score[K];
  int h_left[K], e_left[K], diag[K], h_out[K], f_out[K];
  int bv[K], bi[K], bj[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (LOOKUP) {
      srow[k] = p.y[row0 + (size_t)k * nt] * p.S;
    } else {
      score[k] = p.a[(size_t)blockIdx.x * nt + t] + k;
    }
    h_left[k] = edge<AFFINE, SW>(i, gapo, gape);
    diag[k] = i == 1 ? 0 : edge<AFFINE, SW>(i - 1, gapo, gape);
    e_left[k] = kNegInf;
    h_out[k] = 0;
    f_out[k] = 0;
    bv[k] = bi[k] = bj[k] = 0;
  }

  const int nsteps = nt + iters - 1;
  for (int s = 0; s < nsteps; ++s) {
    const int j = s - t + 1;  // this step's column
    int up_h[K], up_f[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      up_h[k] = __shfl_up_sync(kFullMask, h_out[k], 1);
      up_f[k] = AFFINE ? __shfl_up_sync(kFullMask, f_out[k], 1) : 0;
    }
    if (t == 0) {
      const int top = edge<AFFINE, SW>(j, gapo, gape);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        up_h[k] = top;
        up_f[k] = kNegInf;
      }
    } else if (!ONEWARP && lane == 0 && s > 0) {
      const int o = (2 * (warp - 1) + ((s - 1) & 1)) * K;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        up_h[k] = xh[o + k];
        if (AFFINE) up_f[k] = xf[o + k];
      }
    }
    if (j >= 1 && j <= iters) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int sc = LOOKUP ? s_subst[srow[k] + p.x[k * (iters + 1) + j]]
                              : score[k];
        int h;
        if (AFFINE) {
          const int f = max(up_f[k], up_h[k] + gapo) + gape;
          const int e = max(e_left[k], h_left[k] + gapo) + gape;
          h = max(diag[k] + sc, max(e, f));
          e_left[k] = e;
          f_out[k] = f;
        } else {
          h = max(diag[k] + sc, max(up_h[k], h_left[k]) + gapo);
        }
        if (SW) {
          h = max(h, 0);
          if (h > bv[k] && i < nt + 1 && j < iters + 1) {
            bv[k] = h;
            bi[k] = i;
            bj[k] = j;
          }
        }
        diag[k] = up_h[k];
        h_left[k] = h;
        h_out[k] = h;
        if (HEADER) {
          if (j == iters) {
            p.hcol[row0 + (size_t)k * nt] = h;
            if (AFFINE) p.ecol[row0 + (size_t)k * nt] = e_left[k];
          }
          if (t == nt - 1) {
            const size_t o = ((size_t)blockIdx.x * K + k) * iters + j - 1;
            p.hrow[o] = h;
            if (AFFINE) p.frow[o] = f_out[k];
          }
        }
      }
    }
    if (!ONEWARP) {
      if (lane == 31) {
        const int o = (2 * warp + (s & 1)) * K;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          xh[o + k] = h_out[k];
          if (AFFINE) xf[o + k] = f_out[k];
        }
      }
      __syncthreads();
    }
  }

  if (OUTMAX) {
    int m = h_left[0];
#pragma unroll
    for (int k = 1; k < K; ++k) m = max(m, h_left[k]);
    p.out[(size_t)blockIdx.x * nt + t] = m;
  } else if (!HEADER) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      p.hcol[row0 + (size_t)k * nt] = h_left[k];
      if (AFFINE) p.ecol[row0 + (size_t)k * nt] = e_left[k];
    }
  }
  if (SW) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      int* o = p.best + 3 * (row0 + (size_t)k * nt);
      o[0] = bv[k];
      o[1] = bi[k];
      o[2] = bj[k];
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

// A kernel and the dynamic shared memory it needs for blockDim nt.
struct Kernel {
  const void* fn;
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

template <bool AFFINE, bool SW, bool LOOKUP, bool HEADER, bool ONEWARP,
          bool OUTMAX>
const void* strip_fn(int K) {
  switch (K) {
    case 1: return (const void*)strip_kernel<AFFINE, SW, LOOKUP, HEADER, ONEWARP, OUTMAX, 1>;
    case 2: return (const void*)strip_kernel<AFFINE, SW, LOOKUP, HEADER, ONEWARP, OUTMAX, 2>;
    case 4: return (const void*)strip_kernel<AFFINE, SW, LOOKUP, HEADER, ONEWARP, OUTMAX, 4>;
    case 6: return (const void*)strip_kernel<AFFINE, SW, LOOKUP, HEADER, ONEWARP, OUTMAX, 6>;
    case 8: return (const void*)strip_kernel<AFFINE, SW, LOOKUP, HEADER, ONEWARP, OUTMAX, 8>;
  }
  return nullptr;
}

size_t strip_smem(bool lookup, bool affine, int K, int nt, int S) {
  return sizeof(int) * ((lookup ? (size_t)S * S : 0) +
                        (affine ? 4 : 2) * (size_t)K * (nt / 32));
}

// The skeleton bodies of probe_chain: K1's step, constant scores, no
// header I/O, the max over chains stored.
Kernel skeleton_kernel(bool affine, int K, int nt) {
  const void* fn = affine ? strip_fn<true, false, false, false, false, true>(K)
                          : strip_fn<false, false, false, false, false, true>(K);
  return {fn, strip_smem(false, affine, K, nt, 0)};
}

Kernel chain(int body, int nch, int nt) {
  switch (body) {
    case kMaxAdd2: return {chain_fn<kMaxAdd2>(nch), 0};
    case kViAddMax: return {chain_fn<kViAddMax>(nch), 0};
    case kSelect: return {chain_fn<kSelect>(nch), 0};
    case kShiftAdd2: return {chain_fn<kShiftAdd2>(nch), 0};
    case kShfl: return {chain_fn<kShfl>(nch), 0};
    case kXWarp:
      return {chain_fn<kXWarp>(nch), sizeof(int) * 2 * (size_t)nch * nt};
    case kSkeletonLg: return skeleton_kernel(false, nch, nt);
    case kSkeletonAg: return skeleton_kernel(true, nch, nt);
  }
  return {nullptr, 0};
}

template <bool AFFINE>
Kernel fullstep(int variant, int K, int nt, int S) {
  const void* fn = nullptr;
  switch (variant) {
    case kBase: fn = strip_fn<AFFINE, false, true, true, false, false>(K); break;
    case kNoLookup: fn = strip_fn<AFFINE, false, false, true, false, false>(K); break;
    case kNoHeader: fn = strip_fn<AFFINE, false, true, false, false, false>(K); break;
    case kOneWarp:
      fn = nt == 32 ? strip_fn<AFFINE, false, true, true, true, false>(K) : nullptr;
      break;
    case kSw: fn = strip_fn<AFFINE, true, true, true, false, false>(K); break;
  }
  return {fn, strip_smem(variant != kNoLookup, AFFINE, K, nt, S)};
}

Kernel int16(int mode) {
  switch (mode) {
    case kI32: return {(const void*)int16_kernel<kI32>, 0};
    case kI16x2: return {(const void*)int16_kernel<kI16x2>, 0};
    case kI16x2Dpx: return {(const void*)int16_kernel<kI16x2Dpx>, 0};
  }
  return {nullptr, 0};
}

// entry: 0 probe_chain (sel = body, K = chains), 1 probe_fullstep,
// 2 probe_fullstep_affine (sel = variant), 3 probe_int16 (sel = mode).
Kernel select_kernel(int entry, int sel, int K, int nt, int S) {
  if (nt < 32 || nt > kMaxThreads || nt % 32) return {nullptr, 0};
  switch (entry) {
    case 0: return chain(sel, K, nt);
    case 1: return fullstep<false>(sel, K, nt, S);
    case 2: return fullstep<true>(sel, K, nt, S);
    case 3: return int16(sel);
  }
  return {nullptr, 0};
}

int launch(Kernel k, int blocks, int nt, void** args, void* stream) {
  if (!k.fn || blocks < 1 || k.smem > kSmemLimit)
    return (int)cudaErrorInvalidValue;
  const cudaError_t rc = cudaLaunchKernel(k.fn, dim3(blocks), dim3(nt), args,
                                          k.smem, (cudaStream_t)stream);
  return rc != cudaSuccess ? (int)rc : (int)cudaGetLastError();
}

int strip_launch(int entry, int variant, int K, StripArgs p, int blocks,
                 int nt, void* stream) {
  if (p.iters < 1 || p.S < 1 || p.S * p.S * sizeof(int) > kSmemLimit / 2)
    return (int)cudaErrorInvalidValue;
  void* args[] = {&p};
  return launch(select_kernel(entry, variant, K, nt, p.S), blocks, nt, args,
                stream);
}

}  // namespace

extern "C" {

// K8a: out (blocks * nt,) = the max over nch chains of `iters` iterations
// of `body` per thread. a (blocks * nt,). nch is 1 or 12 for bodies 0-5
// and 1, 2, 4, 6 or 8 for the skeletons (6, 7), whose gapo and gape are
// the strip's gap costs; returns a cudaError (0 on success).
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
  return launch(select_kernel(0, body, nch, nt, 0), blocks, nt, args, stream);
}

// K8b: K strips of nt rows x iters columns per block, nw_lg or sw_lg
// (variant 4), with the outputs of the StripArgs comment. best is null
// unless variant is 4; hrow is not written by variant 2 (noheader).
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
  return launch(select_kernel(3, mode, 0, nt, 0), blocks, nt, args, stream);
}

// What the compiler made of one probe kernel (entry and sel as in
// select_kernel): info = {registers a thread, local memory bytes a thread
// (spills), resident blocks a SM at blockDim nt, dynamic shared bytes}.
int probe_kernel_info(int entry, int sel, int K, int nt, int S, int* info) {
  const Kernel k = select_kernel(entry, sel, K, nt, S);
  if (!k.fn) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t rc = cudaFuncGetAttributes(&attr, k.fn);
  if (rc != cudaSuccess) return (int)rc;
  int blocks = 0;
  rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k.fn, nt,
                                                     k.smem);
  if (rc != cudaSuccess) return (int)rc;
  info[0] = attr.numRegs;
  info[1] = (int)attr.localSizeBytes;
  info[2] = blocks;
  info[3] = (int)k.smem;
  return 0;
}

}  // extern "C"

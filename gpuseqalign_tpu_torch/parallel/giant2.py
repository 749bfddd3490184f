"""Giant-pair engine: one pair's columns split into bands, every spec.

Port of gpuseqalign_tpu's ``parallel/giant2.py``. The columns of one
giant pair (or of a stream of pairs) are split into D bands of
``band_cols`` columns, one per entry of a mesh (``parallel/mesh.py``),
and rows advance in passes of BL row blocks of R rows. Band k fills its
columns with the banded pass (K7, ``ops/banded_cuda.py``: the CUDA
kernel on a card, its plain version on the CPU); the only traffic between
bands is the halo, the right edge of band k's call handed to band k + 1:
its top corner, its H column and, for affine specs, its E column
(B·R + 1 + B·R int32 for a call of B row blocks).

Schedule. A K7 call of a band holds C passes, its C·BL row strips
pipelined on the card in one launch; the last call of a pair may hold
fewer, and no call crosses a pair's edge. Call c of band k runs at step
c + k, each band on a stream of its own, and waits, through a CUDA event,
for call c of band k - 1 and for nothing else: its halo is that call's
right edge over the same rows (on the CPU the same order runs in one
thread). The call height changes no output. With D = 1 every halo is the
matrix's own left column, so each pair's band is one call; with D > 1,
``pick_call_passes`` trades the pipeline's depth (n_calls + D - 1 calls)
against a call's length (its strips' trail), and a band makes one launch
a call. ``fill_plan`` gives the whole layout and schedule (``FillPlan``:
the geometry below, each pair's passes, C and the calls a band), which
the engine, its callers and its reports share.

Processes. A mesh may span the processes of a torch.distributed group
(``parallel/mesh.py``): each process fills its own bands, the halo of
each call crosses a process edge over the group (gloo, staged through
pinned host memory on a card: a blocking send after the call's event, a
blocking receive, then a copy onto the receiving band's device; the halo
only flows rightward, so sends and receives in step order cannot
deadlock), and after the fill every process gathers every band's grids
(``all_gather``), as the JAX engine replicates its outputs, so that every
process stores, traces and hashes the same result.

Geometry is the JAX package's off-TPU branch, so the sparse layout
matches its engine tile for tile, padded tile rows included: R, TW, K
(``tileBy``, ``tileBx``, ``kChains``; 128, 128, 2 by default, and on a
card R and TW from its tuned cache, ``ops/tuned.py``, as the JAX engine
reads its TPU's), KB = ``passBlocks`` or ``pick_kb``, BL = KB·K,
band_cols = ⌈cols / (D·TW)⌉·TW and rows_p = n_pass·BL·R, padded with
letter 0. The TPU kernel levers (``packedx``, ``packedef``, ``rematHdr``,
``subProw``) are accepted and ignored.

Outputs are the reference sparse layout (``ops/mlsp_kernels._mlsp_store``,
with the affine F-row / E-column mats and the SW best cell, the global
row-major first maximum over every band), so the sparse trace and hash
run unchanged.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.types import (
    AlgInput,
    AlgParams,
    AlgResult,
    AlignKind,
    AlignSpec,
    GapKind,
    NEG_INF_I32,
    Status,
)
from ..ops import banded_cuda, tuned
from ..ops.mlsp_cuda import tile_best
from ..ops.mlsp_kernels import _mlsp_store, tile_headers
from ..ops.mlsp_plain import edge_col, edge_row
from .mesh import Mesh, default_mesh, synchronize_mesh

Bands = List[Dict[str, torch.Tensor]]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def wrap_ok(*, R: int, W: int, K: int, band_cols: int) -> bool:
    """The JAX package's hazard guard of its wrap echelon
    (``ops/pallas_wavefront2.py::wrap_ok``), kept because it decides
    ``pick_kb`` and the Status of an explicit ``passBlocks`` > 1."""
    NSpad = _cdiv(R + band_cols - 1 + 128, W) * W
    OFF = W * _cdiv(R + 256, W)
    return NSpad >= (K - 1) * OFF + R + W + 256


def pick_kb(n_blocks, K: int, D: int, *, R: int, W: int,
            band_cols: int, kb_max: int = 8) -> int:
    """Echelon groups per pass (pass height KB·K·R rows), by the JAX
    package's efficiency model of its TPU kernel, kept so that the port's
    passes and padded rows are the JAX engine's:
        [n_pass / (n_pass + D - 1)]        pipeline fill and drain
      * [KB*SPB / (KB*SPB + (K-1)*offw)]   echelon drain per pass
      / [padded-rows factor]               rows padded to n_pass*KB*K*R

    n_blocks: per-pair row-block count, an int or a sequence (a stream
    of pairs, whose padding accrues per pair).
    """
    nbs = [n_blocks] if isinstance(n_blocks, int) else list(n_blocks)
    if max(nbs) <= K or not wrap_ok(R=R, W=W, K=K, band_cols=band_cols):
        return 1
    NSpad = _cdiv(R + band_cols - 1 + 128, W) * W
    SPB = NSpad // W
    drain = (K - 1) * (W * _cdiv(R + 256, W)) // W
    nb_tot = sum(nbs)
    best_kb, best_eff = 1, 0.0
    for kb in range(1, kb_max + 1):
        n2 = sum(_cdiv(nb, K * kb) for nb in nbs)
        pad = (n2 * K * kb) / nb_tot
        eff = (n2 / (n2 + D - 1)) * (kb * SPB) / (kb * SPB + drain) / pad
        if eff > best_eff + 1e-9:
            best_kb, best_eff = kb, eff
    return best_kb


# The trail of one row strip of a K7 call behind the strip above it, in
# column steps: 156.9 (nw_lg) and 168.6 (nw_ag) on an NVIDIA H100 80GB
# HBM3 (PERF.md §5; ``bench/vpu_probe.py::probe_gridcost``, K1's strips,
# the loop K7 shares).
LAG_STEPS = 160


def call_model_steps(n_passes: Sequence[int], C: int, D: int, *, BL: int,
                     band_cols: int) -> int:
    """Column steps of the band pipeline with calls of C passes: a call
    sweeps its band's columns while its C·BL row strips trail one another
    by ``LAG_STEPS`` each, and band k's call c starts when band k - 1's
    call c is done, so the pipeline runs n_calls + D - 1 calls deep."""
    n_calls = sum(_cdiv(p, C) for p in n_passes)
    return (n_calls + D - 1) * (band_cols + (C * BL - 1) * LAG_STEPS)


def pick_call_passes(n_pass, D: int, *, BL: int, band_cols: int) -> int:
    """Passes a K7 call of a band holds (C): with D = 1 every halo is known
    in advance and a call is a whole pair; with D > 1 the C that
    minimizes ``call_model_steps`` (the smallest of equals). n_pass: the
    passes of a pair, an int, or a sequence for a stream of pairs."""
    nps = [n_pass] if isinstance(n_pass, int) else list(n_pass)
    if D == 1:
        return max(nps)
    return min(range(1, max(nps) + 1), key=lambda c: call_model_steps(
        nps, c, D, BL=BL, band_cols=band_cols))


class FillPlan(NamedTuple):
    """A fill's layout and schedule on D bands: row blocks of R rows,
    column tiles of TW, bands of ``band_cols`` columns, passes of BL
    blocks, ``n_pass[i]`` passes for pair i, and K7 calls of C passes."""

    D: int
    R: int
    TW: int
    band_cols: int
    BL: int
    n_pass: Tuple[int, ...]
    C: int

    @property
    def calls(self) -> int:
        """K7 calls a band makes: no call crosses a pair's edge."""
        return sum(_cdiv(p, self.C) for p in self.n_pass)

    @property
    def model_steps(self) -> int:
        return call_model_steps(self.n_pass, self.C, self.D, BL=self.BL,
                                band_cols=self.band_cols)

    def pad(self, y: np.ndarray, x: np.ndarray, i: int = 0
            ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Pair i's letters (header element first) zero-padded to its
        passes' rows and to the D bands' columns, on the host."""
        yp = np.zeros(1 + self.n_pass[i] * self.BL * self.R, np.int32)
        xp = np.zeros(1 + self.D * self.band_cols, np.int32)
        yp[:len(y)] = y
        xp[:len(x)] = x
        return torch.from_numpy(yp), torch.from_numpy(xp)


def schedule(D: int, R: int, TW: int, band_cols: int, BL: int,
             n_pass: Sequence[int]) -> FillPlan:
    """The plan of a given geometry, its call height from
    ``pick_call_passes``."""
    n_pass = tuple(n_pass)
    return FillPlan(D, R, TW, band_cols, BL, n_pass, pick_call_passes(
        n_pass, D, BL=BL, band_cols=band_cols))


def fill_plan(pr: AlgParams, rows: Sequence[int], cols: Sequence[int],
              D: int, spec: Optional[AlignSpec] = None,
              device: Optional[torch.device] = None) -> Optional[FillPlan]:
    """The engine's plan for pairs of ``rows`` x ``cols`` residues on D
    bands (``band_geometry``, then ``schedule``), or None for an invalid
    param combination."""
    geo = band_geometry(pr, rows, cols, D, spec, device)
    if geo is None:
        return None
    R, TW, band_cols, BL = geo
    return schedule(D, R, TW, band_cols, BL,
                    [_cdiv(_cdiv(max(r, 1), R), BL) for r in rows])


def _tile_params(pr: AlgParams, spec: Optional[AlignSpec] = None,
                 device: Optional[torch.device] = None
                 ) -> Tuple[int, int, int]:
    """(R, TW, K): explicit params beat the card's tuned cache (its
    ``banded`` sub-entry, then the spec's own tile; read for a spec on a
    CUDA device, and kept only where ``_tile_params_ok`` takes it), which
    beats the JAX package's off-TPU defaults 128, 128, 2."""
    r_def, tw_def, k_def = 128, 128, 2
    if spec is not None and device is not None:
        r, tw = tuned.tuned_tile(spec.name, device, (r_def, tw_def),
                                 banded=True)
        if _tile_params_ok(r, tw, k_def):
            r_def, tw_def = r, tw
    R = int(pr.get("tileBy", 0) or r_def)
    TW = int(pr.get("tileBx", 0) or tw_def)
    K = int(pr.get("kChains", 0) or k_def)
    return R, TW, K


def _tile_params_ok(R: int, TW: int, K: int) -> bool:
    """The geometry the JAX engine runs (tiles of positive multiples of
    128); any other is an invalid param combination there, and so here."""
    return (R >= 128 and R % 128 == 0 and TW >= 128 and TW % 128 == 0
            and K >= 1)


def band_geometry(pr: AlgParams, rows: Sequence[int],
                  cols: Sequence[int], D: int,
                  spec: Optional[AlignSpec] = None,
                  device: Optional[torch.device] = None
                  ) -> Optional[Tuple[int, int, int, int]]:
    """(R, TW, band_cols, BL) for pairs of ``rows`` x ``cols`` residues on
    D bands, or None for an invalid param combination. With ``spec`` and
    the first band's ``device`` the tile defaults come from the card's
    tuned cache (``_tile_params``)."""
    R, TW, K = _tile_params(pr, spec, device)
    if not _tile_params_ok(R, TW, K):
        return None
    W = min(512, TW)
    band_cols = _cdiv(max(max(cols), 1), D * TW) * TW
    KB = int(pr.get("passBlocks", 0) or 0)
    if KB > 1 and not wrap_ok(R=R, W=W, K=K, band_cols=band_cols):
        return None
    if not KB:
        KB = pick_kb([_cdiv(max(r, 1), R) for r in rows], K, D, R=R, W=W,
                     band_cols=band_cols)
    return R, TW, band_cols, KB * K


def giant2_fill(subst: torch.Tensor, ys: Sequence[torch.Tensor],
                xs: Sequence[torch.Tensor], gapo: int, gape: int,
                adjrs: Sequence[int], adjcs: Sequence[int], *, mesh: Mesh,
                plan: FillPlan, kind: str = "nw", gap: str = "linear"
                ) -> List[Bands]:
    """Banded fill of one pair or a stream of pairs over the mesh, laid
    out and scheduled by ``plan`` (its D the mesh's size).

    ys[i]: (1 + n_pass_i*BL*R,) pair i's row letters, header element
    first, zero-padded; xs[i]: (1 + D*band_cols,) its column letters
    likewise (``plan.pad``); adjrs/adjcs: the true lengths with the
    header. All pairs share the spec, costs and substitution matrix; over
    a mesh that spans processes every process passes the same inputs.
    Inputs are copied once to every distinct device of this process.

    Returns, per pair and per band of this process (band mesh.first + j
    on mesh.devices[j]), the band's header grids in ``banded_plain``'s
    layout over the pair's B = n_pass·BL row blocks: hrows/frows (B+1,
    1+band_cols), hcols/ecols (B, R, 1+band_cols/TW), and for SW "best"
    (calls, 3): each K7 call's best cell in the pair's coordinates (value
    0 where the call had none). The work is queued on the devices'
    current streams; nothing waits for it, except the sends of halos to
    the next process.
    """
    mesh.check_group()
    D, first, devs = mesh.size, mesh.first, mesh.devices
    if plan.D != D or len(plan.n_pass) != len(ys):
        raise ValueError(f"a plan of {plan.D} bands and {len(plan.n_pass)} "
                         f"pairs for {D} bands and {len(ys)} pairs")
    R, TW, band_cols, BL, n_pass, C = plan[1:]
    affine, is_sw = gap == "affine", kind == "sw"
    cuda = devs[0].type == "cuda"
    jtE = band_cols // TW
    kw = dict(tile_h=R, tile_w=TW, kind=kind, gap=gap)
    n = len(ys)
    calls = [(i, pl, min(C, n_pass[i] - pl))
             for i in range(n) for pl in range(0, n_pass[i], C)]
    i32 = dict(dtype=torch.int32)

    on = {dev: (subst.to(dev), [y.to(dev) for y in ys],
                [x.to(dev) for x in xs]) for dev in dict.fromkeys(devs)}
    hdr = edge_row(D * band_cols + 1, gapo, gape, kind, gap,
                   torch.device("cpu"))
    prev0 = [hdr[k * band_cols:(k + 1) * band_cols + 1].to(dev)
             for k, dev in enumerate(devs, first)]
    prevF0 = [torch.full((band_cols + 1,), NEG_INF_I32, **i32, device=dev)
              if affine else None for dev in devs]
    out = [[banded_cuda.alloc_band(n_pass[i] * BL, band_cols, R, TW, gap,
                                   dev) for dev in devs]
           for i in range(n)]
    bests = [[[] for _ in devs] for _ in range(n)]

    def left_edge(row0: int, rows: int):
        """Band 0's halo: the matrix's own left column; E there is -inf."""
        ii = torch.arange(row0, row0 + rows + 1, **i32, device=devs[0])
        h = edge_col(ii, gapo, gape, kind, gap)
        if row0 == 0:
            h[0] = 0  # H[0, 0]
        e = (torch.full((rows,), NEG_INF_I32, **i32, device=devs[0])
             if affine else None)
        return h, e

    def run(i: int, j: int, pl: int, nblk: int, haloH, haloE):
        """nblk row blocks of pair i's band first + j from pass pl on."""
        sub, yd, xd = on[devs[j]]
        row0, c0 = pl * BL * R, (first + j) * band_cols
        b0 = pl * BL
        grid = out[i][j]
        view = {name: t[b0:b0 + nblk + (name in ("hrows", "frows"))]
                for name, t in grid.items()}
        top = pl == 0
        got = banded_cuda.banded_pass(
            sub, yd[i][row0:row0 + nblk * R + 1],
            xd[i][c0:c0 + band_cols + 1], gapo, gape,
            prev0[j] if top else grid["hrows"][b0],
            (prevF0[j] if top else grid["frows"][b0]) if affine else None,
            haloH, haloE, adjrs[i] - row0, adjcs[i] - c0, out=view, **kw)
        if is_sw:
            best = got.pop("best").clone()
            best[1] += row0
            best[2] += c0
            bests[i][j].append(best)
        return view

    streams = [torch.cuda.Stream(dev) for dev in devs] if cuda else None
    if cuda:
        for dev, st in zip(devs, streams):
            st.wait_stream(torch.cuda.current_stream(dev))
    # Halo messages for the band to the right in this process, on its
    # device, and the events recorded after them, by call; each is
    # dropped once the reading stream has it queued (record_stream keeps
    # its memory until that stream is done).
    msgs = [{} for _ in devs]
    done = [{} for _ in devs]
    for t in range(len(calls) + D - 1):
        for j, k in enumerate(range(first, first + len(devs))):
            c = t - k
            if not 0 <= c < len(calls):
                continue
            i, pl, cnt = calls[c]
            rows = cnt * BL * R
            ctx = (torch.cuda.stream(streams[j]) if cuda
                   else contextlib.nullcontext())
            with ctx:
                if k == 0:
                    haloH, haloE = left_edge(pl * BL * R, rows)
                else:
                    if j == 0:  # the left band is the previous process's
                        msg = _recv_halo(rows + 1 + rows * affine,
                                         mesh.rank - 1, devs[0])
                    else:
                        msg = msgs[j - 1].pop(c)
                        if cuda:
                            streams[j].wait_event(done[j - 1].pop(c))
                            msg.record_stream(streams[j])
                    haloH = msg[:rows + 1]
                    haloE = msg[rows + 1:] if affine else None
                view = run(i, j, pl, cnt * BL, haloH, haloE)
                if k + 1 == D:
                    continue
                parts = [view["hrows"][0, band_cols:],
                         view["hcols"][:, :, jtE].reshape(-1)]
                if affine:
                    parts.append(view["ecols"][:, :, jtE].reshape(-1))
                msg = torch.cat(parts)
                if j + 1 == len(devs):
                    _send_halo(msg, mesh.rank + 1)
                    continue
                # A copy between cards runs here, on this band's stream.
                msgs[j][c] = msg.to(devs[j + 1])
                if cuda:
                    done[j][c] = torch.cuda.Event()
                    done[j][c].record(streams[j])
    if cuda:
        for dev, st in zip(devs, streams):
            torch.cuda.current_stream(dev).wait_stream(st)

    if is_sw:
        for i in range(n):
            for j in range(len(devs)):
                out[i][j]["best"] = torch.stack(bests[i][j])
    return out


def _send_halo(msg: torch.Tensor, dst: int) -> None:
    """A call's halo to the process ``dst`` holding the next band, once the
    call is done: through pinned host memory from a card."""
    import torch.distributed as dist

    if msg.device.type == "cuda":
        host = torch.empty(msg.numel(), dtype=torch.int32, pin_memory=True)
        host.copy_(msg, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record()
        ready.synchronize()
        msg = host
    dist.send(msg, dst)


def _recv_halo(size: int, src: int, dev: torch.device) -> torch.Tensor:
    """A call's halo of ``size`` values from the process ``src`` holding the
    band to the left, on ``dev`` (copied on its current stream)."""
    import torch.distributed as dist

    host = torch.empty(size, dtype=torch.int32,
                       pin_memory=dev.type == "cuda")
    dist.recv(host, src)
    return host.to(dev, non_blocking=True)


def replicate_bands(mesh: Mesh, bands: List[Dict[str, np.ndarray]]
                    ) -> List[Dict[str, np.ndarray]]:
    """One pair's band grids of this process (host arrays) as every band's,
    in band order, on every process of the mesh (``all_gather``: every
    band's grids have one shape). The bands themselves for a
    one-process mesh."""
    if mesh.processes == 1:
        return bands
    import torch.distributed as dist

    out = [{} for _ in range(mesh.size)]
    for name in bands[0]:
        local = torch.from_numpy(np.stack([b[name] for b in bands]))
        parts = [torch.empty_like(local) for _ in range(mesh.processes)]
        dist.all_gather(parts, local)
        for k, a in enumerate(torch.cat(parts).numpy()):
            out[k][name] = a
    return out


def gather_bands(bands: List[Dict[str, np.ndarray]], *, band_cols: int,
                 tile_w: int) -> Dict[str, np.ndarray]:
    """One pair's band grids (host arrays) as ``mlsp_fill``'s global
    layout over its B row blocks: hrows/frows (B, 1+D*band_cols), hcols/
    ecols (B, R, D*band_cols/tile_w), and for SW "best" (3,), the
    row-major first maximum over every band."""
    jtE = band_cols // tile_w
    B = bands[0]["hcols"].shape[0]
    out = {}
    for rows, cols in (("hrows", "hcols"), ("frows", "ecols")):
        if rows not in bands[0]:
            continue
        m = np.empty((B, 1 + len(bands) * band_cols), np.int32)
        m[:, 0] = bands[0][rows][:B, 0]
        for d, band in enumerate(bands):
            m[:, 1 + d * band_cols:1 + (d + 1) * band_cols] = \
                band[rows][:B, 1:]
        out[rows] = m
        # Column jt*TW of the pair is band jt // jtE's capture jt % jtE;
        # each band's capture 0 is the halo, the band to its left's edge.
        out[cols] = np.concatenate([band[cols][:, :, :jtE] for band in bands],
                                   axis=2)
    if "best" in bands[0]:
        cand = np.concatenate([band["best"] for band in bands])
        out["best"] = tile_best(torch.from_numpy(cand).view(1, -1, 3),
                                len(bands) * band_cols + 1)[0].numpy()
    return out


def _gathered_to_sparse(nw: AlgInput, res: AlgResult,
                        bands: List[Dict[str, np.ndarray]],
                        plan: FillPlan) -> Status:
    """One pair's band grids into the reference sparse layout, stored
    through ``_mlsp_store``. Shared by the single-pair engine and the
    stream."""
    g = gather_bands(bands, band_cols=plan.band_cols, tile_w=plan.TW)
    B, tcols = g["hcols"].shape[0], g["hcols"].shape[2]
    mats = tile_headers(g["hrows"], g["hcols"], plan.R, plan.TW, B, tcols,
                        frows=g.get("frows"), ecols=g.get("ecols"),
                        best=g.get("best"))
    return _mlsp_store(nw, res, mats, plan.R, plan.TW, B, tcols)


def _to_host(bands: Bands) -> List[Dict[str, np.ndarray]]:
    return [{k: v.cpu().numpy() for k, v in band.items()} for band in bands]


def align_giant2(pr: AlgParams, nw: AlgInput, res: AlgResult,
                 mesh: Optional[Mesh] = None) -> Status:
    """Registry-shaped align fn of the giant engine, any spec, over
    ``mesh`` (default: ``nw.device`` alone, D = 1; more bands take an
    explicit mesh, which may span processes: each process then passes the
    same pair and gets the same result): pads, runs the banded fill, and
    stores the reference sparse layout so that the sparse trace, hash and
    align_cost run unchanged."""
    spec = nw.spec
    affine = spec.gap == GapKind.AFFINE
    if affine and (nw.gapo_cost > 0 or nw.gape_cost > 0):
        return Status.errorInvalidValue  # the fill's Gotoh needs costs <= 0
    if mesh is None:
        mesh = default_mesh(nw.device)
    D = mesh.size

    sw = res.sw_align
    sw.start()
    plan = fill_plan(pr, [nw.adjrows - 1], [nw.adjcols - 1], D, spec,
                     mesh.devices[0])
    if plan is None:
        return Status.errorInvalidValue
    y, x = plan.pad(nw.seqY, nw.seqX)
    sw.lap("align.alloc")

    dev0 = mesh.devices[0]
    subst_d = torch.from_numpy(np.ascontiguousarray(nw.subst, np.int32)).to(
        dev0)
    y_d, x_d = y.to(dev0), x.to(dev0)
    synchronize_mesh(mesh)
    sw.lap("align.cpy_dev")

    out = giant2_fill(
        subst_d, [y_d], [x_d], nw.gapo_cost, nw.gape_cost, [nw.adjrows],
        [nw.adjcols], mesh=mesh, plan=plan, kind=spec.kind.value,
        gap=spec.gap.value)
    synchronize_mesh(mesh)
    sw.lap("align.calc")

    bands = _to_host(out[0])
    nw.note_device_alloc(sum(v.nbytes for b in bands for v in b.values()))
    bands = replicate_bands(mesh, bands)
    sw.lap("align.cpy_host")
    return _gathered_to_sparse(nw, res, bands, plan)


def align_giant2_stream(pr: AlgParams, inputs: "list[AlgInput]",
                        results: "list[AlgResult]",
                        mesh: Optional[Mesh] = None) -> "list[Status]":
    """Align a stream of giant pairs through one pipelined banded fill:
    with D > 1 the fill and drain of the band pipeline (D - 1 calls) is
    paid once per stream, not once per pair. The mesh may span processes,
    as ``align_giant2``'s. Every pair is padded to the
    widest pair's band, so at D = 1, with no pipeline to fill, one
    ``align_giant2`` call a pair does less work.

    All pairs must share spec, costs and substitution matrix; otherwise
    every pair gets errorInvalidValue. Each pair's AlgResult gets the
    standard sparse layout. The stopwatch laps are the shared phases'
    wall time, shared out in proportion to each pair's cells (their sum is
    the stream's wall time).
    """
    n = len(inputs)
    if n == 0:
        return []
    spec = inputs[0].spec
    gapo, gape = inputs[0].gapo_cost, inputs[0].gape_cost
    affine = spec.gap == GapKind.AFFINE
    uniform = all(
        nw.spec == spec and nw.gapo_cost == gapo and nw.gape_cost == gape
        and np.array_equal(nw.subst, inputs[0].subst)
        for nw in inputs[1:]
    )
    if not uniform or (affine and (gapo > 0 or gape > 0)):
        return [Status.errorInvalidValue] * n
    if mesh is None:
        mesh = default_mesh(inputs[0].device)
    D = mesh.size

    cells = np.array(
        [(nw.adjrows - 1) * (nw.adjcols - 1) for nw in inputs], np.float64)
    share = cells / max(float(cells.sum()), 1.0)
    t_ref = time.perf_counter()

    def lap_all(name: str) -> None:
        nonlocal t_ref
        now = time.perf_counter()
        for res_i, sh in zip(results, share):
            res_i.sw_align.add_ms(name, (now - t_ref) * 1e3 * float(sh))
        t_ref = now

    plan = fill_plan(pr, [nw.adjrows - 1 for nw in inputs],
                     [nw.adjcols - 1 for nw in inputs], D, spec,
                     mesh.devices[0])
    if plan is None:
        return [Status.errorInvalidValue] * n
    padded = [plan.pad(nw.seqY, nw.seqX, i) for i, nw in enumerate(inputs)]
    lap_all("align.alloc")

    dev0 = mesh.devices[0]
    subst_d = torch.from_numpy(
        np.ascontiguousarray(inputs[0].subst, np.int32)).to(dev0)
    ys = [y.to(dev0) for y, _ in padded]
    xs = [x.to(dev0) for _, x in padded]
    synchronize_mesh(mesh)
    lap_all("align.cpy_dev")

    out = giant2_fill(
        subst_d, ys, xs, gapo, gape, [nw.adjrows for nw in inputs],
        [nw.adjcols for nw in inputs], mesh=mesh, plan=plan,
        kind=spec.kind.value, gap=spec.gap.value)
    synchronize_mesh(mesh)
    lap_all("align.calc")

    host = [_to_host(bands) for bands in out]
    for nw, bands in zip(inputs, host):
        nw.note_device_alloc(sum(v.nbytes for b in bands for v in b.values()))
    host = [replicate_bands(mesh, bands) for bands in host]
    lap_all("align.cpy_host")

    stats = []
    for nw, res, bands in zip(inputs, results, host):
        stats.append(_gathered_to_sparse(nw, res, bands, plan))
    return stats


def align_giant2_nw_lg(pr: AlgParams, nw: AlgInput, res: AlgResult,
                       mesh: Optional[Mesh] = None) -> Status:
    """The original NW linear-gap-only surface."""
    if not (nw.spec.kind == AlignKind.NW and nw.spec.gap == GapKind.LINEAR):
        return Status.errorInvalidValue
    return align_giant2(pr, nw, res, mesh=mesh)

"""Giant-pair engine: one pair's columns split into bands, every spec.

Port of gpuseqalign_tpu's ``parallel/giant2.py``. The columns of one
giant pair (or of a stream of pairs) are split into D bands of
``band_cols`` columns, one per entry of a mesh (``parallel/mesh.py``),
and rows advance in passes of BL row blocks of R rows. Band k fills its
columns with the banded pass (K7, ``ops/banded_cuda.py``: the CUDA
kernel on a card, its plain version on the CPU); the only traffic between
bands is the halo, the right edge of band k's pass handed to band k + 1:
its top corner, its H column and, for affine specs, its E column
(B·R + 1 + B·R int32).

Schedule. With D > 1, pass t - k of band k runs at step t, each band on a
stream of its own, and the halo copy into band k + 1's device waits on a
CUDA event recorded after band k's pass (on the CPU the same order runs
in one thread). The pass height changes no output, so with D = 1, where
every halo is the matrix's own left column, each pair's band is one K7
call. Every K7 call is one launch (its row strips pipelined on the card),
so D > 1 costs one launch a pass.

Geometry is the JAX package's off-TPU branch, so the sparse layout
matches its engine tile for tile, padded tile rows included: R, TW, K
(``tileBy``, ``tileBx``, ``kChains``; 128, 128, 2 by default), KB =
``passBlocks`` or ``pick_kb``, BL = KB·K, band_cols = ⌈cols / (D·TW)⌉·TW
and rows_p = n_pass·BL·R, padded with letter 0. The TPU kernel levers
(``packedx``, ``packedef``, ``rematHdr``, ``subProw``) are accepted and
ignored, and the TPU's tuned cache has no counterpart.

Outputs are the reference sparse layout (``ops/mlsp_kernels._mlsp_store``,
with the affine F-row / E-column mats and the SW best cell, the global
row-major first maximum over every band), so the sparse trace and hash
run unchanged.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.types import (
    AlgInput,
    AlgParams,
    AlgResult,
    AlignKind,
    GapKind,
    NEG_INF_I32,
    Status,
)
from ..ops import banded_cuda
from ..ops.mlsp_cuda import tile_best
from ..ops.mlsp_kernels import _mlsp_store
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


def _tile_params(pr: AlgParams) -> Tuple[int, int, int]:
    """(R, TW, K): explicit params, else the JAX package's off-TPU
    defaults 128, 128, 2."""
    R = int(pr.get("tileBy", 0) or 128)
    TW = int(pr.get("tileBx", 0) or 128)
    K = int(pr.get("kChains", 0) or 2)
    return R, TW, K


def _tile_params_ok(R: int, TW: int, K: int) -> bool:
    """The geometry the JAX engine runs (tiles of positive multiples of
    128); any other is an invalid param combination there, and so here."""
    return (R >= 128 and R % 128 == 0 and TW >= 128 and TW % 128 == 0
            and K >= 1)


def band_geometry(pr: AlgParams, rows: Sequence[int],
                  cols: Sequence[int], D: int
                  ) -> Optional[Tuple[int, int, int, int]]:
    """(R, TW, band_cols, BL) for pairs of ``rows`` x ``cols`` residues on
    D bands, or None for an invalid param combination."""
    R, TW, K = _tile_params(pr)
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
                R: int, TW: int, band_cols: int, BL: int, kind: str = "nw",
                gap: str = "linear") -> List[Bands]:
    """Banded fill of one pair or a stream of pairs over the mesh.

    ys[i]: (1 + n_pass_i*BL*R,) pair i's row letters, header element
    first, zero-padded; xs[i]: (1 + D*band_cols,) its column letters
    likewise; adjrs/adjcs: the true lengths with the header. All pairs
    share the spec, costs and substitution matrix. Inputs are copied once
    to every distinct device of the mesh.

    Returns, per pair and per band k (on mesh.devices[k]), the band's
    header grids in ``banded_plain``'s layout over the pair's B = n_pass·
    BL row blocks: hrows/frows (B+1, 1+band_cols), hcols/ecols (B, R,
    1+band_cols/TW), and for SW "best" (calls, 3): each K7 call's best
    cell in the pair's coordinates (value 0 where the call had none). The
    work is queued on the devices' current streams; nothing waits for it.
    """
    D = mesh.size
    devs = mesh.devices
    affine, is_sw = gap == "affine", kind == "sw"
    jtE = band_cols // TW
    kw = dict(tile_h=R, tile_w=TW, kind=kind, gap=gap)
    n = len(ys)
    n_pass = [(y.numel() - 1) // (BL * R) for y in ys]
    i32 = dict(dtype=torch.int32)

    on = {dev: (subst.to(dev), [y.to(dev) for y in ys],
                [x.to(dev) for x in xs]) for dev in dict.fromkeys(devs)}
    hdr = edge_row(D * band_cols + 1, gapo, gape, kind, gap,
                   torch.device("cpu"))
    prev0 = [hdr[k * band_cols:(k + 1) * band_cols + 1].to(devs[k])
             for k in range(D)]
    prevF0 = [torch.full((band_cols + 1,), NEG_INF_I32, **i32, device=dev)
              if affine else None for dev in devs]
    out = [[banded_cuda.alloc_band(n_pass[i] * BL, band_cols, R, TW, gap,
                                   devs[k]) for k in range(D)]
           for i in range(n)]
    bests = [[[] for _ in range(D)] for _ in range(n)]

    def left_edge(row0: int, rows: int):
        """Band 0's halo: the matrix's own left column; E there is -inf."""
        ii = torch.arange(row0, row0 + rows + 1, **i32, device=devs[0])
        h = edge_col(ii, gapo, gape, kind, gap)
        if row0 == 0:
            h[0] = 0  # H[0, 0]
        e = (torch.full((rows,), NEG_INF_I32, **i32, device=devs[0])
             if affine else None)
        return h, e

    def run(i: int, k: int, pl: int, nblk: int, haloH, haloE):
        """nblk row blocks of pair i's band k from pass pl on."""
        sub, yd, xd = on[devs[k]]
        row0, c0 = pl * BL * R, k * band_cols
        b0 = pl * BL
        grid = out[i][k]
        view = {name: t[b0:b0 + nblk + (name in ("hrows", "frows"))]
                for name, t in grid.items()}
        top = pl == 0
        got = banded_cuda.banded_pass(
            sub, yd[i][row0:row0 + nblk * R + 1],
            xd[i][c0:c0 + band_cols + 1], gapo, gape,
            prev0[k] if top else grid["hrows"][b0],
            (prevF0[k] if top else grid["frows"][b0]) if affine else None,
            haloH, haloE, adjrs[i] - row0, adjcs[i] - c0, out=view, **kw)
        if is_sw:
            best = got.pop("best").clone()
            best[1] += row0
            best[2] += c0
            bests[i][k].append(best)
        return view

    if D == 1:
        for i in range(n):
            run(i, 0, 0, n_pass[i] * BL, *left_edge(0, n_pass[i] * BL * R))
    else:
        passes = [(i, pl) for i in range(n) for pl in range(n_pass[i])]
        cuda = devs[0].type == "cuda"
        streams = [torch.cuda.Stream(dev) for dev in devs] if cuda else None
        if cuda:
            for dev, s in zip(devs, streams):
                s.wait_stream(torch.cuda.current_stream(dev))
        # Halo messages and their events, kept until every band is done.
        msgs = [[None] * len(passes) for _ in range(D)]
        done = [[None] * len(passes) for _ in range(D)]
        for t in range(len(passes) + D - 1):
            for k in range(D):
                p = t - k
                if not 0 <= p < len(passes):
                    continue
                i, pl = passes[p]
                ctx = (torch.cuda.stream(streams[k]) if cuda
                       else contextlib.nullcontext())
                with ctx:
                    if k == 0:
                        haloH, haloE = left_edge(pl * BL * R, BL * R)
                    else:
                        if cuda:
                            streams[k].wait_event(done[k - 1][p])
                        msg = msgs[k - 1][p].to(devs[k])
                        haloH = msg[:BL * R + 1]
                        haloE = msg[BL * R + 1:] if affine else None
                    view = run(i, k, pl, BL, haloH, haloE)
                    if k + 1 < D:
                        parts = [view["hrows"][0, band_cols:],
                                 view["hcols"][:, :, jtE].reshape(-1)]
                        if affine:
                            parts.append(view["ecols"][:, :, jtE].reshape(-1))
                        msgs[k][p] = torch.cat(parts)
                    if cuda:
                        done[k][p] = torch.cuda.Event()
                        done[k][p].record(streams[k])
        if cuda:
            for dev, s in zip(devs, streams):
                torch.cuda.current_stream(dev).wait_stream(s)

    if is_sw:
        for i in range(n):
            for k in range(D):
                out[i][k]["best"] = torch.stack(bests[i][k])
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
                        bands: List[Dict[str, np.ndarray]], *, R: int,
                        TW: int, band_cols: int) -> Status:
    """One pair's band grids into the reference sparse layout, stored
    through ``_mlsp_store``. Shared by the single-pair engine and the
    stream."""
    g = gather_bands(bands, band_cols=band_cols, tile_w=TW)
    B, tcols = g["hcols"].shape[0], g["hcols"].shape[2]
    return _mlsp_store(nw, res, g["hrows"], g["hcols"], R, TW, B, tcols,
                       frows=g.get("frows"), ecols=g.get("ecols"),
                       best=g.get("best"))


def _pad_pair(nw: AlgInput, rows_p: int, cols_p: int):
    y = np.zeros(1 + rows_p, np.int32)
    x = np.zeros(1 + cols_p, np.int32)
    y[: nw.adjrows] = nw.seqY
    x[: nw.adjcols] = nw.seqX
    return torch.from_numpy(y), torch.from_numpy(x)


def _to_host(bands: Bands) -> List[Dict[str, np.ndarray]]:
    return [{k: v.cpu().numpy() for k, v in band.items()} for band in bands]


def align_giant2(pr: AlgParams, nw: AlgInput, res: AlgResult,
                 mesh: Optional[Mesh] = None) -> Status:
    """Registry-shaped align fn of the giant engine, any spec, over
    ``mesh`` (default: ``nw.device`` alone, D = 1; more bands take an
    explicit mesh): pads, runs the banded fill, and stores the reference
    sparse layout so that the sparse trace, hash and align_cost run
    unchanged."""
    spec = nw.spec
    affine = spec.gap == GapKind.AFFINE
    if affine and (nw.gapo_cost > 0 or nw.gape_cost > 0):
        return Status.errorInvalidValue  # the fill's Gotoh needs costs <= 0
    if mesh is None:
        mesh = default_mesh(nw.device)
    D = mesh.size

    sw = res.sw_align
    sw.start()
    geo = band_geometry(pr, [nw.adjrows - 1], [nw.adjcols - 1], D)
    if geo is None:
        return Status.errorInvalidValue
    R, TW, band_cols, BL = geo
    n_pass = _cdiv(_cdiv(max(nw.adjrows - 1, 1), R), BL)
    y, x = _pad_pair(nw, n_pass * BL * R, D * band_cols)
    sw.lap("align.alloc")

    dev0 = mesh.devices[0]
    subst_d = torch.from_numpy(np.ascontiguousarray(nw.subst, np.int32)).to(
        dev0)
    y_d, x_d = y.to(dev0), x.to(dev0)
    synchronize_mesh(mesh)
    sw.lap("align.cpy_dev")

    out = giant2_fill(
        subst_d, [y_d], [x_d], nw.gapo_cost, nw.gape_cost, [nw.adjrows],
        [nw.adjcols], mesh=mesh, R=R, TW=TW, band_cols=band_cols, BL=BL,
        kind=spec.kind.value, gap=spec.gap.value)
    synchronize_mesh(mesh)
    sw.lap("align.calc")

    bands = _to_host(out[0])
    sw.lap("align.cpy_host")
    nw.note_device_alloc(sum(v.nbytes for b in bands for v in b.values()))
    return _gathered_to_sparse(nw, res, bands, R=R, TW=TW,
                               band_cols=band_cols)


def align_giant2_stream(pr: AlgParams, inputs: "list[AlgInput]",
                        results: "list[AlgResult]",
                        mesh: Optional[Mesh] = None) -> "list[Status]":
    """Align a stream of giant pairs through one pipelined banded fill:
    with D > 1 the fill and drain of the band pipeline (D - 1 steps) is
    paid once per stream, not once per pair. Every pair is padded to the
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

    geo = band_geometry(pr, [nw.adjrows - 1 for nw in inputs],
                    [nw.adjcols - 1 for nw in inputs], D)
    if geo is None:
        return [Status.errorInvalidValue] * n
    R, TW, band_cols, BL = geo
    np_l = [_cdiv(_cdiv(max(nw.adjrows - 1, 1), R), BL) for nw in inputs]
    padded = [_pad_pair(nw, p * BL * R, D * band_cols)
              for nw, p in zip(inputs, np_l)]
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
        [nw.adjcols for nw in inputs], mesh=mesh, R=R, TW=TW,
        band_cols=band_cols, BL=BL, kind=spec.kind.value,
        gap=spec.gap.value)
    synchronize_mesh(mesh)
    lap_all("align.calc")

    host = [_to_host(bands) for bands in out]
    lap_all("align.cpy_host")

    stats = []
    for nw, res, bands in zip(inputs, results, host):
        nw.note_device_alloc(sum(v.nbytes for b in bands for v in b.values()))
        stats.append(_gathered_to_sparse(nw, res, bands, R=R, TW=TW,
                                         band_cols=band_cols))
    return stats


def align_giant2_nw_lg(pr: AlgParams, nw: AlgInput, res: AlgResult,
                       mesh: Optional[Mesh] = None) -> Status:
    """The original NW linear-gap-only surface."""
    if not (nw.spec.kind == AlignKind.NW and nw.spec.gap == GapKind.LINEAR):
        return Status.errorInvalidValue
    return align_giant2(pr, nw, res, mesh=mesh)

"""Skew/unskew transforms between anti-diagonals and rows, by pad and
reshape only (no gathers).

PyTorch port of gpuseqalign_tpu's ``ops/skew.py`` (``skew_rows``,
``unskew_rows``), which the anti-diagonal dense fill
(``dense_plain.diag_dense``) uses to read its substitution profile one
contiguous row per step and to turn its per-diagonal output back into
matrix rows.

Skew: given P (R, C), S (R+C-1, C) holds S[d, j] = P[d-j, j] wherever
0 <= d-j < R (other entries are junk that callers mask). With fc the
column-major flattening of P padded to Rp = R+C rows,
fc[j*Rp + i] = Ppad[i, j], so S[d, j] = fc[j*(Rp-1) + d]: S^T is fc
reshaped with row stride Rp-1.

Unskew: given S (NS, C) holding S[d, j] = H[d-j, j], H (R, C) is
H[i, j] = S[i+j, j]. With fc the column-major flattening of S padded to
NSp = NS+1 rows, H[i, j] = fc[j*(NSp+1) + i].
"""

from __future__ import annotations

import torch


def skew_rows(P: torch.Tensor) -> torch.Tensor:
    """S[d, j] = P[d-j, j]; S (R+C-1, C); junk where d-j is outside [0, R)."""
    R, C = P.shape
    Rp = R + C
    Ppad = torch.cat([P, P.new_zeros(Rp - R, C)])
    fc = Ppad.t().reshape(-1)  # fc[j*Rp + i] = Ppad[i, j]
    T = fc[: C * (Rp - 1)].reshape(C, Rp - 1)  # T[j, d] = fc[j*(Rp-1)+d]
    return T[:, : R + C - 1].t().contiguous()


def unskew_rows(S: torch.Tensor, R: int) -> torch.Tensor:
    """H[i, j] = S[i+j, j]; S (NS, C) with NS >= R+C-1; H (R, C)."""
    NS, C = S.shape
    NSp = NS + 1
    fc = torch.cat([S, S.new_zeros(1, C)]).t().reshape(-1)  # fc[j*NSp + d]
    fc = torch.cat([fc, fc.new_zeros(C * (NSp + 1) - fc.numel())])
    T = fc.reshape(C, NSp + 1)  # T[j, i] = fc[j*(NSp+1)+i]
    return T[:, :R].t().contiguous()

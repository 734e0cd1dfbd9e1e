# Frozen copy of blasr_tpu_torch/kernels/sdp.py: the plain PyTorch path only,
# imports pointed inside benchmark/reference (see __init__.py).
"""Sparse dynamic programming (port of ``blasr_tpu/kernels/sdp.py``): the
short-tuple SDP fragment search of the band guide,
``window_fragment_diags_banded`` (its plain version, on any device)."""

from __future__ import annotations

import torch

from benchmark.reference.anchor import read_kmer_keys
from benchmark.reference.dispatch import per_distinct_row

_CHUNK = 32  # diagonals compared per vectorized step
INVALID_WINDOW = 0xFFFFFFFF   # key of a window position without a k-mer
INVALID_READ = 0xFFFFFFFE     # key of a read position without a k-mer


def _diag_lo(offs, L: int, W: int, D: int, w_b: int) -> torch.Tensor:
    """First diagonal of each row's D-diagonal slab (int64 [N]), centred
    on the guide path and clamped to [-(L + D), W]."""
    q = torch.arange(L, dtype=torch.int64, device=offs.device)[None, :]
    diag_c = offs.to(torch.int64) + (w_b // 2) - q
    dmin = diag_c.amin(dim=1)
    dmax = diag_c.amax(dim=1)
    return ((dmin + dmax) // 2 - D // 2).clamp(-(L + D), W)


def window_fragment_diags_banded(rkeys, rvalid, windows, wlens, offs, *,
                                 k: int, occ: int, D: int = 512,
                                 w_b: int = 128):
    """The D-diagonal fragment search
    (:func:`window_fragment_diags_banded_plain`)."""
    return window_fragment_diags_banded_plain(
        rkeys, rvalid, windows, wlens, offs, k=k, occ=occ, D=D, w_b=w_b)


def window_fragment_diags_banded_plain(rkeys, rvalid, windows, wlens, offs,
                                       *, k: int, occ: int, D: int = 512,
                                       w_b: int = 128):
    """For every query position, the first ``occ`` (1 or 2) diagonals of a
    D-diagonal slab centred on the guide path whose window k-mer equals the
    read's.  Returns (diag = w_pos - q_pos in window coords, valid), each
    [N, L, occ].

    The JAX loop walks the slab one diagonal at a time and keeps the first
    and second hit per position; here a chunk of diagonals is compared at
    once and the running hit count picks the same two diagonals, once per
    distinct row (``per_distinct_row``)."""
    assert occ in (1, 2), occ
    return per_distinct_row(
        lambda *rows: _fragment_diags_rows(*rows, k=k, occ=occ, D=D,
                                           w_b=w_b),
        rkeys, rvalid, windows, wlens, offs)


def _fragment_diags_rows(rkeys, rvalid, windows, wlens, offs, *, k, occ, D,
                         w_b):
    dev = rkeys.device
    i64 = torch.int64
    N, L = rkeys.shape
    W = windows.shape[1]
    wkeys, wval = read_kmer_keys(windows, wlens, k)
    wkey_m = torch.where(wval, wkeys, INVALID_WINDOW)
    dlo = _diag_lo(offs, L, W, D, w_b)

    PAD = L + D
    pad = torch.full((N, PAD), INVALID_WINDOW, dtype=i64, device=dev)
    wpad = torch.cat([pad, wkey_m, pad], dim=1)
    start = (dlo + PAD).clamp(0, wpad.shape[1] - (L + D))
    wslice = wpad.gather(
        1, start[:, None] + torch.arange(L + D, device=dev)[None, :])
    rk_m = torch.where(rvalid, rkeys, INVALID_READ)

    hits = torch.zeros((N, L), dtype=torch.int32, device=dev)
    d0 = torch.zeros((N, L), dtype=i64, device=dev)
    d1 = torch.zeros((N, L), dtype=i64, device=dev)
    for s0 in range(0, D, _CHUNK):
        S = min(_CHUNK, D - s0)
        cols = wslice.unfold(1, L, 1)[:, s0:s0 + S]          # [N, S, L]
        eq = rk_m[:, None, :] == cols
        cum = hits[:, None, :] + torch.cumsum(eq.to(torch.int32), dim=1,
                                                dtype=torch.int32)
        for nth, d in ((1, d0), (2, d1)):
            if nth > occ:
                break
            at = eq & (cum == nth)
            got = at.any(dim=1)
            first = torch.argmax(at.to(torch.int8), dim=1)   # first hit
            d.copy_(torch.where(got, dlo[:, None] + s0 + first, d))
        hits = cum[:, -1]
    v0 = hits >= 1
    if occ == 1:
        return d0[:, :, None], v0[:, :, None]
    return (torch.stack([d0, d1], dim=2),
            torch.stack([v0, hits >= 2], dim=2))

"""Short-tuple SDP fragment search for the band guide (port of
``blasr_tpu/kernels/sdp.py::window_fragment_diags_banded``), plain
PyTorch.  The sort-based ``window_fragment_diags`` and ``sdp_align``
(``sdpMatcher``) are not ported."""

from __future__ import annotations

import torch

from blasr_tpu_torch.kernels.anchor import read_kmer_keys

_CHUNK = 32  # diagonals compared per vectorized step


def window_fragment_diags_banded(rkeys, rvalid, windows, wlens, offs, *,
                                 k: int, occ: int, D: int = 512,
                                 w_b: int = 128):
    """For every query position, the first ``occ`` (1 or 2) diagonals of a
    D-diagonal slab centred on the guide path whose window k-mer equals the
    read's.  Returns (diag = w_pos - q_pos in window coords, valid), each
    [N, L, occ].

    The JAX loop walks the slab one diagonal at a time and keeps the first
    and second hit per position; here a chunk of diagonals is compared at
    once and the running hit count picks the same two diagonals."""
    assert occ in (1, 2), occ
    dev = rkeys.device
    i64 = torch.int64
    N, L = rkeys.shape
    W = windows.shape[1]
    INVALID = 0xFFFFFFFF
    wkeys, wval = read_kmer_keys(windows, wlens, k)
    wkey_m = torch.where(wval, wkeys, INVALID)

    q = torch.arange(L, dtype=i64, device=dev)[None, :]
    diag_c = offs.to(i64) + (w_b // 2) - q
    dmin = diag_c.amin(dim=1)
    dmax = diag_c.amax(dim=1)
    dlo = ((dmin + dmax) // 2 - D // 2).clamp(-(L + D), W)

    PAD = L + D
    pad = torch.full((N, PAD), INVALID, dtype=i64, device=dev)
    wpad = torch.cat([pad, wkey_m, pad], dim=1)
    start = (dlo + PAD).clamp(0, wpad.shape[1] - (L + D))
    wslice = wpad.gather(
        1, start[:, None] + torch.arange(L + D, device=dev)[None, :])
    rk_m = torch.where(rvalid, rkeys, 0xFFFFFFFE)

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

"""Sparse dynamic programming (port of ``blasr_tpu/kernels/sdp.py``): the
short-tuple SDP fragment search of the band guide and the pairwise SDP
skeleton of ``sdpMatcher``.

``window_fragment_diags_banded`` dispatches on the device of its inputs:
CUDA tensors go to K4 (``csrc/sdp_window.cu``, the whole function in one
launch), CPU tensors to ``window_fragment_diags_banded_plain``.

``sdp_align`` matches k-mer fragments by a stable sort and two
searchsorted passes (plain PyTorch, as the JAX function is plain XLA),
keeps the first ``max_frags``, and chains them with ``chain_anchors`` and
``chain_members``: K3 and K7 on CUDA tensors.  The sort-based
``window_fragment_diags`` is not ported (the mapper never calls it)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from blasr_tpu_torch.kernels.anchor import Anchors, read_kmer_keys
from blasr_tpu_torch.kernels.chain import (BIG, chain_anchors,
                                           chain_members)
from blasr_tpu_torch.kernels.dispatch import on_device, per_distinct_row

_CHUNK = 32  # diagonals compared per vectorized step
INVALID_WINDOW = 0xFFFFFFFF   # key of a window position without a k-mer
INVALID_READ = 0xFFFFFFFE     # key of a read position without a k-mer


class SDPResult(NamedTuple):
    """Best fragment chain per pair (the SDP alignment skeleton)."""

    q_start: torch.Tensor   # int64 [N]
    q_end: torch.Tensor     # int64 [N] exclusive
    t_start: torch.Tensor   # int64 [N]
    t_end: torch.Tensor     # int64 [N] exclusive
    score: torch.Tensor     # float32 [N] chained fragment bases
    n_frags: torch.Tensor   # int64 [N] fragments in the chain
    valid: torch.Tensor     # bool [N]
    mq: torch.Tensor        # int64 [N, max_chain] chain fragment q (BIG pad)
    mt: torch.Tensor        # int64 [N, max_chain] chain fragment t
    ml: torch.Tensor        # int64 [N, max_chain] fragment length


def sdp_align(queries, qlens, targets, tlens, *, k: int = 11,
              occ_per_pos: int = 4, max_frags: int = 1024,
              max_chain: int = 256, global_align: bool = True) -> SDPResult:
    """The JAX ``sdp_align`` on int8 queries [N, Lq] and targets [N, Lt]
    with their lengths [N]: k-mer fragments matched between each pair,
    the first ``max_frags`` (by query position, then occurrence) chained
    by the anchor chain DP, and, with ``global_align``, the chain's span
    extended to the whole query along its end diagonals.  Keys are int64
    holding the uint32 patterns, 0xFFFFFFFF where a target position has
    no k-mer."""
    N, Lq = queries.shape
    Lt = targets.shape[1]
    O = occ_per_pos
    dev = queries.device

    # --- fragment match
    tkeys, tval = read_kmer_keys(targets, tlens, k)          # [N, Lt]
    tkey_m = torch.where(tval, tkeys, INVALID_WINDOW)
    t_order = torch.argsort(tkey_m, dim=1, stable=True)
    t_sorted = tkey_m.gather(1, t_order)
    qkeys, qval = read_kmer_keys(queries, qlens, k)          # [N, Lq]
    lo = torch.searchsorted(t_sorted, qkeys, side="left")
    hi = torch.searchsorted(t_sorted, qkeys, side="right")
    occ = torch.arange(O, device=dev)
    idx = (lo[:, :, None] + occ).clamp(0, Lt - 1)
    fvalid = qval[:, :, None] & (occ < (hi - lo)[:, :, None])
    flat_t = t_order.gather(1, idx.reshape(N, Lq * O))
    flat_q = torch.arange(Lq, device=dev).repeat_interleave(O)[None, :] \
        .expand(N, Lq * O)
    flat_v = fvalid.reshape(N, Lq * O)

    # the first max_frags fragments (by q, then occurrence)
    rank = torch.where(flat_v, torch.arange(Lq * O, device=dev), BIG)
    order = torch.argsort(rank, dim=1, stable=True)[:, :max_frags]
    sel_q = flat_q.gather(1, order)
    sel_t = flat_t.gather(1, order)
    sel_v = flat_v.gather(1, order)

    # t-sorted fragment list (the chain DP expects t order)
    order2 = torch.argsort(torch.where(sel_v, sel_t, BIG), dim=1,
                           stable=True)
    fq = sel_q.gather(1, order2)
    ft = sel_t.gather(1, order2)
    fv = sel_v.gather(1, order2)
    anchors = Anchors(
        q=fq, t=ft, l=torch.where(fv, k, 0), valid=fv,
        n_total=fv.sum(dim=1).to(torch.int32),
        nlogp=torch.where(fv, float(k), 0.0).to(torch.float32))

    # --- chain: the whole target span as the "read length", so a chain
    # may span the whole window
    span = torch.maximum(qlens, tlens)
    cands = chain_anchors(anchors, span, n_cand=1, indel_rate=1.0)
    mq, mt, ml, _ = chain_members(cands, anchors, max_chain=max_chain)

    qs = cands.q_start[:, 0]
    qe = cands.q_end[:, 0]
    ts = cands.t_start[:, 0]
    te = cands.t_end[:, 0]
    if global_align:
        # anchor to the full query: extend the span to the sequence ends
        # along the end diagonals (clamped to the target)
        qlens64 = qlens.to(torch.int64)
        ts = (ts - qs).clamp(min=0)
        te = torch.minimum(te + (qlens64 - qe), tlens.to(torch.int64))
        qs = torch.zeros_like(qs)
        qe = qlens64
    return SDPResult(
        q_start=qs, q_end=qe, t_start=ts, t_end=te,
        score=cands.score[:, 0], n_frags=cands.n_anchors[:, 0],
        valid=cands.valid[:, 0], mq=mq[:, 0], mt=mt[:, 0], ml=ml[:, 0])


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
    """The D-diagonal fragment search: on CUDA tensors one launch of K4,
    which builds the window keys and slab starts itself; on CPU tensors
    the plain version (same contract as
    :func:`window_fragment_diags_banded_plain`)."""
    return on_device(
        "window_fragment_diags_banded", rkeys.device,
        lambda: window_fragment_diags_banded_plain(
            rkeys, rvalid, windows, wlens, offs, k=k, occ=occ, D=D, w_b=w_b),
        lambda ops: ops.sdp_window_launch(
            rkeys, rvalid, windows, wlens, offs, k=k, occ=occ, D=D, w_b=w_b))


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

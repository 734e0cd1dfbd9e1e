"""Anchor chaining and candidate-interval selection (port of
``blasr_tpu/kernels/chain.py``), plain PyTorch.

``chain_anchors`` is the same O(A^2) chain DP as the JAX scan, one Python
step per anchor over full ``[B, A]`` carries (the JAX package's 8-anchor
blocks and padded windows only amortize loop overhead; the per-anchor op
order is identical), followed by the greedy top-``n_cand`` selection.
Ties resolve to the first index exactly as ``jnp.argmax`` does.  The two
float expressions XLA contracts into fused multiply-adds (the drift bound
and the significance sum) are rounded once here too.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from blasr_tpu_torch.kernels.anchor import Anchors
from blasr_tpu_torch.kernels.xla_math import fma_f32

NEG = -1e30
BIG = 0x3FFFFFFF


class Candidates(NamedTuple):
    """Top-nCand candidate intervals per read (WeightedInterval analog)."""

    q_start: torch.Tensor   # int64 [B, C]
    q_end: torch.Tensor     # int64 [B, C] (exclusive)
    t_start: torch.Tensor   # int64 [B, C]
    t_end: torch.Tensor     # int64 [B, C] (exclusive)
    score: torch.Tensor     # float32 [B, C] ranking weight
    n_anchors: torch.Tensor  # int64 [B, C]
    nlogp: torch.Tensor     # float32 [B, C] chain significance, nats
    valid: torch.Tensor     # bool [B, C]
    end_idx: torch.Tensor   # int64 [B, C] chain-end anchor index
    parent: torch.Tensor    # int64 [B, A] chain parent pointer (-1 = start)


def chain_anchors(anchors: Anchors, read_len: torch.Tensor, *, n_cand: int,
                  indel_rate: float = 0.3, drift_frac: float = 0.35,
                  drift_slack: int = 50, rank_by_pvalue: bool = False,
                  p_value_type: int = 0, lookback: int = 0,
                  global_chain: bool = False,
                  drift_penalty: float = 0.0) -> Candidates:
    """See ``blasr_tpu.kernels.chain.chain_anchors`` for the weightors,
    the transition window (``lookback``), ``global_chain`` and
    ``drift_penalty``."""
    q, t, l, valid = anchors.q, anchors.t, anchors.l, anchors.valid
    dev = q.device
    f32, i64 = torch.float32, torch.int64
    B, A = q.shape
    D = A if lookback <= 0 or lookback > A else lookback
    rate = torch.tensor(1.0 + indel_rate, dtype=f32, device=dev)
    wlen = (read_len.to(f32) * rate).to(i64)
    if global_chain:
        drift_frac, drift_slack = 0.1, 0
    frac_c = torch.tensor(drift_frac, dtype=f32, device=dev)
    slack_c = torch.tensor(float(drift_slack), dtype=f32, device=dev)

    q = q.to(i64)
    t = t.to(i64)
    l = l.to(i64)
    lf = l.to(f32)
    nlogp_in = anchors.nlogp
    jidx = torch.arange(A, device=dev)
    best = torch.full((B, A), NEG, dtype=f32, device=dev)
    sq = torch.zeros((B, A), dtype=i64, device=dev)
    st = torch.zeros((B, A), dtype=i64, device=dev)
    cnt = torch.zeros((B, A), dtype=i64, device=dev)
    sump = torch.zeros((B, A), dtype=f32, device=dev)
    sumr = torch.zeros((B, A), dtype=f32, device=dev)
    parent = torch.full((B, A), -1, dtype=i64, device=dev)

    for i in range(A):
        qi, ti = q[:, i], t[:, i]
        vi = valid[:, i]
        dq = qi[:, None] - q
        dt = ti[:, None] - t
        drift = (dt - dq).abs().to(f32)
        span = torch.maximum(dq, dt).to(f32)
        win = (jidx < i) & (jidx >= i - D)
        ok = (valid & win[None, :] & vi[:, None] & (dq > 0) & (dt > 0)
              & (dt <= wlen[:, None])
              & (drift <= fma_f32(frac_c, span, slack_c)))
        if global_chain:
            ok &= (dq >= l) & (dt >= l)
        li = lf[:, i]
        gain = torch.minimum(li[:, None], torch.minimum(dq, dt).to(f32))
        if drift_penalty > 0.0:
            gain = fma_f32(torch.tensor(-drift_penalty, dtype=f32,
                                        device=dev), drift, gain)
        cand = torch.where(ok, best + gain, NEG)
        w_best = torch.argmax(cand, dim=1)                       # [B]
        wb1 = w_best[:, None]
        v_best = cand.gather(1, wb1)[:, 0]
        start_new = v_best < li
        best_i = torch.where(start_new, li, v_best)
        sq_i = torch.where(start_new, qi, sq.gather(1, wb1)[:, 0])
        st_i = torch.where(start_new, ti, st.gather(1, wb1)[:, 0])
        par_i = torch.where(start_new, -1, w_best)
        cnt_i = torch.where(start_new, 1, cnt.gather(1, wb1)[:, 0] + 1)
        pi = nlogp_in[:, i]
        frac = torch.where(start_new, 1.0,
                           gain.gather(1, wb1)[:, 0]
                           / torch.clamp(li, min=1.0))
        sump_i = torch.where(start_new, pi,
                             fma_f32(pi, frac, sump.gather(1, wb1)[:, 0]))
        sumr_i = torch.where(start_new, pi, sumr.gather(1, wb1)[:, 0] + pi)
        best[:, i] = torch.where(vi, best_i, NEG)
        sq[:, i] = sq_i
        st[:, i] = st_i
        cnt[:, i] = torch.where(vi, cnt_i, 0)
        sump[:, i] = torch.where(vi, sump_i, 0.0)
        sumr[:, i] = torch.where(vi, sumr_i, 0.0)
        parent[:, i] = torch.where(vi, par_i, -1)

    # greedy top-n_cand chain ends, suppressing same-placement duplicates
    q_end_all = q + l
    t_end_all = t + l
    if rank_by_pvalue:
        if p_value_type == 1:
            pkey = best * torch.tensor(1.3862944, dtype=f32, device=dev)
        elif p_value_type == 2:
            pkey = sumr
        else:
            pkey = sump
        rank_key = torch.where(best > NEG * 0.5, pkey, NEG)
    else:
        rank_key = best

    remaining = valid.clone()
    outs = []
    for _ in range(n_cand):
        masked = torch.where(remaining, rank_key, NEG)
        i_best = torch.argmax(masked, dim=1)
        ib1 = i_best[:, None]
        v = masked.gather(1, ib1)[:, 0]
        ok = v > NEG * 0.5
        ts_i = st.gather(1, ib1)[:, 0]
        te_i = t_end_all.gather(1, ib1)[:, 0]
        qs_i = sq.gather(1, ib1)[:, 0]
        qe_i = q_end_all.gather(1, ib1)[:, 0]
        ov = (torch.minimum(te_i[:, None], t_end_all)
              - torch.maximum(ts_i[:, None], st))
        span_min = torch.minimum((te_i - ts_i)[:, None], t_end_all - st)
        d_sel = (te_i - qe_i)[:, None]
        same_diag = ((t_end_all - q_end_all) - d_sel).abs() < 128
        overlap = (2 * ov > span_min) & same_diag
        remaining = remaining & ~overlap
        outs.append((qs_i, qe_i, ts_i, te_i, v,
                     ok & valid.gather(1, ib1)[:, 0], i_best))
    qs, qe, ts, te, sc, okv, endi = (torch.stack(c, dim=1)
                                     for c in zip(*outs))
    n_anch = cnt.gather(1, endi)
    chain_p = sump.gather(1, endi)
    return Candidates(
        q_start=qs, q_end=qe, t_start=ts, t_end=te,
        score=torch.where(okv, sc, 0.0),
        n_anchors=torch.where(okv, n_anch, 0),
        nlogp=torch.where(okv, chain_p, 0.0),
        valid=okv, end_idx=endi, parent=parent)


def chain_members(candidates: Candidates, anchors: Anchors, *,
                  max_chain: int):
    """Member anchors (q, t, l) of each selected chain, q-ascending, padded
    to ``max_chain`` with (BIG, BIG, 0); member d is the distance-d
    ancestor of the end anchor, found by binary lifting."""
    B, C = candidates.end_idx.shape
    M = max_chain
    nbits = max(1, (M - 1).bit_length())
    dev = candidates.end_idx.device

    def jump(par, x):
        # distance doubling with -1 (root) absorbing; x [B, ...]
        nxt = par.gather(1, x.clamp(min=0).reshape(B, -1)).reshape(x.shape)
        return torch.where(x < 0, -1, nxt)

    d = torch.arange(M, device=dev)[None, None, :]
    cur = candidates.end_idx[:, :, None].expand(B, C, M)
    par2 = candidates.parent
    for b in range(nbits):
        hop = jump(par2, cur)
        cur = torch.where((d >> b) & 1 == 1, hop, cur)
        if b + 1 < nbits:
            par2 = jump(par2, par2)
    ok = cur >= 0
    safe = cur.clamp(min=0).reshape(B, C * M)

    def take(x, fill):
        v = x.to(torch.int64).gather(1, safe).reshape(B, C, M)
        return torch.where(ok, v, fill)

    qs, ts, ls = take(anchors.q, BIG), take(anchors.t, BIG), take(anchors.l, 0)
    order = torch.argsort(qs, dim=2, stable=True)
    mq, mt, ml = qs.gather(2, order), ts.gather(2, order), ls.gather(2, order)
    return mq, mt, ml, mq < BIG

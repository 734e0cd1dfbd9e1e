"""Guided banded affine alignment: the DP forward pass and the run-length
traceback (port of ``blasr_tpu/kernels/banded.py``: the distance and the
QV-steered modes of the forward pass; the hp band is not ported).

Both functions keep the JAX package's contracts bit for bit: the int32
cell-word layout below, ``BandedResult`` / ``TracebackResult``, and the
packed (op | count << 2) halfword pairs.

* :func:`banded_align` is the plain PyTorch version of the forward pass:
  one Python loop over query rows on ``[N, w_b]`` tensors.  It runs on any
  device; the mapping path calls it only on CPU tensors (the CUDA path is
  :func:`blasr_tpu_torch.kernels.pallas_banded.banded_align_cuda`).
* :func:`banded_traceback` launches the hand-written CUDA walk (``K2``,
  ``csrc/banded_traceback.cu``) on CUDA tensors and runs
  :func:`banded_traceback_plain` on CPU tensors.

All costs are integer-valued float32 below 2^24, so every comparison that
sets a traceback bit is exact in any evaluation order.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

INF = 1e30

# traceback cell word layout (int32 per banded cell)
#   bits 0-1: source state of M's diagonal predecessor (0=M, 1=I, 2=D)
#   bit 2   : I opened from M (else extended from I)
#   bit 3   : D opened at this cell (else extended from D[w-1])
#   bit 4   : D opened from M (else from I)
#   bit 5   : read base == target base at this cell
#   bit 6   : h_open (homopolymer-insertion band opened from M; always 0
#             in distance mode)
#   bits 7-8:  run-exit state — m_src at the start of this cell's M run
#   bits 9-14: M-run length (consecutive state-M cells chained by
#              m_src==M diagonal links, capped at RUN_CAP)
#   bits 15-20: eq count within the run
#   bits 21-22: s_r — this row's band shift offsets[r]-offsets[r-1]
#              (0 at the first active row; saturates at 3)
#   bits 23-29: ssum — sum of s over the M-run's rows (<= 2*RUN_CAP,
#              127 flags a saturated jump)
ST_M, ST_I, ST_D = 0, 1, 2
ST_H = 3
RUN_CAP = 63

_TB_CHUNK = 64    # the JAX walk's while_loop chunk: P rounds up to 2x this
_CNT_CAP = 16383  # 14-bit pair count (boundary-deletion runs re-loop)


class BandedResult(NamedTuple):
    score: torch.Tensor        # float32 [N] (integer-valued; INF if invalid)
    tbbits: torch.Tensor       # int32 [N, L, w_b] cell words (layout above)
    final_state: torch.Tensor  # int32 [N]
    valid: torch.Tensor        # bool [N] alignment reached the end cell


class TracebackResult(NamedTuple):
    """Run-length traceback: (op, count) pairs emitted end-first, packed
    two per int32 word (low half first); op 0 stop, 1 M, 2 I, 3 D."""

    pairs: torch.Tensor        # int32 [N, P//2]
    n_pairs: torch.Tensor      # int32 [N]
    n_match: torch.Tensor      # int32 [N]
    n_mismatch: torch.Tensor   # int32 [N]
    n_ins: torch.Tensor        # int32 [N]
    n_del: torch.Tensor        # int32 [N]
    overflow: torch.Tensor     # bool [N]: > P pairs needed (rerun with the
    #                            dense bound t_max = L + W)


def pair_capacity(t_max: int) -> int:
    """Pair slots P for a walk bounded by ``t_max`` (the JAX layout)."""
    return -(-t_max // (2 * _TB_CHUNK)) * (2 * _TB_CHUNK)


def _shift(padded: torch.Tensor, k: torch.Tensor, w_b: int) -> torch.Tensor:
    """out[n, w] = row[n, w + k[n]] where padded = [fill, row, fill*w_b].

    The start index clamps into [0, w_b + 1] exactly as
    ``lax.dynamic_slice`` clamps it."""
    start = (k + 1).clamp(0, w_b + 1)
    idx = start[:, None] + torch.arange(w_b, device=padded.device)
    return padded.gather(1, idx)


def _pad_row(row: torch.Tensor, fill) -> torch.Tensor:
    N, w_b = row.shape
    return torch.cat([torch.full((N, 1), fill, dtype=row.dtype,
                                 device=row.device), row,
                      torch.full((N, w_b), fill, dtype=row.dtype,
                                 device=row.device)], dim=1)


def _prev(x: torch.Tensor, fill) -> torch.Tensor:
    """out[:, w] = x[:, w-1], fill at w == 0."""
    return torch.cat([torch.full((x.shape[0], 1), fill, dtype=x.dtype,
                                 device=x.device), x[:, :-1]], dim=1)


def unpack_qv(qv1: torch.Tensor, qv2: torch.Tensor):
    """Per-row QV cost fields of the packed tracks (int32 [N, L]):
    qv1 = insQV | delQV<<8 | subQV<<16 | dtag<<24 | stag<<27,
    qv2 = delPrior | subPrior<<8.  Costs come back as float32, tags as
    int64 (tag 7 matches no target base)."""
    f32 = torch.float32
    qv1, qv2 = qv1.to(torch.int64), qv2.to(torch.int64)
    return dict(insq=(qv1 & 255).to(f32), delq=((qv1 >> 8) & 255).to(f32),
                subq=((qv1 >> 16) & 255).to(f32), dtag=(qv1 >> 24) & 7,
                stag=(qv1 >> 27) & 7, dpri=(qv2 & 255).to(f32),
                spri=((qv2 >> 8) & 255).to(f32))


def banded_align(reads, windows, offsets, qa, qb, ta, tb, submat,
                 ins_open, ins_ext, del_open, del_ext, *,
                 w_b: int = 128, qv1=None, qv2=None) -> BandedResult:
    """Batched guided banded alignment (plain PyTorch).

    reads   int8  [N, L]     query codes
    windows int8  [N, W]     target window codes
    offsets int   [N, L]     band start per row (window coordinates)
    qa..tb  int   [N]        global alignment ranges (window coords for t)
    submat  float32 [25]     flattened 5x5 score matrix (integer-valued)
    qv1/qv2 int32 [N, L]     packed per-row QV cost tracks (layout in
                             :func:`unpack_qv`); given, they switch on the
                             QV-steered mode: mismatch, insertion and
                             per-cell linear deletion costs come from the
                             tracks and the gap costs are unused

    Row-for-row the recurrence of ``blasr_tpu.kernels.banded._align_one``
    in its distance and QV modes (the hp band is not ported); any offsets
    path is accepted (band shifts use the clamped dynamic-slice
    semantics)."""
    dev = reads.device
    N, L = reads.shape
    W = windows.shape[1]
    f32, i32, i64 = torch.float32, torch.int32, torch.int64
    ins_open, ins_ext = float(ins_open), float(ins_ext)
    del_open, del_ext = float(del_open), float(del_ext)
    submat = torch.as_tensor(submat, dtype=f32, device=dev).reshape(25)
    offsets = offsets.to(i64)
    qa, qb, ta, tb = (x.to(i64) for x in (qa, qb, ta, tb))
    reads64 = reads.to(i64)
    wpad = torch.cat([windows.to(i64),
                      torch.full((N, w_b), 4, dtype=i64, device=dev)], dim=1)
    lane = torch.arange(w_b, device=dev)
    w_idx = lane.to(f32)
    full_inf = torch.full((N, w_b), INF, dtype=f32, device=dev)
    use_qv = qv1 is not None
    if use_qv:
        q = unpack_qv(qv1, qv2)
        # leading-deletion boundary profile: running sum, from ta, of row
        # qa's per-cell deletion costs over the whole window
        qa_c = qa.clamp(0, L - 1)[:, None]
        row0 = {k: v.gather(1, qa_c) for k, v in q.items()}
        c0 = torch.where(windows.to(i64) == row0["dtag"], row0["delq"],
                         row0["dpri"])
        cumz = torch.cat([torch.zeros((N, 1), dtype=f32, device=dev),
                          torch.cumsum(c0, dim=1)], dim=1)       # [N, W+1]
        cumz_ta = cumz.gather(1, ta.clamp(0, W)[:, None])

    pM, pI, pD = full_inf, full_inf, full_inf
    zi = torch.zeros((N, w_b), dtype=i32, device=dev)
    pR, pE, pX, pS = zi, zi, zi, zi
    po = torch.zeros(N, dtype=i64, device=dev)
    fin_score = torch.full((N,), INF, dtype=f32, device=dev)
    fin_state = torch.full((N,), ST_M, dtype=i32, device=dev)
    fin_ok = torch.zeros(N, dtype=torch.bool, device=dev)
    tbbits = torch.empty((N, L, w_b), dtype=i32, device=dev)

    for r in range(L):
        o_r = offsets[:, r]
        active = (r >= qa) & (r < qb)
        first = qa == r
        t_abs = o_r[:, None] + lane                                # [N, w_b]

        # boundary row (virtual row qa-1): zero-cost M cell at ta-1,
        # leading deletions open + ext*(t-ta) from ta on
        bM = torch.where(t_abs == ta[:, None] - 1, 0.0, full_inf)
        if use_qv:
            cg = cumz.gather(1, (t_abs + 1).clamp(0, W))
            bD = torch.where(t_abs >= ta[:, None], cg - cumz_ta, full_inf)
        else:
            d = (t_abs - ta[:, None]).to(f32)
            bD = torch.where(t_abs >= ta[:, None], del_open + del_ext * d,
                             full_inf)
        f1 = first[:, None]
        pM_ = torch.where(f1, bM, pM)
        pI_ = torch.where(f1, full_inf, pI)
        pD_ = torch.where(f1, bD, pD)
        s = torch.where(first, 0, o_r - po)

        pMp, pIp, pDp = _pad_row(pM_, INF), _pad_row(pI_, INF), \
            _pad_row(pD_, INF)
        dM, dI, dD = (_shift(pMp, s - 1, w_b), _shift(pIp, s - 1, w_b),
                      _shift(pDp, s - 1, w_b))
        dR = _shift(_pad_row(pR, 0), s - 1, w_b)
        dE = _shift(_pad_row(pE, 0), s - 1, w_b)
        dX = _shift(_pad_row(pX, 0), s - 1, w_b)
        dS = _shift(_pad_row(pS, 0), s - 1, w_b)
        vM, vI = _shift(pMp, s, w_b), _shift(pIp, s, w_b)

        in_t = (t_abs >= ta[:, None]) & (t_abs < tb[:, None])
        in_t_i = (t_abs >= ta[:, None] - 1) & (t_abs < tb[:, None])
        tstart = o_r.clamp(min=0).clamp(max=W)
        tgt = wpad.gather(1, tstart[:, None] + lane)
        rb = reads64[:, r][:, None]
        sub = submat[rb * 5 + tgt]
        eq = (rb == tgt) & (rb < 4)
        if use_qv:
            qr = {k: v[:, r][:, None] for k, v in q.items()}      # [N, 1]
            # mismatch: substitutionQV where the target base matches the
            # SubstitutionTag, else the per-row prior
            sub = torch.where(eq, sub, torch.where(tgt == qr["stag"],
                                                   qr["subq"], qr["spri"]))

        diag_best = torch.minimum(dM, torch.minimum(dI, dD))
        m_src = torch.where(dM <= diag_best, ST_M,
                            torch.where(dI <= diag_best, ST_I, ST_D)).to(i32)
        M = torch.where(in_t, sub + diag_best, full_inf)

        if use_qv:
            # insertionQV prices this inserted query base (linear gap)
            i_from_m = vM + qr["insq"]
            i_from_i = vI + qr["insq"]
        else:
            i_from_m = vM + ins_open
            i_from_i = vI + ins_ext
        I = torch.where(in_t_i, torch.minimum(i_from_m, i_from_i), full_inf)
        i_open = i_from_m <= i_from_i

        base = torch.minimum(M, I)
        base_prev = _prev(base, INF)
        if use_qv:
            # per-cell linear deletion costs: deletionQV where the deleted
            # target base matches the DeletionTag, else the prior; the
            # closed form runs on their in-row cumsum S
            cd = torch.where(tgt == qr["dtag"], qr["delq"], qr["dpri"])
            S = torch.cumsum(cd, dim=1)
            g = torch.where(base < INF * 0.5, base - S, full_inf)
            run_prev = _prev(torch.cummin(g, dim=1).values, INF)
            # D[w] = base[w'] + sum cd[w'+1..w] over w' < w
            D = torch.where(in_t, S + run_prev, full_inf)
            D = torch.minimum(D, full_inf)
            d_open = D >= base_prev + cd
        else:
            g = torch.where(base < INF * 0.5, base - del_ext * w_idx,
                            full_inf)
            run_prev = _prev(torch.cummin(g, dim=1).values, INF)
            # D[w] = open + ext*(w - w' - 1) + base[w'] over w' < w
            D = torch.where(in_t, del_ext * w_idx + run_prev
                            + (del_open - del_ext), full_inf)
            D = torch.minimum(D, full_inf)
            d_open = D >= base_prev + del_open
        d_from_m = _prev(M, INF) <= _prev(I, INF)

        from_m = m_src == ST_M
        fresh = (~from_m) | f1 | (dR >= RUN_CAP)
        eq_i = eq.to(i32)
        mrun = torch.where(fresh, 1, dR + 1)
        meq = torch.where(fresh, 0, dE) + eq_i
        rexit = torch.where(fresh, torch.where(from_m, ST_M, m_src), dX)
        s2 = s[:, None].to(i32)
        s_clip = torch.clamp(s2, max=3)
        ssum = torch.where(s2 > 2, 127,
                           torch.clamp(torch.where(fresh, s2, dS + s2),
                                       max=127))
        bits = (m_src
                | (i_open.to(i32) << 2)
                | (d_open.to(i32) << 3)
                | (d_from_m.to(i32) << 4)
                | (eq_i << 5)
                | (rexit << 7)
                | (mrun << 9)
                | (meq << 15)
                | (s_clip << 21)
                | (ssum << 23))
        a1 = active[:, None]
        tbbits[:, r] = torch.where(a1, bits, 0)

        pM = torch.where(a1, M, pM)
        pI = torch.where(a1, I, pI)
        pD = torch.where(a1, D, pD)
        pR = torch.where(a1, mrun, pR)
        pE = torch.where(a1, meq, pE)
        pX = torch.where(a1, rexit, pX)
        pS = torch.where(a1, ssum, pS)
        po = torch.where(active, o_r, po)

        # final score at row qb-1, cell t = tb-1
        wf = tb - 1 - o_r
        ok_wf = (wf >= 0) & (wf < w_b)
        wf_c = wf.clamp(0, w_b - 1)[:, None]
        cM, cI, cD = (M.gather(1, wf_c)[:, 0], I.gather(1, wf_c)[:, 0],
                      D.gather(1, wf_c)[:, 0])
        cbest = torch.minimum(cM, torch.minimum(cI, cD))
        cstate = torch.where(cM <= cbest, ST_M,
                             torch.where(cI <= cbest, ST_I, ST_D)).to(i32)
        hit = (qb - 1 == r) & active & ok_wf & (cbest < INF * 0.5)
        fin_score = torch.where(hit, cbest, fin_score)
        fin_state = torch.where(hit, cstate, fin_state)
        fin_ok = fin_ok | hit
    return BandedResult(fin_score, tbbits, fin_state, fin_ok)


def banded_traceback_plain(result: BandedResult, offsets, qa, qb, ta, tb, *,
                           t_max: int, w_b: int = 128) -> TracebackResult:
    """Run-length traceback over the cell words (plain PyTorch).

    Step for step ``blasr_tpu.kernels.banded.banded_traceback``'s
    ``rl_step``; the JAX chunked while_loop only stops early once every row
    is done, which changes no row's output, so the loop here checks for
    that once per chunk too."""
    tbb = result.tbbits
    dev = tbb.device
    N, L, _ = tbb.shape
    i64 = torch.int64
    flat = tbb.reshape(N, L * w_b)
    P = pair_capacity(t_max)
    offsets = offsets.to(i64)
    qa, qb, ta, tb = (x.to(i64) for x in (qa, qb, ta, tb))

    off_last = offsets.gather(1, (qb - 1).clamp(0, L - 1)[:, None])[:, 0]
    r, t, w = qb - 1, tb - 1, tb - 1 - off_last
    wbad = torch.zeros(N, dtype=torch.bool, device=dev)
    st = result.final_state.to(i64)
    done = ~result.valid
    z = torch.zeros(N, dtype=i64, device=dev)
    nm, nmm, nins, ndel, npairs = z, z, z, z, z
    buf = torch.zeros((N, P), dtype=i64, device=dev)

    for s0 in range(0, P, _TB_CHUNK):
        if bool(done.all()):
            break
        for step in range(s0, s0 + _TB_CHUNK):
            at_b = r < qa
            rc = r.clamp(0, L - 1)
            off_rc = offsets.gather(1, rc[:, None])[:, 0]
            w_ok = (w >= 0) & (w < w_b)
            idx = rc * w_b + w.clamp(0, w_b - 1)
            cell = flat.gather(1, idx[:, None])[:, 0].to(i64)
            i_open = (cell >> 2) & 1
            d_open = (cell >> 3) & 1
            d_from_m = (cell >> 4) & 1
            h_open = (cell >> 6) & 1
            rexit = (cell >> 7) & 3
            mrun = torch.clamp((cell >> 9) & 63, min=1)
            meq = (cell >> 15) & 63
            s_r = (cell >> 21) & 3
            ssum = (cell >> 23) & 127

            b_more = at_b & (t >= ta)
            b_done = at_b & (t < ta)
            stall = wbad & ~done & ~at_b
            is_m = (~at_b) & (st == ST_M) & ~stall
            is_i = (~at_b) & ((st == ST_I) | (st == ST_H)) & ~stall
            is_d = (~at_b) & (st == ST_D) & ~stall
            emit = ~(done | b_done | stall)

            b_cnt = torch.clamp(t - ta + 1, max=_CNT_CAP)
            op = torch.where(stall, 1,
                 torch.where(~emit, 0,
                 torch.where(b_more, 3,
                 torch.where(is_m, 1,
                 torch.where(is_i, 2, 3)))))
            cnt = torch.where(stall, 0,
                  torch.where(b_more, b_cnt,
                  torch.where(is_m, mrun, 1)))
            buf[:, step] = torch.where(emit | stall, op | (cnt << 2), 0)

            nr = torch.where(emit & (is_m | is_i),
                             r - torch.where(is_m, mrun, 1), r)
            nt = torch.where(emit,
                             t - torch.where(b_more, b_cnt,
                                 torch.where(is_m, mrun,
                                 torch.where(is_d, 1, 0))), t)
            nw = torch.where(stall, t - off_rc,
                 torch.where(emit,
                             torch.where(is_m, w - mrun + ssum,
                             torch.where(is_i, w + s_r,
                             torch.where(is_d, w - 1, w))), w))
            sat = (is_i & (s_r == 3)) | (is_m & (ssum == 127))
            nwbad = torch.where(stall, False,
                                wbad | (emit & sat & (nr >= qa)))
            is_h = (~at_b) & (st == ST_H) & ~stall
            nst = torch.where(is_m, rexit,
                  torch.where(is_h, torch.where(h_open == 1, ST_M, ST_H),
                  torch.where(is_i, torch.where(i_open == 1, ST_M, ST_I),
                  torch.where(is_d,
                              torch.where(d_open == 1,
                                          torch.where(d_from_m == 1,
                                                      ST_M, ST_I),
                                          ST_D),
                              st))))
            nm = nm + torch.where(emit & is_m, meq, 0)
            nmm = nmm + torch.where(emit & is_m, mrun - meq, 0)
            nins = nins + (emit & is_i).to(i64)
            ndel = ndel + (emit & is_d).to(i64) \
                + torch.where(emit & b_more, b_cnt, 0)
            npairs = npairs + emit.to(i64)
            done = done | b_done | ((~at_b) & ~w_ok & emit)
            r, t, w, wbad, st = nr, nt, nw, nwbad, nst

    packed = (buf[:, 0::2] | (buf[:, 1::2] << 16)).to(torch.int32)
    i32 = torch.int32
    return TracebackResult(
        pairs=packed, n_pairs=npairs.to(i32), n_match=nm.to(i32),
        n_mismatch=nmm.to(i32), n_ins=nins.to(i32), n_del=ndel.to(i32),
        overflow=~done)


def banded_traceback(result: BandedResult, offsets, qa, qb, ta, tb, *,
                     t_max: int, w_b: int = 128) -> TracebackResult:
    """Run-length traceback: the CUDA walk (K2) on CUDA tensors, the plain
    version on CPU tensors."""
    dev = result.tbbits.device
    if dev.type == "cpu":
        return banded_traceback_plain(result, offsets, qa, qb, ta, tb,
                                      t_max=t_max, w_b=w_b)
    if dev.type != "cuda":
        raise NotImplementedError(f"banded_traceback on {dev.type}")
    from blasr_tpu_torch.kernels import cuda_ops
    return cuda_ops.banded_traceback_cuda(result, offsets, qa, qb, ta, tb,
                                          t_max=t_max, w_b=w_b)

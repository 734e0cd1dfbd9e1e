# Copied from blasr_tpu/pipeline/extend.py; only the imports differ.
"""Alignment end extension — the reference's ``ExtendAlign``
(``ExtendAlignmentForward/Reverse``, iblasr/BlasrAlignImpl.hpp:1011-1203):
after interval alignment, try to grow each end by up to ``maxExtendLength``
(500 bp) with a banded DP (band ``extendBandSize``=10) that stops when the
running score drops ``maxExtendDropoff`` (10) below the best seen; the
best-scoring prefix is appended to the alignment.

Host-side NumPy: extension windows are tiny (<= 500 x band) and only run
for alignments that survive selection, so this is not a device kernel.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from blasr_tpu_torch.io.fasta import revcomp

NEG = -(10 ** 9)


def _extend_one(q: np.ndarray, t: np.ndarray, *, band: int, dropoff: int,
                match: int, mismatch: int, ins: int, dele: int):
    """Pinned-start free-end banded DP on (q, t) (already oriented so the
    extension moves forward).  Returns (ops, qlen_used, tlen_used, score)
    with score in distance convention (negative better), or None."""
    n, m = len(q), len(t)
    if n == 0 or m == 0:
        return None
    sm, sx, si, sd = -match, -mismatch, -ins, -dele   # similarity terms
    W = 2 * band + 1
    H = np.full((n + 1, W), NEG, np.int64)
    ptr = np.zeros((n + 1, W), np.uint8)   # 1 diag, 2 up(q), 3 left(t)
    # lane w of row i = target position j = i + w - band
    H[0, band] = 0
    for j in range(1, min(band, m) + 1):
        H[0, band + j] = sd * j
        ptr[0, band + j] = 3
    best = (0, 0, band)
    best_val = 0
    for i in range(1, n + 1):
        jj = i + np.arange(W) - band          # target pos per lane
        okj = (jj >= 0) & (jj <= m)
        tv = t[np.clip(jj - 1, 0, m - 1)]
        sub = np.where((tv == q[i - 1]) & (q[i - 1] < 4) & (tv < 4), sm, sx)
        diag = H[i - 1] + sub                  # same lane in row i-1 = diag
        up = np.concatenate([H[i - 1][1:], [NEG]]) + si
        pre = np.maximum(diag, up)
        p = np.where(diag >= up, 1, 2).astype(np.uint8)
        # left within the row: running max over lanes
        a = pre - sd * np.arange(W)
        run = np.maximum.accumulate(
            np.concatenate([[NEG], a[:-1]]))
        left = run + sd * np.arange(W)
        row = np.maximum(pre, left)
        p = np.where(left > pre, 3, p).astype(np.uint8)
        row = np.where(okj & (jj >= 0), row, NEG)
        H[i] = row
        ptr[i] = p
        rbest = int(row.max())
        if rbest > best_val:
            best_val = rbest
            best = (best_val, i, int(row.argmax()))
        if rbest < best_val - dropoff:
            break
        if rbest <= NEG // 2:
            break
    _, bi, bw = best
    if best_val <= 0:
        return None
    # traceback from the best cell
    ops: List[str] = []
    i, w = bi, bw
    while i > 0 or w != band:
        p = ptr[i, w]
        if p == 1:
            ops.append("M")
            i -= 1
        elif p == 2:
            ops.append("I")
            i -= 1
            w += 1
        elif p == 3:
            ops.append("D")
            w -= 1
        else:
            break
        if w < 0 or w >= W:
            return None
    ops.reverse()
    qlen_used = sum(1 for o in ops if o in "MI")
    tlen_used = sum(1 for o in ops if o in "MD")
    return ops, qlen_used, tlen_used, -best_val


def _runs(ops: List[str]):
    out: List[Tuple[str, int]] = []
    for o in ops:
        if out and out[-1][0] == o:
            out[-1] = (o, out[-1][1] + 1)
        else:
            out.append((o, 1))
    return out


def extend_alignment(a, gi, params) -> None:
    """Extend both ends of a pipeline Alignment in place
    (ExtendAlignmentForward/Reverse roles).  Updates coordinates, CIGAR,
    stats and score."""
    max_len = 500
    band = params.extend_band_size
    drop = params.max_extend_dropoff
    m5 = np.asarray(params.score_matrix).reshape(5, 5)
    match, mismatch = int(m5[0, 0]), int(m5[0, 1])
    ins, dele = params.insertion, params.deletion

    oread = a.read if a.strand == 0 else revcomp(a.read)
    qa = a.qstart if a.strand == 0 else a.qlen - a.qend
    qb = a.qend if a.strand == 0 else a.qlen - a.qstart
    lo, hi = gi.seqdb.contig_bounds(a.tindex)
    gs = gi.seqdb.chrom_to_genome(a.tindex, a.tstart)
    ge = gi.seqdb.chrom_to_genome(a.tindex, a.tend)

    def apply(ops, nq, nt, sc, forward: bool):
        nonlocal qa, qb, gs, ge
        runs = _runs(ops)
        if forward:
            a.cigar = (a.cigar or []) + runs
            qb += nq
            ge += nt
        else:
            a.cigar = runs + (a.cigar or [])
            qa -= nq
            gs -= nt
        a.score += sc
        for op, n in runs:
            if op == "M":
                pass
            elif op == "I":
                a.n_ins += n
            else:
                a.n_del += n
        # match/mismatch split for the M runs
        opc_q = qb - nq if forward else qa
        opc_t = ge - nt if forward else gs
        qi, ti = opc_q, opc_t
        for op, n in runs:
            if op == "M":
                eq = (oread[qi:qi + n] == gi.genome[ti:ti + n])
                a.n_match += int(eq.sum())
                a.n_mismatch += int(n - eq.sum())
                qi += n
                ti += n
            elif op == "I":
                qi += n
            else:
                ti += n

    # forward extension
    qf = oread[qb: min(qb + max_len, a.qlen)]
    tf = gi.genome[ge: min(ge + max_len + band, hi)]
    r = _extend_one(qf, tf, band=band, dropoff=drop, match=match,
                    mismatch=mismatch, ins=ins, dele=dele)
    if r is not None:
        apply(r[0], r[1], r[2], r[3], True)
    # reverse extension: flip both sequences
    qr = oread[max(qa - max_len, 0): qa][::-1]
    tr = gi.genome[max(gs - max_len - band, lo): gs][::-1]
    r = _extend_one(qr, tr, band=band, dropoff=drop, match=match,
                    mismatch=mismatch, ins=ins, dele=dele)
    if r is not None:
        ops, nq, nt, sc = r
        apply(list(reversed(ops)), nq, nt, sc, False)

    # write back coordinates
    if a.strand == 0:
        a.qstart, a.qend = qa, qb
    else:
        a.qstart, a.qend = a.qlen - qb, a.qlen - qa
    a.tstart = gs - lo
    a.tend = ge - lo

# Copied from blasr_tpu/pipeline/scoring.py; only the imports differ.
"""Score functions beyond the plain distance matrix.

Reference parity for the score-function family
(iblasr/BlasrAlignImpl.hpp:576-577,1241-1253; BlasrUtilsImpl.hpp:117-130):

  * DistanceMatrixScoreFunction — the 5x5 SMRT matrix + indel costs (the
    device kernels' native scoring; here for host rescoring).
  * QualityValueScoreFunction — mismatch/insertion penalties scaled by the
    read's per-base quality.
  * IDSScoreFunction — insertion/deletion/substitution QV tracks with
    substitutionPrior (20) and globalDeletionPrior (13) fallbacks
    (RegisterBlasrOptions.h --substitutionPrior/--deletionPrior).
  * SMRTLogProbMatrix-style log-probability rescoring used by StoreMapQVs
    (BlasrUtilsImpl.hpp:117-130): alignments are re-scored as
    log10 P(read | template) before the log-sum-exp mapQV.

All functions score an existing alignment path (CIGAR + sequences) on the
host, fully vectorized over alignment columns — the device DP optimizes
with the distance matrix, and QV-aware scores apply at refinement/mapQV
time, where the reference's tests actually observe them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

OP_M, OP_I, OP_D = 0, 1, 2
_OPC = {"M": OP_M, "=": OP_M, "X": OP_M, "I": OP_I, "D": OP_D}
# native run codes (1 M / 2 I / 3 D / 4 X) -> column op codes
_RAWC = np.array([0, OP_M, OP_I, OP_D, OP_M], dtype=np.int64)


@dataclass
class QVTracks:
    """Per-base quality tracks (PacBio iq/dq/sq BAM tags; plain FASTQ
    supplies only `qual`, used as the fallback for all three)."""

    qual: Optional[np.ndarray] = None      # overall QV
    ins_qv: Optional[np.ndarray] = None
    del_qv: Optional[np.ndarray] = None
    sub_qv: Optional[np.ndarray] = None

    def get(self, kind: str) -> Optional[np.ndarray]:
        v = getattr(self, kind)
        return v if v is not None else self.qual


def expand_cigar(cigar, qa: int, ta: int):
    """(opc, qidx, tidx) per alignment column: op code (0 M / 1 I / 2 D)
    plus the query/target position each column consumes (the position of
    the last consumed base for the non-consuming side)."""
    if not cigar:
        z = np.zeros(0, np.int64)
        return z, z, z
    raw = getattr(cigar, "arrays", None)
    if raw is not None:
        # LazyCigar fast path: map the native run codes (1 M / 2 I / 3 D /
        # 4 X) straight to column op codes, skipping tuple materialization
        rops, counts = raw()
        ops = _RAWC[rops].astype(np.int64)
        counts = counts.astype(np.int64)
    else:
        ops = np.asarray([_OPC[op] for op, _ in cigar], np.int64)
        counts = np.asarray([n for _, n in cigar], np.int64)
    opc = np.repeat(ops, counts)
    dq = (opc != OP_D).astype(np.int64)
    dt = (opc != OP_I).astype(np.int64)
    qidx = qa + np.cumsum(dq) - dq
    tidx = ta + np.cumsum(dt) - dt
    return opc, qidx, tidx


def _col_eq(opc, qidx, tidx, query, target):
    q = np.asarray(query)
    t = np.asarray(target)
    qs = q[np.clip(qidx, 0, len(q) - 1)]
    ts = t[np.clip(tidx, 0, len(t) - 1)]
    return (qs == ts) & (qs < 4)


def score_alignment_distance(cigar, query, target, qa, ta, *,
                             score_matrix, ins: int, dele: int,
                             affine: bool = False, affine_open: int = 10,
                             affine_extend: int = 0) -> int:
    """ComputeAlignmentScore (AlignmentUtils usage,
    BlasrAlignImpl.hpp:1214-1217), optionally affine."""
    m = np.asarray(score_matrix).reshape(5, 5)
    opc, qidx, tidx = expand_cigar(cigar, qa, ta)
    is_m = opc == OP_M
    qs = np.asarray(query)[np.clip(qidx, 0, len(query) - 1)]
    ts = np.asarray(target)[np.clip(tidx, 0, len(target) - 1)]
    total = int(m[qs[is_m], ts[is_m]].sum())
    if affine:
        for op, n in cigar:
            if op == "I":
                total += affine_open + ins + affine_extend * (n - 1)
            elif op == "D":
                total += affine_open + dele + affine_extend * (n - 1)
    else:
        total += ins * int((opc == OP_I).sum())
        total += dele * int((opc == OP_D).sum())
    return total


def score_alignment_qv(cigar, query, target, qa, ta,
                       qv: np.ndarray) -> float:
    """QualityValueScoreFunction analog: matches are free; mismatches and
    insertions cost the base's QV (capped), deletions a fixed penalty."""
    DEL_PENALTY = 15.0
    opc, qidx, tidx = expand_cigar(cigar, qa, ta)
    q = np.minimum(np.asarray(qv, np.float64)[np.clip(qidx, 0, len(qv) - 1)],
                   40.0)
    eq = _col_eq(opc, qidx, tidx, query, target)
    total = float(q[(opc == OP_M) & ~eq].sum())
    total += float(q[opc == OP_I].sum())
    total += DEL_PENALTY * int((opc == OP_D).sum())
    return total


def score_alignment_ids(cigar, query, target, qa, ta, tracks: QVTracks, *,
                        substitution_prior: int = 20,
                        global_deletion_prior: int = 13) -> float:
    """IDSScoreFunction analog: insertionQV for I columns, deletionQV of
    the neighboring base for D columns (globalDeletionPrior fallback),
    substitutionQV (or substitutionPrior) for mismatches."""
    iq, dq, sq = tracks.get("ins_qv"), tracks.get("del_qv"), tracks.get("sub_qv")
    opc, qidx, tidx = expand_cigar(cigar, qa, ta)
    eq = _col_eq(opc, qidx, tidx, query, target)
    total = 0.0
    mis = (opc == OP_M) & ~eq
    if sq is not None:
        sv = np.minimum(np.asarray(sq, np.float64)[
            np.clip(qidx, 0, len(sq) - 1)], 40.0)
        total += float(sv[mis].sum())
    else:
        total += float(substitution_prior) * int(mis.sum())
    ins_cols = opc == OP_I
    if iq is not None:
        iv = np.minimum(np.asarray(iq, np.float64)[
            np.clip(qidx, 0, len(iq) - 1)], 40.0)
        total += float(iv[ins_cols].sum())
    else:
        total += 15.0 * int(ins_cols.sum())
    del_cols = opc == OP_D
    if dq is not None:
        dv = np.minimum(np.asarray(dq, np.float64)[
            np.clip(qidx, 0, len(dq) - 1)], 40.0)
        total += float(dv[del_cols].sum())
    else:
        total += float(global_deletion_prior) * int(del_cols.sum())
    return total


def log10_prob_alignment(cigar, query, target, qa, ta,
                         tracks: Optional[QVTracks] = None,
                         read_accuracy_prior: float = 0.85,
                         substitution_prior: int = 20,
                         global_deletion_prior: int = 13) -> float:
    """log10 P(read | template placement) over the alignment path — the
    SMRTLogProbMatrix rescore feeding StoreMapQVs' log-sum-exp
    (BlasrUtilsImpl.hpp:117-130,236-304).

    With QVs: per-base error probabilities from the track; missing
    substitution/deletion tracks fall back to substitutionPrior /
    globalDeletionPrior (the IDSScoreFunction contract,
    BlasrUtilsImpl.hpp:125-130).  Without any QVs: fixed priors derived
    from read_accuracy_prior.
    """
    opc, qidx, tidx = expand_cigar(cigar, qa, ta)
    if len(opc) == 0:
        return -1e9
    eq = _col_eq(opc, qidx, tidx, query, target)

    def perr(track):
        if track is None or not len(track):
            return None
        v = np.minimum(np.asarray(track, np.float64)[
            np.clip(qidx, 0, len(track) - 1)], 93.0)
        return np.maximum(10.0 ** (-v / 10.0), 1e-10)

    qv_pe = perr(tracks.qual if tracks is not None else None)
    base_pe = (qv_pe if qv_pe is not None
               else np.full(len(opc), max(1.0 - read_accuracy_prior, 1e-4)))
    # per-column error probabilities; dedicated IDS tracks refine the
    # mismatch/insertion/deletion terms when present (iq/dq/sq tags)
    sub_pe = perr(tracks.sub_qv if tracks is not None else None)
    ins_pe = perr(tracks.ins_qv if tracks is not None else None)
    del_pe = perr(tracks.del_qv if tracks is not None else None)
    quality_mode = qv_pe is not None

    def prior_pe(prior_phred):
        return np.full(len(opc), 10.0 ** (-prior_phred / 10.0))

    mis_pe = sub_pe if sub_pe is not None else (
        prior_pe(substitution_prior) if quality_mode else base_pe)
    i_pe = ins_pe if ins_pe is not None else base_pe
    d_pe = del_pe if del_pe is not None else (
        prior_pe(global_deletion_prior) if quality_mode else base_pe)
    lm = np.log10(np.maximum(1.0 - base_pe, 1e-10))
    lx = np.log10(mis_pe / 3.0)
    li = np.log10(i_pe / 2.0)
    ld = np.log10(d_pe / 2.0)
    contrib = np.where(opc == OP_M, np.where(eq, lm, lx),
                       np.where(opc == OP_I, li, ld))
    return float(contrib.sum())


def full_qv_align(query, target, tracks=None, *, match_score: float = -5.0,
                  ins_flat: float = 5.0, del_flat: float = 5.0,
                  substitution_prior: int = 20,
                  global_deletion_prior: int = 13,
                  del_tag=None, sub_tag=None):
    """Full (unbanded) QV-steered global alignment — the FullQVAlign role
    (include map BlasrHeaders.h:45): optimize the IDS cost objective over
    the whole matrix and return ``(cigar, qv_score)``.

    Costs match the banded kernel's QV mode (kernels/banded.py):
    insertionQV per inserted base, deletionQV where the deleted target
    base equals the DeletionTag (else the global deletion prior),
    substitutionQV where the target base equals the SubstitutionTag
    (else the substitution prior); matches score ``match_score``.
    Host-side tool (O(nm) NumPy, row-vectorized) — the hot path runs the
    banded kernel; this exists for exhaustive small-problem alignment
    and as an oracle."""
    q = np.asarray(query, np.int64)
    t = np.asarray(target, np.int64)
    n, m = len(q), len(t)
    tr = tracks or QVTracks()
    iq = tr.get("ins_qv")
    dq = tr.get("del_qv")
    sq = tr.get("sub_qv")
    insq = (np.minimum(np.asarray(iq, np.float64)[:n], 255.0)
            if iq is not None else np.full(n, ins_flat))
    delq = (np.minimum(np.asarray(dq, np.float64)[:n], 255.0)
            if dq is not None else np.full(n, del_flat))
    subq = (np.minimum(np.asarray(sq, np.float64)[:n], 255.0)
            if sq is not None else np.full(n, substitution_prior))
    dtag = (np.asarray(del_tag, np.int64)[:n] if del_tag is not None
            else np.full(n, 7))
    stag = (np.asarray(sub_tag, np.int64)[:n] if sub_tag is not None
            else np.full(n, 7))
    dpri = (np.full(n, global_deletion_prior) if dq is not None
            else np.full(n, del_flat))
    spri = (np.full(n, substitution_prior) if sq is not None
            else np.full(n, substitution_prior))

    INF = 1e18
    M = np.full((n + 1, m + 1), INF)
    I = np.full((n + 1, m + 1), INF)
    D = np.full((n + 1, m + 1), INF)
    M[0, 0] = 0.0
    cd0 = np.where(t == dtag[0], delq[0], dpri[0]) if n else \
        np.full(m, del_flat)
    D[0, 1:] = np.cumsum(cd0)
    for i in range(1, n + 1):
        I[i, 0] = min(M[i - 1, 0], I[i - 1, 0]) + insq[i - 1]
        eq = t == q[i - 1]
        csub = np.where(eq & (q[i - 1] < 4), match_score,
                        np.where(t == stag[i - 1], subq[i - 1],
                                 spri[i - 1]))
        diag = np.minimum(np.minimum(M[i - 1, :m], I[i - 1, :m]),
                          D[i - 1, :m])
        M[i, 1:] = csub + diag
        I[i, 1:] = np.minimum(M[i - 1, 1:], I[i - 1, 1:]) + insq[i - 1]
        cd = np.where(t == dtag[i - 1], delq[i - 1], dpri[i - 1])
        S = np.cumsum(cd)
        base = np.minimum(M[i, :], I[i, :])
        g = base[:m] - np.concatenate([[0.0], S[:-1]])
        D[i, 1:] = S + np.minimum.accumulate(g)

    # traceback (recompute the comparisons; exact float equality holds —
    # integer-valued costs)
    ops = []
    i, j = n, m
    st = int(np.argmin([M[n, m], I[n, m], D[n, m]]))
    while i > 0 or j > 0:
        if st == 2 and j > 0:  # D
            r = max(i - 1, 0)
            cd = delq[r] if t[j - 1] == dtag[r] else dpri[r]
            ops.append(("D", 1))
            prev = D[i, j] - cd
            cand = [M[i, j - 1], I[i, j - 1], D[i, j - 1]]
            st = int(np.argmin(np.abs(np.asarray(cand) - prev)))
            j -= 1
        elif st == 1 and i > 0:  # I
            ops.append(("I", 1))
            prev = I[i, j] - insq[i - 1]
            st = 0 if abs(M[i - 1, j] - prev) <= abs(I[i - 1, j] - prev) \
                else 1
            i -= 1
        elif i > 0 and j > 0:  # M
            eqc = (t[j - 1] == q[i - 1]) and q[i - 1] < 4
            ops.append(("=" if eqc else "X", 1))
            csub = match_score if eqc else (
                subq[i - 1] if t[j - 1] == stag[i - 1] else spri[i - 1])
            prev = M[i, j] - csub
            cand = [M[i - 1, j - 1], I[i - 1, j - 1], D[i - 1, j - 1]]
            st = int(np.argmin(np.abs(np.asarray(cand) - prev)))
            i -= 1
            j -= 1
        else:
            st = 1 if i > 0 else 2
            continue
    ops.reverse()
    # merge runs; '='/'X' stay distinct so callers see mismatch columns
    cigar = []
    for op, c in ops:
        if cigar and cigar[-1][0] == op:
            cigar[-1] = (op, cigar[-1][1] + c)
        else:
            cigar.append((op, c))
    return cigar, float(min(M[n, m], I[n, m], D[n, m]))

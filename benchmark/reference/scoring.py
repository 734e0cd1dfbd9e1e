# Frozen copy of blasr_tpu_torch/pipeline/scoring.py: the plain PyTorch path only,
# imports pointed inside benchmark/reference (see __init__.py).
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



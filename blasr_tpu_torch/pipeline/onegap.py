# Copied from blasr_tpu/pipeline/onegap.py; only the imports differ.
"""One-gap alignment — the reference's ``OneGapAlignment`` role.

Reference: --onegap / separateGaps (RegisterBlasrOptions.h:41; used in
AlignIntervals when the target gap dwarfs the query gap,
BlasrAlignImpl.hpp:892-896): an alignment is allowed to jump one large
(intron-like) target gap without paying per-base deletion costs.

TPU-shaped realization: large target gaps split a read's hit into two
*collinear candidate alignments* (the banded kernel's slope-limited band
can't absorb them, so the chain produces two candidates).  ``join_one_gap``
merges such a pair into one alignment whose CIGAR carries a single 'N'
(skip) run — the alignment the reference's OneGapAlignment would have
produced, priced as one gap event instead of per-base deletions.

The merge runs in *oriented* coordinates (strand-local query positions
ascend with target positions on both strands, matching stored CIGAR
order), so forward and reverse pairs join alike.
"""

from __future__ import annotations

import dataclasses
from typing import List

from blasr_tpu_torch.pipeline.map_read import Alignment

MAX_ONE_GAP = 100_000


def _match_score(params) -> int:
    """Per-column score of a trimmed match (the matrix's match entry,
    not a literal: --scoreMatrix changes it)."""
    if getattr(params, "score_matrix", None):
        return -params.score_matrix[0][0]
    return 5


def join_one_gap(alns: List[Alignment], params) -> List[Alignment]:
    """Merge collinear same-strand alignment pairs of one read that are
    separated by a large target gap and a small query gap."""
    if len(alns) < 2:
        return alns

    def qo(a):
        return a.qstart if a.strand == 0 else a.qlen - a.qend

    def qo_end(a):
        return a.qend if a.strand == 0 else a.qlen - a.qstart

    alns = sorted(alns, key=lambda a: (a.strand, a.tindex, qo(a), a.tstart))
    out: List[Alignment] = []
    used = [False] * len(alns)
    for i, a in enumerate(alns):
        if used[i]:
            continue
        merged = a
        for j in range(i + 1, len(alns)):
            b = alns[j]
            if used[j]:
                continue
            if (b.strand != merged.strand or b.tindex != merged.tindex):
                continue
            q_gap = qo(b) - qo_end(merged)
            # one-gap criterion: query nearly contiguous (overlaps from the
            # span widening are trimmed as long as they stay a minority of
            # the shorter piece — larger overlaps mean alternative
            # placements of the same region, not a spliced continuation)
            shorter = min(merged.qend - merged.qstart, b.qend - b.qstart)
            if not (-256 <= q_gap <= 50 and -q_gap < 0.5 * shorter):
                continue
            if q_gap < 0:
                from blasr_tpu_torch.pipeline.longread import \
                    trim_cigar_query_start
                trimmed = trim_cigar_query_start(b.cigar or [], -q_gap)
                if trimmed is None:
                    continue
                new_cigar, q_rm, t_rm, (m_rm, i_rm) = trimmed
                b = dataclasses.replace(
                    b,
                    qstart=b.qstart + q_rm if b.strand == 0 else b.qstart,
                    qend=b.qend if b.strand == 0 else b.qend - q_rm,
                    tstart=b.tstart + t_rm,
                    n_match=max(b.n_match - m_rm, 0),
                    n_ins=max(b.n_ins - i_rm, 0),
                    score=b.score + _match_score(params) * m_rm,
                    cigar=new_cigar)
                q_gap = 0
            t_gap = b.tstart - merged.tend
            if not (max(q_gap, 0) * 4 < t_gap <= MAX_ONE_GAP):
                continue
            gap_cigar = []
            if q_gap:
                gap_cigar.append(("I", q_gap))
            gap_cigar.append(("N", t_gap))
            merged = Alignment(
                qname=merged.qname, qlen=merged.qlen,
                qstart=min(merged.qstart, b.qstart),
                qend=max(merged.qend, b.qend),
                strand=merged.strand, tindex=merged.tindex,
                tname=merged.tname, tlen=merged.tlen,
                tstart=merged.tstart, tend=b.tend,
                score=merged.score + b.score + params.affine_open,
                n_match=merged.n_match + b.n_match,
                n_mismatch=merged.n_mismatch + b.n_mismatch,
                n_ins=merged.n_ins + b.n_ins + q_gap,
                n_del=merged.n_del + b.n_del,
                cigar=(merged.cigar or []) + gap_cigar + (b.cigar or []),
                read=merged.read, qual=merged.qual,
                n_candidates=merged.n_candidates,
            )
            used[j] = True
        out.append(merged)
    return out

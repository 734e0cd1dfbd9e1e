# Copied from blasr_tpu/kernels/sw.py; only the imports differ.
"""Full (unbanded) pairwise DP — the reference's ``SWAlign``.

The reference uses SWAlign only in companion tools (utils/SDPMatcher.cpp:15
``-printsw``; extrautils/SWMatcher.cpp), never in the mapping hot path, so
this is a host-side NumPy implementation: row-sequential with fully
vectorized rows (the in-row deletion recurrence collapses to a running max
for linear gap costs).

Scores follow the reference's distance convention externally (lower =
better, SMRT matrix match -5 / mismatch 6) but run internally as
similarity maximization.  Alignment types mirror
algorithms/alignment/AlignmentType: Global, Local, QueryFit (query fully
aligned, free target ends), Overlap (free ends both sides).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

NEG = -10 ** 9

GLOBAL, LOCAL, QUERYFIT, OVERLAP = "global", "local", "queryfit", "overlap"


@dataclass
class SWAlignment:
    score: int            # distance convention (negative = better)
    q_start: int
    q_end: int            # exclusive
    t_start: int
    t_end: int            # exclusive
    cigar: List[Tuple[str, int]]   # M/I/D runs, query-forward order
    n_match: int = 0
    n_mismatch: int = 0
    n_ins: int = 0
    n_del: int = 0

    @property
    def pct_similarity(self) -> float:
        n = self.n_match + self.n_mismatch + self.n_ins + self.n_del
        return 100.0 * self.n_match / n if n else 0.0


def sw_align(query: np.ndarray, target: np.ndarray, *,
             match: int = -5, mismatch: int = 6,
             ins: int = 4, delete: int = 5,
             align_type: str = GLOBAL) -> SWAlignment:
    """Pairwise DP over 2-bit/4-code sequences (4 = N, never matches).

    match/mismatch/ins/delete use the distance convention of
    SMRTDistanceMatrix (+ --match/--mismatch deltas); returned score is
    the distance-convention total over the aligned path.
    """
    q = np.asarray(query, dtype=np.int8)
    t = np.asarray(target, dtype=np.int8)
    n, m = len(q), len(t)
    sm, sx, si, sd = -match, -mismatch, -ins, -delete   # similarity terms

    H = np.zeros((n + 1, m + 1), dtype=np.int32)
    # pointers: 0 stop/reset, 1 diag, 2 up (insertion), 3 left (deletion)
    ptr = np.zeros((n + 1, m + 1), dtype=np.uint8)
    j_idx = np.arange(m + 1, dtype=np.int64)

    free_t_start = align_type in (LOCAL, QUERYFIT, OVERLAP)
    free_q_start = align_type in (LOCAL, OVERLAP)
    if not free_t_start:
        H[0, :] = sd * j_idx
        ptr[0, 1:] = 3
    if not free_q_start:
        H[:, 0] = si * np.arange(n + 1, dtype=np.int64)
        ptr[1:, 0] = 2
    floor = 0 if align_type == LOCAL else NEG

    tv = t.astype(np.int32)
    for i in range(1, n + 1):
        sub = np.where((tv == q[i - 1]) & (q[i - 1] < 4) & (tv < 4), sm, sx)
        diag = H[i - 1, :-1] + sub
        up = H[i - 1, 1:] + si
        pre = np.maximum(diag, up)
        p = np.where(diag >= up, 1, 2).astype(np.uint8)
        if align_type == LOCAL:
            p = np.where(pre < 0, 0, p)
            pre = np.maximum(pre, 0)
        # left-gap runs collapse to a running max for linear costs
        seed = H[i, 0]
        a = np.concatenate([[seed - sd * 0], pre - sd * j_idx[1:]])
        run = np.maximum.accumulate(a)[:-1]
        left = run + sd * j_idx[1:]
        row = np.maximum(pre, left)
        p = np.where(left > pre, 3, p).astype(np.uint8)
        H[i, 1:] = row
        ptr[i, 1:] = p

    if align_type == GLOBAL:
        ei, ej = n, m
    elif align_type == QUERYFIT:
        ej = int(np.argmax(H[n, :]))
        ei = n
    elif align_type == OVERLAP:
        jn = int(np.argmax(H[n, :]))
        im = int(np.argmax(H[:, m]))
        if H[n, jn] >= H[im, m]:
            ei, ej = n, jn
        else:
            ei, ej = im, m
    else:  # LOCAL
        flat = int(np.argmax(H))
        ei, ej = flat // (m + 1), flat % (m + 1)

    # traceback
    ops: List[str] = []
    i, j = ei, ej
    while i > 0 or j > 0:
        p = ptr[i, j]
        if align_type == LOCAL and (p == 0 or H[i, j] == 0):
            break
        if p == 1:
            ops.append("M")
            i -= 1
            j -= 1
        elif p == 2:
            ops.append("I")
            i -= 1
        elif p == 3:
            ops.append("D")
            j -= 1
        else:
            break
        if align_type in (QUERYFIT, OVERLAP) and i == 0:
            break
        if align_type == OVERLAP and j == 0:
            break
    ops.reverse()
    qs, ts = i, j

    cigar: List[Tuple[str, int]] = []
    nm = nx = ni = nd = 0
    qi, ti = qs, ts
    for op in ops:
        if op == "M":
            if q[qi] == t[ti] and q[qi] < 4:
                nm += 1
            else:
                nx += 1
            qi += 1
            ti += 1
        elif op == "I":
            ni += 1
            qi += 1
        else:
            nd += 1
            ti += 1
        if cigar and cigar[-1][0] == op:
            cigar[-1] = (op, cigar[-1][1] + 1)
        else:
            cigar.append((op, 1))

    score = match * nm + mismatch * nx + ins * ni + delete * nd
    return SWAlignment(score=score, q_start=qs, q_end=ei, t_start=ts,
                       t_end=ej, cigar=cigar, n_match=nm, n_mismatch=nx,
                       n_ins=ni, n_del=nd)


def stick_print(aln: SWAlignment, query: np.ndarray, target: np.ndarray,
                out, width: int = 50, decode=None) -> None:
    """m0-style stick rendering of an SWAlignment
    (StickPrintAlignment analog)."""
    if decode is None:
        from blasr_tpu_torch.io.fasta import decode
    qs, ts, ms = [], [], []
    qi, ti = aln.q_start, aln.t_start
    for op, cnt in aln.cigar:
        for _ in range(cnt):
            if op == "M":
                qc = decode(query[qi:qi + 1])
                tc = decode(target[ti:ti + 1])
                qs.append(qc)
                ts.append(tc)
                ms.append("|" if qc == tc else " ")
                qi += 1
                ti += 1
            elif op == "I":
                qs.append(decode(query[qi:qi + 1]))
                ts.append("-")
                ms.append(" ")
                qi += 1
            else:
                qs.append("-")
                ts.append(decode(target[ti:ti + 1]))
                ms.append(" ")
                ti += 1
    qstr, mstr, tstr = "".join(qs), "".join(ms), "".join(ts)
    for i in range(0, len(qstr), width):
        out.write(f"  q: {qstr[i:i+width]}\n")
        out.write(f"     {mstr[i:i+width]}\n")
        out.write(f"  t: {tstr[i:i+width]}\n\n")

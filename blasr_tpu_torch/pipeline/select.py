# Copied from blasr_tpu/pipeline/select.py; the imports differ, and
# store_map_qvs times its rescore in a span (pipeline/metrics.py).
"""Alignment scoring aftermath: mapQV, filter criteria, hit policies.

Re-derivations of the reference's ``StoreMapQVs``
(iblasr/BlasrUtilsImpl.hpp:108-309), ``FilterCriteria`` / ``HitPolicy``
(datastructures/alignment/FilterCriteria usage at
BlasrUtilsImpl.hpp:925-947), and the per-ZMW deterministic random int
(Blasr.cpp:192-194) that makes random/randombest reproducible at any
parallelism degree (ctest/hitpolicy.t contract).
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import List, Sequence

import numpy as np

from blasr_tpu_torch.params import (MAPQV_END_ALIGN_WIGGLE,
                                    MAX_PHRED_SCORE, MappingParams)
from blasr_tpu_torch.pipeline.map_read import Alignment
from blasr_tpu_torch.pipeline.metrics import span

# score -> log-prob scale: Phred-like, ln(10)/10 per score unit
_LAMBDA = math.log(10.0) / 10.0


def zmw_rand_int(qname: str, seed: int) -> int:
    """Deterministic per-read random int, independent of batch shape and
    parallelism (counter-based equivalent of the reference's reader-drawn
    associatedRandInt)."""
    h = hashlib.sha256(f"{seed}:{qname}".encode()).digest()
    return int.from_bytes(h[:8], "little")


def _overlap_frac(a: Alignment, b: Alignment) -> float:
    lo = max(a.qstart, b.qstart)
    hi = min(a.qend, b.qend)
    if hi <= lo:
        return 0.0
    return (hi - lo) / max(1, min(a.qend - a.qstart, b.qend - b.qstart))


def partition_overlapping(alns: Sequence[Alignment],
                          min_frac: float) -> List[List[int]]:
    """Group alignment indices whose query intervals overlap by >= min_frac
    (PartitionOverlappingAlignments, BlasrUtilsImpl.hpp:411-444)."""
    groups: List[List[int]] = []
    for i, a in enumerate(alns):
        placed = False
        for g in groups:
            if any(_overlap_frac(a, alns[j]) >= min_frac for j in g):
                g.append(i)
                placed = True
                break
        if not placed:
            groups.append([i])
    return groups


def _log10_likelihood(a: Alignment, params: MappingParams, gi) -> float:
    """Rescore one alignment as log10 P(read | placement) — the
    SMRTLogProbMatrix rescore (BlasrUtilsImpl.hpp:117-130).  Falls back to
    a score-proportional likelihood when the CIGAR/genome is unavailable."""
    if gi is None or not a.cigar or a.read is None:
        return -a.score * _LAMBDA / math.log(10.0)
    if getattr(params, "ignore_qualities", True):
        a = dataclasses.replace(a, qual=None, tracks=None)
    from blasr_tpu_torch.io.fasta import revcomp
    from blasr_tpu_torch.pipeline.scoring import QVTracks, log10_prob_alignment
    rc = a.strand == 1

    def orient(v):
        if v is None:
            return None
        return v[::-1] if rc else v

    if not rc:
        oread, qa = a.read, a.qstart
    else:
        oread, qa = revcomp(a.read), a.qlen - a.qend
    qual = orient(a.qual)
    gs = gi.seqdb.chrom_to_genome(a.tindex, a.tstart)
    ge = gi.seqdb.chrom_to_genome(a.tindex, a.tend)
    t = a.tracks or {}
    tracks = QVTracks(qual=qual,
                      ins_qv=orient(t.get("InsertionQV")),
                      del_qv=orient(t.get("DeletionQV")),
                      sub_qv=orient(t.get("SubstitutionQV")))
    return log10_prob_alignment(a.cigar, oread, gi.genome[gs:ge], qa, 0,
                                tracks, params.read_accuracy_prior,
                                params.substitution_prior,
                                params.global_deletion_prior)


def _sum_mismatches(a: Alignment, full_start: int, full_end: int,
                    params: MappingParams) -> float:
    """SumMismatches (BlasrUtilsImpl.hpp:344-366): penalty for the query
    bases of the partition's full interval this alignment leaves
    uncovered — substitution QVs when available, else 15 per base."""
    t = a.tracks or {}
    subqv = t.get("SubstitutionQV")
    if not params.ignore_qualities and subqv is not None:
        return float(np.sum(subqv[full_start:a.qstart])
                     + np.sum(subqv[a.qend:full_end]))
    return 15.0 * ((a.qstart - full_start) + (full_end - a.qend))


def _phred(p: float) -> int:
    """Phred(p) = -10 log10 p, capped at MAX_PHRED_SCORE."""
    if p <= 0.0:
        return MAX_PHRED_SCORE
    return min(MAX_PHRED_SCORE, max(0, int(round(-10.0 * math.log10(p)))))


def store_map_qvs(alns: List[Alignment], params: MappingParams,
                  gi=None) -> None:
    """Assign mapQV per alignment: Phred of 1 - P(this | its overlap group),
    with P from a log-sum-exp over log-prob-rescored group members
    (StoreMapQVs, BlasrUtilsImpl.hpp:108-309).  Members trimmed more than
    MAPQV_END_ALIGN_WIGGLE short of the partition's widest member pay a
    mismatch penalty for the uncovered bases (:219-236)."""
    if not alns:
        return
    groups = partition_overlapping(alns, params.min_fraction_to_be_considered_overlapping)
    for g in groups:
        if len(g) == 1:
            alns[g[0]].map_qv = MAX_PHRED_SCORE
            if params.scale_mapqv_by_num_significant_clusters:
                scale_mapqv_by_cluster_size(alns[g[0]], params)
            continue
        with span("emit.rescore", len(g), timeline=False):
            lls = np.array([_log10_likelihood(alns[i], params, gi)
                            for i in g])
        # the partition's full interval is its widest member's query span
        spans = [(alns[i].qstart, alns[i].qend) for i in g]
        full_s, full_e = max(spans, key=lambda s: s[1] - s[0])
        for k, i in enumerate(g):
            s, e = spans[k]
            if (s - full_s > MAPQV_END_ALIGN_WIGGLE
                    or full_e - e > MAPQV_END_ALIGN_WIGGLE):
                lls[k] += -0.5 * _sum_mismatches(
                    alns[i], full_s, full_e, params)
        mx = lls.max()
        lse = mx + math.log10(np.power(10.0, lls - mx).sum())
        for k, i in enumerate(g):
            sub = lls[k] - lse
            if sub < -20.0:  # overflow guard (BlasrUtilsImpl.hpp:268)
                qv = 0
            else:
                expo = 10.0 ** sub
                diff = 1.0 - expo
                if expo == 0.0:
                    qv = 0
                elif diff == 0.0:
                    qv = MAX_PHRED_SCORE
                else:
                    qv = _phred(diff)
            alns[i].map_qv = qv
            if params.scale_mapqv_by_num_significant_clusters:
                scale_mapqv_by_cluster_size(alns[i], params)


def scale_mapqv_by_cluster_size(a: Alignment, params: MappingParams) -> None:
    """ScaleMapQVByClusterSize (BlasrUtilsImpl.hpp:97-106): more
    significant anchor clusters than candidate slots means unexamined
    competitor placements, so confidence is scaled down; zero significant
    clusters means the placement is not anchor-supported at all."""
    if a.n_significant_clusters > params.n_candidates:
        p_correct = 1.0 - 10.0 ** (-a.map_qv / 10.0)
        a.map_qv = _phred(
            p_correct * params.n_candidates / a.n_significant_clusters)
    elif a.n_significant_clusters == 0:
        a.map_qv = 0


def num_significant_clusters(alns: List[Alignment], cluster_bases,
                             params: MappingParams, *, k: int) -> int:
    """numSignificantClusters (BlasrAlignImpl.hpp:391-488): compare the
    best alignment's anchor bases against the expected anchor-base
    distribution for a true placement, then count clusters at least as
    large as the scaled minimum expectation.

    The reference looks the mean/sd up in the precompiled
    ``PacBio::AnchorDistributionTable`` (libcpp, absent); here they are
    derived analytically from the aligned length, the best alignment's
    percent similarity and the seed size k: with per-base accuracy p a
    read of length L has ~L(1-p) maximal exact runs whose length is
    geometric, giving expected bases in runs >= k of
    L(1-p)p^k(k + p/(1-p)); sd is taken as mean/4 (Poisson-ish run
    counts).  cluster_bases is the ClusterList analog: the chain weights
    of candidates that passed the significance gate on either strand."""
    if not alns:
        return 0
    best = min(alns, key=lambda a: a.score)
    L = max(best.qend - best.qstart, 1)
    prior = getattr(params, "accuracy_prior", 0.0)
    p_acc = (min(max(prior, 0.75), 0.999) if prior > 0
             else min(max(best.pct_similarity / 100.0, 0.75), 0.999))
    e = 1.0 - p_acc
    mean_ab = L * e * (p_acc ** k) * (k + p_acc / e)
    sd_ab = mean_ab / 4.0
    ab = max(float(best.cluster_weight), 1.0)
    if ab > mean_ab + sd_ab:
        return 1
    nsig = 0
    if best.score < params.max_score:
        cl = np.asarray(cluster_bases, dtype=np.float64)
        if cl.size:
            min_exp = max(mean_ab - 2.0 * sd_ab, 0.0)
            scaled = float(cl.max()) / ab * min_exp
            nsig = int((cl >= scaled).sum())
    return nsig


def prune_alignments(alns: List[Alignment], params: MappingParams,
                     read_len: int = 0) -> List[Alignment]:
    """The reference's alignment-level pruning family, applied in its
    order on the score-sorted candidate list (BlasrAlignImpl.hpp:358-383):

    1. RemoveLowQualitySDPAlignments (BlasrUtilsImpl.hpp:447-474):
       cumulative matched bases over the list must reach
       sdpTupleSize/50 * readLength (the reference accumulates across
       alignments; kept faithfully).
    2. RemoveLowQualityAlignments (:476-519): the first of the leading
       nCandidates alignments with no blocks or score worse than
       maxScore cuts the rest of the (score-sorted) list.  maxScore
       applies unconditionally here, as in the reference.
    3. RemoveOverlappingAlignments (:523-605): same-contig alignments
       whose genomic span is contained in a better-scoring one are
       dropped.
    """
    alns = sorted(alns, key=_sort_key)
    rl = read_len if read_len else (alns[0].qlen if alns else 0)
    expected = params.sdp_tuple_size / 50.0 * rl
    total = 0
    kept = []
    for a in alns:
        total += a.n_match
        if total >= expected:
            kept.append(a)
    alns = kept
    cut = len(alns)
    for i in range(min(params.n_candidates, len(alns))):
        if not alns[i].cigar or alns[i].score > params.max_score:
            cut = i
            break
    alns = alns[:cut]
    contained = [False] * len(alns)
    for i in range(max(len(alns) - 1, 0)):
        a = alns[i]
        if a.pct_similarity < params.min_pct_similarity:
            continue
        for j in range(i + 1, len(alns)):
            if contained[j]:
                continue
            b = alns[j]
            if a.tindex != b.tindex:
                continue
            if a.tstart <= b.tstart and a.tend >= b.tend:
                if a.score <= b.score:
                    contained[j] = True
            elif b.tstart <= a.tstart and b.tend >= a.tend:
                if b.score <= a.score:
                    contained[i] = True
    return [a for a, c in zip(alns, contained) if not c]


def pct_accuracy(a: Alignment) -> float:
    n = a.n_match + a.n_mismatch + a.n_ins + a.n_del
    return 100.0 * a.n_match / n if n else 0.0


def satisfies_filters(a: Alignment, params: MappingParams) -> bool:
    """FilterCriteria.Satisfy (RegisterFilterOptions.h semantics)."""
    if a.qend - a.qstart < params.min_aln_length:
        return False
    if a.pct_similarity < params.min_pct_similarity:
        return False
    if pct_accuracy(a) < params.min_pct_accuracy:
        return False
    if params.use_score_cutoff and a.score > params.max_score:
        return False
    return True


def _sort_key(a: Alignment):
    # lower score is better; deterministic tie-break
    return (a.score, a.tindex, a.tstart, a.strand, a.qstart)


def select_alignments(
    alns: List[Alignment], params: MappingParams, rand_int: int,
) -> List[Alignment]:
    """SelectAlignmentsToPrint (BlasrUtilsImpl.hpp:925-947): sort by score,
    filter, truncate to nBest, apply hit policy with the read's
    deterministic random int."""
    alns = sorted(alns, key=_sort_key)
    alns = [a for a in alns if satisfies_filters(a, params)]
    if not alns:
        return []
    alns = alns[: params.n_best]
    if params.print_only_best:  # --printOnlyBest (RegisterBlasrOptions.h:38)
        alns = alns[:1]
    policy = params.hit_policy
    if policy == "all":
        return alns
    best = alns[0].score
    best_set = [a for a in alns if a.score == best]
    if policy == "allbest":
        return best_set
    if policy == "leftmost":
        return [min(alns, key=lambda a: (a.tindex, a.tstart, a.strand))]
    if policy == "random":
        return [alns[rand_int % len(alns)]]
    if policy == "randombest":
        return [best_set[rand_int % len(best_set)]]
    raise ValueError(f"unknown hit policy {policy!r}")

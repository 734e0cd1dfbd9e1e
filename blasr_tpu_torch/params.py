# Copied from blasr_tpu/params.py; only the imports differ (blasr_tpu -> blasr_tpu_torch).
"""Mapping configuration.

TPU-native equivalent of the reference's ``MappingParameters``
(``iblasr/MappingParameters.h:207-381`` defaults, ``:390-689`` MakeSane).
Two layers:

  * :class:`MappingParams` — the user-facing algorithm parameters, with the
    reference's field names and default values, plus ``make_sane()``
    performing the same cross-field normalizations that the reference's
    tests exercise.
  * :class:`ShapeConfig` — TPU-only static-shape knobs (bucket lengths,
    anchor capacity, band width, batch size).  These have no reference
    counterpart: they exist because everything under ``jit`` must have
    static shapes.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

# Reference SMRTDistanceMatrix semantics (lower is better): match -5,
# mismatch 6, anything vs N 6 (documented at
# iblasr/RegisterBlasrOptions.h:350-360).
DEFAULT_MATCH = -5
DEFAULT_MISMATCH = 6

MAPQV_END_ALIGN_WIGGLE = 5  # iblasr/BlasrHeaders.h:19
MAX_PHRED_SCORE = 254  # iblasr/BlasrHeaders.h:20


def default_score_matrix(match_bonus: int = 0, mismatch_penalty: int = 0):
    """5x5 ACGTN score matrix, reference SMRTDistanceMatrix + CLI deltas.

    ``Blasr.cpp:910-917`` adds --mismatch to off-diagonals and --match to
    diagonals of the built-in matrix.
    """
    m = [[DEFAULT_MISMATCH] * 5 for _ in range(5)]
    for i in range(4):
        m[i][i] = DEFAULT_MATCH + match_bonus
    for i in range(5):
        for j in range(5):
            if i != j or i == 4:
                m[i][j] += mismatch_penalty
    return m


@dataclass
class MappingParams:
    """Algorithm parameters. Field names/defaults follow
    iblasr/MappingParameters.h:207-381."""

    # scoring
    match: int = 0            # added to matrix diagonal
    mismatch: int = 0         # added to matrix off-diagonal
    insertion: int = 4        # asymmetric indel penalties
    deletion: int = 5
    indel: int = 5
    sdp_indel: int = 5
    sdp_ins: int = 5
    sdp_del: int = 10
    affine_align: bool = False
    affine_open: int = 10
    affine_extend: int = 0
    score_matrix: Optional[List[List[int]]] = None  # --scoreMatrix
    max_score: int = -200     # scoreCutoff (lower=better; keep score <= this)
    use_score_cutoff: bool = False

    # anchoring
    min_match_length: int = 12          # --minMatch
    max_match_length: int = 0           # --maxMatch (maxLCPLength; 0 = off)
    max_anchors_per_position: int = 10000
    advance_exact_matches: int = 0
    expand: int = 0                     # current expand (minExpand..maxExpand retry loop)
    max_expand: int = 0
    min_expand: int = 0
    lookup_table_length: int = 8

    # clustering / candidate intervals
    n_candidates: int = 10
    indel_rate: float = 0.3
    p_value_type: int = 0               # 0 tuple-freq pvalue, 1 match-freq, 2 sum-log-p
    fast_max_interval: bool = False
    aggressive_interval_cut: bool = False
    advance_half: bool = False
    warp: bool = True
    global_chain_type: int = 0
    max_lis_p_value: float = 30.0
    min_interval_weight: float = 0.0    # min summed anchor bases for a candidate
    # anchor-bases charged per base of diagonal drift in the CANDIDATE
    # chain (kernels.chain drift_penalty); 0 keeps the reference's
    # drift-free LIS weightor ranking.  The guide-extraction pass always
    # runs penalized (map_batch guide_drift) regardless of this knob.
    candidate_drift_penalty: float = 0.0
    # merge the ambiguity-rescue deep pass's full-span competitor
    # alignments into the read's alignment list even when its best score
    # does not beat the original (they carry the phase-ambiguity evidence
    # StoreMapQVs needs for repeat-interior reads: the reference aligns
    # every interval against the full read span, so its mapQV partition
    # sees near-tie competitors that our chain-span-bounded DP clips to
    # low-scoring fragments — tools/diag_str.py).  Off by default to keep
    # default output reference-faithful.
    full_span_mapqv: bool = False

    # SDP
    sdp_tuple_size: int = 11
    detailed_sdp_alignment: bool = True
    fast_sdp: bool = False
    sdp_bypass_threshold: float = 1e6
    recurse_over: int = 10000

    # refinement
    refine_alignments: bool = True
    use_guided_align: bool = True
    guided_align_band_size: int = 10
    band_size: int = 0                  # 0 -> derived (16 when guided)
    extend_alignments: bool = False
    extend_band_size: int = 10
    max_extend_dropoff: int = 10
    refine_between_anchors_only: bool = False

    # filtering / selection
    n_best: int = 10
    min_aln_length: int = 0
    min_pct_similarity: float = 0.0
    min_pct_accuracy: float = 0.0
    hit_policy: str = "all"             # all | allbest | random | randombest | leftmost
    use_random_seed: bool = False
    random_seed: int = 0
    min_read_length: int = 50
    max_read_length: int = 0
    min_subread_length: int = 0
    # raw HQ-region read score gate, [0, 1000]; -1 = off
    # (--minRawSubreadScore, MappingParameters.h:121,292, Blasr.cpp:56-85)
    min_raw_subread_score: int = -1
    min_avg_qual: int = 0          # average-quality read gate
    #                                (--minAvgQual, Blasr.cpp:81)
    place_randomly: bool = False   # deprecated alias: forces randombest
    #                                (MakeSane, MappingParameters.h:466-468)
    use_region_table: bool = True   # --ignoreRegions flips off
    use_hq_region_table: bool = True  # --ignoreHQRegions flips off
    do_global_alignment: bool = False  # --global: window stretched to the
    #                                whole read span (BlasrAlignImpl.hpp:645;
    #                                span widening is always on here)
    accuracy_prior: float = 0.0    # --accuracyPrior (readAccuracyPrior):
    #                                overrides the derived accuracy in the
    #                                anchor-distribution significance gate
    sam_qv_list: tuple = ()        # --samQV names; () = all present tracks
    min_ratio: float = 0.25
    min_fraction_to_be_considered_overlapping: float = 0.75

    # mapQV
    store_map_qv: bool = True
    scale_mapqv_by_num_significant_clusters: bool = False
    substitution_prior: int = 20
    global_deletion_prior: int = 13
    read_accuracy_prior: float = 0.85
    ignore_qualities: bool = True   # reference default (--useQuality opts in)
    score_type: int = 0             # --scoreType: 0 = distance-matrix
    #                                 rescore of the (possibly QV-chosen)
    #                                 path; 1 = report the QV DP score
    #                                 itself (alignment.sumQVScore,
    #                                 BlasrAlignImpl.hpp:1306-1308)

    # modes
    forward_only: bool = False
    map_subreads_separately: bool = True
    concordant: bool = False
    refine_concordant_alignments: bool = False
    concordant_template: str = "mediansubread"
    concordant_align_both_directions: bool = False
    flank_size: int = 40
    use_ccs: bool = False
    use_ccs_only: bool = False
    use_all_subreads_in_ccs: bool = False

    # output
    print_format: str = "m1"            # m0..m5 | sam | bam
    clipping: str = "none"              # none | hard | soft | subread
    print_sam_qv: bool = False
    cigar_use_seq_match: bool = False   # =/X CIGAR ops
    allow_adjacent_indels: bool = False
    print_only_best: bool = False
    print_unaligned: bool = False
    print_unaligned_names_only: bool = False
    print_header: bool = False
    preserve_read_title: bool = False
    print_subread_title: bool = True
    title_table_name: str = ""

    # sharding (reference --start/--stride, Blasr.cpp:1270)
    start_read: int = 0
    stride: int = 1
    subsample: float = 1.1
    hole_number_ranges: str = ""

    # misc
    nproc: int = 1
    verbosity: int = 0
    emulate_nucmer: bool = False
    do_sensitive_search: bool = False

    def make_sane(self) -> "MappingParams":
        """Cross-field normalization, mirroring MakeSane()
        (iblasr/MappingParameters.h:390-689) for the fields we model."""
        p = dataclasses.replace(self)
        # nucmer emulation preset (SetEmulateNucmer,
        # MappingParameters.h:717-726)
        if p.emulate_nucmer:
            p.min_match_length = 30
            p.max_score = -200
            p.n_best = 1
            p.n_candidates = 1
            p.max_match_length = 30  # maxLCPLength = 30
            p.cigar_use_seq_match = True
            p.advance_exact_matches = 30
            p.max_anchors_per_position = 1
            p.sdp_bypass_threshold = 0.75
            p.sdp_tuple_size = 15
            p.refine_alignments = False
        # placeRepeatsRandomly forces the randombest hit policy
        # (MakeSane, MappingParameters.h:466-468)
        if p.place_randomly and p.hit_policy != "randombest":
            import sys as _s
            _s.stderr.write(
                "Warning: placeRepeatsRandomly is deprecated, resetting "
                "hit policy to randombest.\n")
            p.hit_policy = "randombest"
        # raw subread score lives in [0, 1000] (MakeSane :674-676)
        if p.min_raw_subread_score > 1000:
            p.min_raw_subread_score = 1000
        # minMatch must be >= lookupPrefixLength (Blasr.cpp:1110-1126)
        if p.min_match_length < p.lookup_table_length:
            p.min_match_length = p.lookup_table_length
        # guided-align default band (MappingParameters.h:501-503)
        if p.band_size == 0:
            p.band_size = 16 if p.use_guided_align else 15
        import sys as _sys
        # hit policy implies randomness seeding
        if p.hit_policy in ("random", "randombest") and not p.use_random_seed:
            p.use_random_seed = False  # seeded from time in reference; we default 0
        if p.hit_policy in ("random", "randombest") and p.n_best == 1:
            _sys.stderr.write(
                "Warning: When attempting to select equivalently scoring "
                "reads at random\nthe bestn parameter should be greater "
                "than one.\n")  # MappingParameters.h:470-473
        # concordant + useCcs: concordant is dropped (MakeSane :476-478)
        if p.concordant and p.use_ccs:
            p.concordant = False
        # concordant implies subreads mapped separately against a template
        if p.concordant:
            p.map_subreads_separately = False
        if p.use_ccs_only:
            p.use_ccs = True
        if p.use_all_subreads_in_ccs:
            p.use_ccs = True
        if p.n_best > p.n_candidates:
            p.n_candidates = p.n_best
        if (p.max_match_length != 0
                and p.max_match_length < p.min_match_length):
            _sys.stderr.write(
                "ERROR: maxLCPLength is less than minLCPLength, which "
                "will result in no hits.\n")  # MakeSane :546-548
        if p.subsample < 1.0 and p.stride > 1:
            # reference: hard error (MakeSane :550-553)
            raise ValueError(
                "ERROR, subsample and stride must be used independently.")
        if p.subsample < 1.0:
            p.start_read = 0
            p.stride = 1
        if p.score_matrix is None:
            p.score_matrix = default_score_matrix(p.match, p.mismatch)
        return p


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclass(frozen=True)
class ShapeConfig:
    """Static-shape configuration for the jitted pipeline (TPU-only).

    No reference counterpart; these pad the ragged problem
    (reads 50 bp..100 kbp, anchors varying by 1e4) onto fixed shapes.
    """

    # length buckets: reads are padded up to the smallest bucket >= len;
    # reads beyond the last bucket map by their first bucket-length bases
    # (a warning is emitted — raise the cap for ultra-long libraries)
    buckets: Tuple[int, ...] = (512, 1024, 2048, 4096, 8192, 16384,
                                32768, 65536)
    batch_size: int = 32          # reads per device batch
    max_anchors: int = 512        # anchors kept per read per strand (post top-k)
    occ_per_pos: int = 3          # SA hits taken per read position pre top-k
    full_widen: bool = False      # widen every candidate's DP span to the
    #                               whole read (ambiguity-rescue deep pass;
    #                               map_read margin comment for why not
    #                               default)
    occ_block_sample: bool = False  # contiguous rotating-window occurrence
    #                               sampling: one [O, 6]-slice gather per
    #                               position instead of O row gathers
    #                               (kernels.anchor; perf experiment knob,
    #                               env BLASR_TPU_OCC_BLOCK=1)
    anchor_ext: int = 20          # max exact-match extension beyond k measured
    #                               (tuned on the bench workload: same
    #                               placement accuracy as 36/4, ~12% faster)
    band_width: int = 128         # banded-DP band (lane-aligned)
    guide_anchors: int = 96       # chain members walked per candidate for
    #                               the band guide; the SDP hit fragments
    #                               provide the dense path, so the chain
    #                               walk only supplies flanking anchors
    n_candidates: int = 10        # candidate intervals refined per read
    hbm_budget: int = 1 << 28     # device bytes allowed for the traceback
    #                               arrow matrices (caps the effective
    #                               batch per bucket, Mapper.batch_size_for)
    dp_cands: int = 0             # candidates per read that get banded DP;
    #                               0 = all (reference semantics: every
    #                               WeightedInterval is aligned); >0 caps
    #                               the DP rows per batch with per-read
    #                               fairness (each read keeps its top
    #                               dp_cands candidates)
    window_pad: float = 0.35      # genome window = bucket*(1+window_pad)

    def bucket_for(self, length: int) -> int:
        for b in self.buckets:
            if length <= b:
                return b
        return self.buckets[-1]

    def window_len(self, bucket: int) -> int:
        return round_up(int(bucket * (1.0 + self.window_pad)) + 2 * self.band_width, 128)

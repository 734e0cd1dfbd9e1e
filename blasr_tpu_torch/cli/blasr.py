"""blasr-equivalent CLI driver on PyTorch (port of blasr_tpu/cli/blasr.py).

The same flow and flags as the JAX package's driver: parse options ->
make_sane -> load/build index -> map reads in batches -> mapQV ->
filter/nbest/hit-policy -> print.  ``--device`` picks the torch device
(default ``cuda``; there is no silent fallback to the CPU).
``--affineAlign`` (the homopolymer-insertion band) is not ported yet and
is rejected with an error.

Run: ``python -m blasr_tpu_torch.cli.blasr reads.fa genome.fa -m 4``.
"""

from __future__ import annotations

import argparse
import contextlib
import sys
import time
from typing import List, Optional

from blasr_tpu_torch.index.genome import GenomeIndex, build_genome_index
from blasr_tpu_torch.io import formats
from blasr_tpu_torch.io.fasta import read_fasta, read_sequences
from blasr_tpu_torch.io.fofn import expand_file_name_list
from blasr_tpu_torch.params import MappingParams
from blasr_tpu_torch.pipeline.map_read import Mapper
from blasr_tpu_torch.pipeline.select import (select_alignments, store_map_qvs,
                                             zmw_rand_int)


_DISCUSSION = """\
Input: reads may be FASTA, FASTQ, unaligned BAM, bax/ccs.h5, DataSet XML
or a FOFN of those; the genome is a (multi-)FASTA.  Precomputed indexes
(--sa from sawriter, --bwt from sa2bwt, --ctab from printTupleCountTable)
skip the on-the-fly build.

Speed/sensitivity levers (RegisterBlasrOptions.h:294-349 semantics):
  --minMatch      larger seeds are faster but less sensitive
  --fastMaxInterval / --advanceHalf
                  less exhaustive interval search, much faster
  --aggressiveIntervalCut
                  drop non-promising candidates (ignores ALU echoes)
  --fastSDP       lighter SDP fragment search
  --nCandidates / --bestn
                  how many intervals are aligned / reported

Output: -m 0..5 (stick/summary/XML/vulgar/interval/parsable), --sam or
--bam, with --clipping none|soft|hard|subread; --unaligned FILE lists
unmapped reads.  Hit selection: --hitPolicy all|allbest|random|
randombest|leftmost with per-ZMW deterministic randomness, so output is
byte-identical at any batch size or host count.

Citation: Chaisson M.J., Tesler G. Mapping single molecule sequencing
reads using basic local alignment with successive refinement (BLASR).
BMC Bioinformatics 2012, 13:238."""


def build_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="blasr_tpu_torch",
        description="long-read mapper with BLASR's capabilities "
                    "(PyTorch/CUDA port of blasr_tpu)",
        epilog=_DISCUSSION,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("reads", help="reads file (fasta/fastq/fofn)")
    ap.add_argument("genome", help="reference genome fasta")
    ap.add_argument("--out", "-o", default="-", help="output file")
    ap.add_argument("-m", dest="printFormat", type=int, default=None,
                    help="output format 0..5 (m0..m5)")
    ap.add_argument("--sam", action="store_true", help="SAM output")
    ap.add_argument("--bam", action="store_true", help="BAM output")
    ap.add_argument("--sa", default=None, help="prebuilt index (.npz)")
    ap.add_argument("--bwt", default=None,
                    help="prebuilt BWT index (.npz, from sa2bwt); converted "
                         "to the runtime k-mer index at load")
    ap.add_argument("--ctab", default=None, help="(accepted; ctab is part of the index)")
    ap.add_argument("--minMatch", type=int, default=12)
    ap.add_argument("--maxMatch", type=int, default=0)
    ap.add_argument("--maxAnchorsPerPosition", type=int, default=10000)
    ap.add_argument("--advanceExactMatches", type=int, default=0)
    ap.add_argument("--nCandidates", type=int, default=10)
    ap.add_argument("--bestn", type=int, default=10)
    ap.add_argument("--maxScore", type=int, default=-200)
    # filter options + the reference's aliases (RegisterFilterOptions.h)
    ap.add_argument("--minAlnLength", "--minAlignLength", "--minLength",
                    dest="minAlnLength", type=int, default=0)
    ap.add_argument("--minPctSimilarity", "--minPctIdentity",
                    dest="minPctSimilarity", type=float, default=0.0)
    ap.add_argument("--minPctAccuracy", "--minAccuracy",
                    dest="minPctAccuracy", type=float, default=0.0)
    ap.add_argument("--scoreCutoff", type=int, default=None,
                    help="alias of --maxScore (enables the score filter)")
    ap.add_argument("--scoreSign", type=int, default=-1, choices=[-1, 1],
                    help="-1: lower scores are better (the only supported "
                         "sign; +1 is rejected loudly)")
    ap.add_argument("--hitPolicy", default="all",
                    choices=["all", "allbest", "random", "randombest", "leftmost"])
    ap.add_argument("--randomSeed", type=int, default=0)
    ap.add_argument("--minReadLength", type=int, default=50)
    ap.add_argument("--maxReadLength", type=int, default=0)
    ap.add_argument("--indel", type=int, default=5)
    ap.add_argument("--insertion", type=int, default=4)
    ap.add_argument("--deletion", type=int, default=5)
    ap.add_argument("--match", type=int, default=0)
    ap.add_argument("--mismatch", type=int, default=0)
    ap.add_argument("--affineAlign", action="store_true")
    ap.add_argument("--affineOpen", type=int, default=10)
    ap.add_argument("--affineExtend", type=int, default=0)
    ap.add_argument("--indelRate", type=float, default=0.3)
    ap.add_argument("--clipping", default="none",
                    choices=["none", "hard", "soft", "subread"])
    ap.add_argument("--cigarUseSeqMatch", action="store_true")
    ap.add_argument("--allowAdjacentIndels", action="store_true")
    ap.add_argument("--header", action="store_true", help="print header")
    ap.add_argument("--forwardOnly", action="store_true")
    ap.add_argument("--preserveReadTitle", action="store_true")
    ap.add_argument("--unaligned", default=None, help="unaligned reads file")
    ap.add_argument("--noPrintUnalignedSeqs", action="store_true")
    ap.add_argument("--start", type=int, default=0, help="start read index")
    ap.add_argument("--stride", type=int, default=1, help="read stride")
    ap.add_argument("--subsample", type=float, default=1.1)
    ap.add_argument("--nproc", type=int, default=1,
                    help="accepted for compatibility; device batch is used")
    ap.add_argument("--scaleMapQVByNClusters", action="store_true")
    ap.add_argument("--noStoreMapQV", action="store_true",
                    help="skip mapQV computation (RegisterBlasrOptions.h:55)")
    ap.add_argument("--printOnlyBest", action="store_true")
    ap.add_argument("--concordant", action="store_true")
    ap.add_argument("--useccs", action="store_true")
    ap.add_argument("--useccsall", action="store_true")
    ap.add_argument("--useccsdenovo", action="store_true")
    # anchoring / expansion
    ap.add_argument("--maxLCPLength", type=int, default=None,
                    help="alias of --maxMatch")
    ap.add_argument("--maxExpand", "-M", type=int, default=0)
    ap.add_argument("--minExpand", type=int, default=0)
    # intervals / weighting
    ap.add_argument("--pvaltype", "-pvaltype", type=int, default=0,
                    choices=[0, 1, 2])
    ap.add_argument("--fastMaxInterval", action="store_true")
    ap.add_argument("--aggressiveIntervalCut", action="store_true")
    ap.add_argument("--advanceHalf", action="store_true")
    ap.add_argument("--useSensitiveSearch", action="store_true")
    ap.add_argument("--minRatio", type=float, default=0.25,
                    help="accepted for reference compatibility (the "
                         "reference parses but never reads it)")
    # accepted-but-unsupported interval-search internals: rejected loudly
    # below instead of silently parsing
    ap.add_argument("--nowarp", action="store_true")
    ap.add_argument("--globalChainType", type=int, default=0)
    # SDP / refinement
    ap.add_argument("--sdpTupleSize", type=int, default=11)
    ap.add_argument("--sdpIns", type=int, default=5)
    ap.add_argument("--sdpDel", type=int, default=10)
    ap.add_argument("--fastSDP", action="store_true")
    ap.add_argument("--refineBetweenAnchorsOnly", action="store_true")
    ap.add_argument("--noRefineAlignments", action="store_true")
    ap.add_argument("--useGuidedAlign", action="store_true", default=True)
    ap.add_argument("--noUseGuidedAlign", action="store_true")
    ap.add_argument("--bandSize", type=int, default=0)
    ap.add_argument("--guidedAlignBandSize", type=int, default=10)
    ap.add_argument("--extend", action="store_true")
    ap.add_argument("--maxExtendDropoff", type=int, default=10)
    ap.add_argument("--onegap", action="store_true",
                    help="join collinear hits across one large target gap")
    # scoring
    ap.add_argument("--scoreMatrix", default=None,
                    help="25 space-separated ACGTN x ACGTN scores")
    ap.add_argument("--substitutionPrior", type=int, default=20)
    ap.add_argument("--deletionPrior", type=int, default=13)
    ap.add_argument("--useQuality", action="store_true",
                    help="use FASTQ/BAM quality values in rescoring")
    # concordant details
    ap.add_argument("--concordantTemplate", default="mediansubread",
                    choices=["mediansubread", "longestsubread",
                             "typicalsubread"])
    ap.add_argument("--concordantAlignBothDirections", action="store_true")
    ap.add_argument("--flankSize", type=int, default=40)
    ap.add_argument("--refineConcordantAlignments", action="store_true")
    ap.add_argument("--noSplitSubreads", action="store_true")
    ap.add_argument("--minSubreadLength", type=int, default=0)
    ap.add_argument("--minRawSubreadScore", type=int, default=-1)
    # selection / output extras
    ap.add_argument("--holeNumbers", default=None,
                    help="ZMW hole-number ranges, e.g. 1,2,10-12")
    ap.add_argument("--titleTable", default=None,
                    help="title table file: output tName becomes its index")
    ap.add_argument("--printSAMQV", action="store_true")
    ap.add_argument("--noPrintSubreadTitle", action="store_true")
    # observability
    ap.add_argument("--profileDir", default=None,
                    help="write a torch.profiler trace of the mapping phase")
    ap.add_argument("--device", default="cuda",
                    help="torch device the mapping runs on (cuda, cuda:N "
                         "or cpu); cuda without a card is an error")
    ap.add_argument("--metrics", default=None, help="timing summary file")
    ap.add_argument("--fullMetrics", default=None,
                    help="per-call timing lists file")
    ap.add_argument("--anchors", default=None, help="raw anchor dump file")
    ap.add_argument("--printDotPlots", action="store_true",
                    help="write a per-read <name>.anchors dot-plot file")
    ap.add_argument("--clusters", default=None,
                    help="per-read cluster statistics file")
    ap.add_argument("-V", "--verbose", type=int, default=0, nargs="?", const=1)
    # remaining reference registry rows (RegisterBlasrOptions.h:28-179):
    # wired where machinery exists; structurally-obviated knobs accepted
    # and classified in tests/test_param_coverage.py; unsupported requests
    # rejected loudly in run()
    ap.add_argument("--nucmer", "--emulateNucmer", dest="nucmer",
                    action="store_true")
    ap.add_argument("--placeRepeatsRandomly", action="store_true")
    ap.add_argument("--minAvgQual", type=int, default=0)
    ap.add_argument("--ignoreRegions", action="store_true")
    ap.add_argument("--ignoreHQRegions", action="store_true")
    ap.add_argument("--regionTable", default=None,
                    help="separate region-table rgn.h5 (DEPRECATED)")
    ap.add_argument("--global", dest="globalAlign", action="store_true")
    ap.add_argument("--accuracyPrior", type=float, default=0.0)
    # TPU-build extension: charge the candidate chain |dt-dq| anchor-bases
    # per base of diagonal drift (0 = reference LIS weightor semantics;
    # the ambiguity-rescue deep pass always ranks penalized)
    ap.add_argument("--candidateDriftPenalty", type=float, default=0.0)
    # TPU-build extension: keep the rescue deep pass's full-span
    # competitor alignments for the mapQV partition (repeat-interior
    # phase-ambiguity calibration; tools/diag_str.py)
    ap.add_argument("--fullSpanMapQV", action="store_true")
    ap.add_argument("--samQV", nargs="+", default=None,
                    help="QV tracks to print as SAM tags (implies "
                         "--printSAMQV)")
    ap.add_argument("--extendBandSize", type=int, default=10)
    ap.add_argument("--sdpindel", type=int, default=None,
                    help="sets both sdpIns and sdpDel")
    ap.add_argument("--sdpbypass", type=float, default=None,
                    help="alias of --sdpBypassThreshold")
    ap.add_argument("--rbao", action="store_true",
                    help="alias of --refineBetweenAnchorsOnly")
    ap.add_argument("--guidedAlign", action="store_true",
                    help="reference trashbin flag (guided align is on)")
    ap.add_argument("--saLookupTableLength", type=int, default=8,
                    help="accepted; the direct LUT here uses the full "
                         "seed length")
    # reference-trashbin / structurally-obviated flags (accepted;
    # classification in tests/test_param_coverage.py)
    for flag in ("--useDetailedSDP", "--nouseDetailedSDP", "--useTemp",
                 "--skipLookupTable", "--sortRefinedAlignments",
                 "--computeAlignProbability", "--extendDenovoCCSSubreads",
                 "--noFrontAlign"):
        ap.add_argument(flag, action="store_true")
    for flag, dflt in (("--limsAlign", 0), ("--branchExpand", 0),
                       ("--contextAlignLength", 0), ("--nbranch", 1),
                       ("--quallc", 0), ("--recurseOver", 10000),
                       ("--stopMappingOnceUnique", 0),
                       ("--sdpFilterType", 0), ("--scoreType", 0)):
        ap.add_argument(flag, type=int, default=dflt)
    ap.add_argument("--minFrac", type=float, default=0.0)
    ap.add_argument("--outputByThread", action="store_true")
    # unsupported (rejected loudly in run())
    ap.add_argument("--ccsFofn", default=None)
    ap.add_argument("--lcpBounds", default=None)
    ap.add_argument("--samplePaths", action="store_true")
    return ap


def parse_hole_numbers(spec: str):
    """'1,2,10-12' -> predicate on hole numbers (reference --holeNumbers,
    Blasr.cpp:60-69 early-stop semantics not needed host-side)."""
    ranges = []
    for part in spec.split(","):
        if "-" in part:
            a, b = part.split("-")
            ranges.append((int(a), int(b)))
        else:
            ranges.append((int(part), int(part)))

    def pred(hole: Optional[int]) -> bool:
        if hole is None:
            return False
        return any(a <= hole <= b for a, b in ranges)
    return pred


def hole_of(qname: str) -> Optional[int]:
    parts = qname.split("/")
    if len(parts) >= 2 and parts[1].isdigit():
        return int(parts[1])
    return None


def parse_score_matrix(text: str):
    """StringToScoreMatrix (Blasr.cpp:918-937): 25 whitespace-separated
    values, |v| <= 100."""
    vals = [int(x) for x in text.split()]
    if len(vals) != 25 or any(abs(v) > 100 for v in vals):
        raise ValueError(
            "Error: the string for the scoring matrix incorrect format. "
            "It should be a quoted, space separated string of 25 values.")
    return [vals[i * 5:(i + 1) * 5] for i in range(5)]


def params_from_args(args) -> MappingParams:
    fmt = "m1"
    if args.sam:
        fmt = "sam"
    elif args.bam:
        fmt = "bam"
    elif args.printFormat is not None:
        fmt = f"m{args.printFormat}"
    return MappingParams(
        min_match_length=args.minMatch,
        max_match_length=(args.maxLCPLength if args.maxLCPLength is not None
                          else args.maxMatch),
        max_expand=args.maxExpand,
        min_expand=args.minExpand,
        p_value_type=args.pvaltype,
        global_chain_type=args.globalChainType,
        warp=not args.nowarp,
        fast_max_interval=args.fastMaxInterval,
        aggressive_interval_cut=args.aggressiveIntervalCut,
        advance_half=args.advanceHalf,
        do_sensitive_search=args.useSensitiveSearch,
        min_ratio=args.minRatio,
        sdp_tuple_size=args.sdpTupleSize,
        sdp_bypass_threshold=(args.sdpbypass if args.sdpbypass is not None
                              else 1e6),
        sdp_ins=args.sdpindel if args.sdpindel is not None else args.sdpIns,
        sdp_del=args.sdpindel if args.sdpindel is not None else args.sdpDel,
        fast_sdp=args.fastSDP,
        refine_between_anchors_only=(args.refineBetweenAnchorsOnly
                                     or args.rbao),
        refine_alignments=not args.noRefineAlignments,
        use_guided_align=not args.noUseGuidedAlign,
        band_size=args.bandSize,
        guided_align_band_size=args.guidedAlignBandSize,
        extend_alignments=args.extend,
        max_extend_dropoff=args.maxExtendDropoff,
        score_matrix=(parse_score_matrix(args.scoreMatrix)
                      if args.scoreMatrix else None),
        substitution_prior=args.substitutionPrior,
        global_deletion_prior=args.deletionPrior,
        ignore_qualities=not args.useQuality,
        score_type=args.scoreType,
        concordant_template=args.concordantTemplate,
        concordant_align_both_directions=args.concordantAlignBothDirections,
        flank_size=args.flankSize,
        refine_concordant_alignments=args.refineConcordantAlignments,
        map_subreads_separately=not args.noSplitSubreads,
        hole_number_ranges=args.holeNumbers or "",
        title_table_name=args.titleTable or "",
        print_sam_qv=args.printSAMQV or args.samQV is not None,
        sam_qv_list=tuple(args.samQV) if args.samQV else (),
        print_subread_title=not args.noPrintSubreadTitle,
        max_anchors_per_position=args.maxAnchorsPerPosition,
        advance_exact_matches=args.advanceExactMatches,
        n_candidates=args.nCandidates,
        n_best=args.bestn,
        max_score=(args.scoreCutoff if args.scoreCutoff is not None
                   else args.maxScore),
        use_score_cutoff=(args.scoreCutoff is not None
                          or args.maxScore != -200),
        min_aln_length=args.minAlnLength,
        min_pct_similarity=args.minPctSimilarity,
        min_pct_accuracy=args.minPctAccuracy,
        hit_policy=args.hitPolicy,
        random_seed=args.randomSeed,
        use_random_seed=args.randomSeed != 0,
        min_read_length=args.minReadLength,
        min_subread_length=args.minSubreadLength,
        min_raw_subread_score=args.minRawSubreadScore,
        min_avg_qual=args.minAvgQual,
        place_randomly=args.placeRepeatsRandomly,
        use_region_table=not args.ignoreRegions,
        use_hq_region_table=not args.ignoreHQRegions,
        do_global_alignment=args.globalAlign,
        accuracy_prior=args.accuracyPrior,
        candidate_drift_penalty=args.candidateDriftPenalty,
        full_span_mapqv=args.fullSpanMapQV,
        extend_band_size=args.extendBandSize,
        emulate_nucmer=args.nucmer,
        max_read_length=args.maxReadLength,
        indel=args.indel, insertion=args.insertion, deletion=args.deletion,
        match=args.match, mismatch=args.mismatch,
        affine_align=args.affineAlign, affine_open=args.affineOpen,
        affine_extend=args.affineExtend,
        indel_rate=args.indelRate,
        clipping=args.clipping,
        cigar_use_seq_match=args.cigarUseSeqMatch,
        allow_adjacent_indels=args.allowAdjacentIndels,
        print_header=args.header,
        forward_only=args.forwardOnly,
        preserve_read_title=args.preserveReadTitle,
        print_unaligned=args.unaligned is not None,
        print_unaligned_names_only=args.noPrintUnalignedSeqs,
        start_read=args.start, stride=args.stride, subsample=args.subsample,
        scale_mapqv_by_num_significant_clusters=args.scaleMapQVByNClusters,
        store_map_qv=not args.noStoreMapQV,
        print_only_best=args.printOnlyBest,
        concordant=args.concordant,
        use_ccs=args.useccs or args.useccsall,
        use_all_subreads_in_ccs=args.useccsall,
        use_ccs_only=args.useccsdenovo,
        print_format=fmt,
        verbosity=args.verbose or 0,
    ).make_sane()


def log(msg: str) -> None:
    ts = time.strftime("%c")
    sys.stderr.write(f"[INFO] {ts} [blasr_tpu] {msg}\n")


def run(argv: Optional[List[str]] = None) -> int:
    args = build_arg_parser().parse_args(argv)
    # unsupported requests fail loudly rather than silently parsing
    # --nowarp is accepted as a no-op: warp (MappingParameters.h:98,282)
    # only speeds the reference's CPU window-advance during interval
    # search; the chain DP here is exhaustive over anchors either way, so
    # the nowarp semantics is what is always computed.
    if args.scoreType not in (0, 1):
        sys.stderr.write("ERROR: --scoreType must be 0 (distance-matrix "
                         "rescore) or 1 (QV sum score)\n")
        return 1
    if args.ccsFofn:
        sys.stderr.write("ERROR: --ccsFofn is not supported by blasr_tpu "
                         "(pass the ccs.h5 file as the reads input)\n")
        return 1
    if args.lcpBounds:
        sys.stderr.write("ERROR: --lcpBounds is not supported by "
                         "blasr_tpu\n")
        return 1
    if args.samplePaths:
        sys.stderr.write("ERROR: --samplePaths is not supported by "
                         "blasr_tpu\n")
        return 1
    if args.scoreSign != -1:
        sys.stderr.write("ERROR: --scoreSign 1 (higher-is-better scores) "
                         "is not supported by blasr_tpu\n")
        return 1
    if args.affineAlign:
        sys.stderr.write("ERROR: --affineAlign not supported by "
                         "blasr_tpu_torch yet (use blasr_tpu)\n")
        return 1
    import torch
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "--device cuda: no CUDA device is available (pass --device cpu "
            "to run the plain PyTorch path)")
    if args.sa and args.bwt:
        # MakeSane :512-515
        sys.stderr.write("ERROR, sa and bwt must be used independently.\n")
        return 1
    try:
        params = params_from_args(args)
    except ValueError as e:
        sys.stderr.write(f"{e}\n")
        return 1
    if args.useQuality:
        from blasr_tpu_torch.io.fasta import sniff_format
        for path in expand_file_name_list([args.reads]):
            try:
                if sniff_format(path) == "fasta":
                    # MakeSane :448-453
                    sys.stderr.write(
                        "ERROR, you can not use -useQuality option when "
                        "any of the input reads files are in multi-fasta "
                        "format.\n")
                    return 1
            except (FileNotFoundError, PermissionError):
                pass
    log("started.")

    if args.sa:
        from blasr_tpu_torch.io.refsa import is_ref_sa
        if is_ref_sa(args.sa):
            # reference binary .sa (SuffixArray::Write layout): it holds
            # only the SA + lookup table, not this runtime's packed k-mer
            # index — rebuild from the genome and keep going (the warning
            # mirrors the reference's parameter-coercion warnings)
            log(f"WARNING: {args.sa} is a reference-format .sa; "
                "rebuilding the runtime index from the genome.")
            contigs = read_fasta(args.genome)
            gi = build_genome_index(
                contigs, k=min(params.min_match_length, 16))
        else:
            gi = GenomeIndex.load(args.sa)
    elif args.bwt:
        # --bwt path (Blasr.cpp:1073-1080): smaller artifact, slower load —
        # the BWT is inverted and the runtime k-mer index rebuilt
        from blasr_tpu_torch.io.refbin import is_ref_bwt
        if is_ref_bwt(args.bwt):
            # reference binary .bwt carries no contig names; the genome
            # argument supplies them (the reference also reads the genome
            # FASTA alongside the BWT, Blasr.cpp:1029-1080)
            log(f"WARNING: {args.bwt} is a reference-format .bwt; "
                "rebuilding the runtime index from the genome.")
            contigs = read_fasta(args.genome)
        else:
            from blasr_tpu_torch.cli.bwt2sa import contigs_from_concat
            from blasr_tpu_torch.index.bwt import invert_bwt, load_bwt
            bwt, counts, names, lengths = load_bwt(args.bwt)
            contigs = contigs_from_concat(invert_bwt(bwt, counts),
                                          names, lengths)
        gi = build_genome_index(contigs, k=min(params.min_match_length, 16))
    else:
        contigs = read_fasta(args.genome)
        gi = build_genome_index(
            contigs, k=min(params.min_match_length, 16))
    if args.ctab:
        # precomputed tuple count table (printTupleCountTable artifact;
        # reference --ctab, Blasr.cpp:1136-1147)
        from blasr_tpu_torch.cli.small_tools import load_ctab
        gi.ctab_k, gi.ctab = load_ctab(args.ctab)

    reads = []
    from blasr_tpu_torch.io.fasta import sniff_format
    ccs_groups = []
    for path in expand_file_name_list([args.reads]):
        try:
            if sniff_format(path) == "hdf":
                # HDF inputs honor -noSplitSubreads at extraction time
                # (MakePrimaryIntervals region variants, Blasr.cpp:89-179);
                # a multipart bas.h5 (/MultiPart/Parts) expands to its
                # bax.h5 parts first (ctest/multipart.t)
                from blasr_tpu_torch.io.hdf import BaxReader, expand_multipart
                for part in expand_multipart(path):
                    rdr = BaxReader(part, region_path=args.regionTable)
                    try:
                        if (params.use_ccs and not params.use_ccs_only
                                and rdr.passes is not None):
                            # ccs.h5 with Passes: CCSIterator inputs
                            ccs_groups.extend(rdr.ccs_groups(
                                full_only=not params.use_all_subreads_in_ccs))
                        else:
                            subs = rdr.subreads(
                                min_score=max(
                                    params.min_raw_subread_score, 0),
                                split=not args.noSplitSubreads,
                                use_regions=params.use_region_table,
                                use_hq=params.use_hq_region_table)
                            if params.min_subread_length:
                                subs = [r for r in subs
                                        if len(r.seq)
                                        >= params.min_subread_length]
                            reads.extend(subs)
                    finally:
                        rdr.close()
            else:
                reads.extend(read_sequences(path))
        except (FileNotFoundError, PermissionError) as e:
            # unopenable input -> warn and continue to the next file
            # (Blasr.cpp:1352-1355, tested by ctest/open_fail.t)
            sys.stderr.write(f"WARNING: Could not open {path}: {e}\n")
            continue
    if params.min_avg_qual > 0:
        # IsGoodRead's average-quality gate (Blasr.cpp:81): applies only
        # to reads that carry quality values
        import numpy as _np
        reads = [r for r in reads
                 if r.qual is None or len(r.qual) == 0
                 or float(_np.mean(r.qual)) >= params.min_avg_qual]
    if params.subsample < 1.0:
        # deterministic per-read subsampling (reference --subsample;
        # MakeSane switches off stride when subsampling)
        reads = [r for r in reads
                 if (zmw_rand_int(r.name, params.random_seed) % 10**6)
                 < params.subsample * 10**6]
    # --start/--stride process-level sharding (Blasr.cpp:1270), composed
    # with multi-host round-robin shards (dist/multihost.py)
    import os as _os
    host_id = int(_os.environ.get("BLASR_TPU_HOST_ID", "0"))
    n_hosts = int(_os.environ.get("BLASR_TPU_NUM_HOSTS", "1"))
    from blasr_tpu_torch.dist.multihost import shard_path, shard_reads
    idx = shard_reads(len(reads), host_id, n_hosts,
                      params.start_read, max(1, params.stride))
    markers = idx if n_hosts > 1 else None
    reads = [reads[i] for i in idx]
    if n_hosts > 1 and args.out != "-":
        args.out = shard_path(args.out, host_id, n_hosts)
    if params.hole_number_ranges:
        pred = parse_hole_numbers(params.hole_number_ranges)
        keep = [(i, r) for i, r in enumerate(reads)
                if pred(hole_of(r.name))]
        reads = [r for _, r in keep]
        if markers is not None:
            markers = [markers[i] for i, _ in keep]

    from blasr_tpu_torch.pipeline.metrics import MappingMetrics
    from blasr_tpu_torch.kernels.pallas_banded import two_valued
    if device.type == "cuda" and not two_valued(params.score_matrix):
        sys.stderr.write("ERROR: a general --scoreMatrix runs only with "
                         "--device cpu in blasr_tpu_torch\n")
        return 1
    mapper = Mapper(gi, params, metrics=MappingMetrics(
        store_list=args.fullMetrics is not None), device=device)
    if args.printDotPlots:
        # per-read anchor dumps (--printDotPlots, BlasrAlignImpl.hpp:151-159)
        for r in reads:
            fname = r.name.replace("/", "_") + ".anchors"
            with open(fname, "w") as df:
                mapper.dump_debug([r], anchors_out=df)
    if args.anchors or args.clusters:
        af = open(args.anchors, "w") if args.anchors else None
        cf = open(args.clusters, "w") if args.clusters else None
        try:
            mapper.dump_debug(reads, af, cf)
        finally:
            if af:
                af.close()
            if cf:
                cf.close()
    prof = contextlib.nullcontext()
    if args.profileDir:
        # device-level tracing (the reference's gperftools hook analog,
        # Blasr.cpp:1428-1436): a Chrome trace of the mapping phase
        prof = _torch_trace(args.profileDir, device)
    with prof:
        if ccs_groups:
            from blasr_tpu_torch.pipeline.zmw import map_ccs_groups
            ccs_reads, ccs_per_read = map_ccs_groups(
                mapper, ccs_groups, params)
            # inputs mixing ccs.h5 with plain read files: the non-CCS
            # records map through the standard path and are appended
            plain_per_read = mapper.map_reads(reads) if reads else []
            reads = list(reads) + list(ccs_reads)
            per_read = list(plain_per_read) + list(ccs_per_read)
            markers = None  # record list was re-derived from CCS groups
        elif params.concordant:
            from blasr_tpu_torch.pipeline.zmw import map_concordant
            per_read = map_concordant(mapper, reads, params)
        elif params.use_ccs:
            from blasr_tpu_torch.pipeline.zmw import map_ccs
            per_read = map_ccs(mapper, reads, params)
        else:
            per_read = mapper.map_reads(reads)
    if args.onegap:
        from blasr_tpu_torch.pipeline.onegap import join_one_gap
        per_read = [join_one_gap(alns, params) for alns in per_read]

    cmdline = " ".join(argv or sys.argv[1:])
    unaligned_f = open(args.unaligned, "w") if args.unaligned else None
    try:
        if params.print_format == "bam":
            from blasr_tpu_torch.io.bam import BamWriter
            fobj = open(args.out, "wb") if args.out != "-" \
                else sys.stdout.buffer
            movies = sorted({r.name.split("/")[0] for r in reads
                             if "/" in r.name}) or ["default"]
            rgs = [f"@RG\tID:{m}\tPL:PACBIO\tSM:{m}" for m in movies]
            bw = BamWriter(fobj,
                           formats.sam_header(gi, cmdline, read_groups=rgs),
                           gi.seqdb.names,
                           [int(x) for x in gi.seqdb.lengths])
            emit(bw, unaligned_f, reads, per_read, gi, params, cmdline)
            if markers is not None:
                sys.stderr.write("WARNING: multi-host merge supports text "
                                 "formats; BAM parts are left per-host\n")
            bw.close()
            if args.out != "-":
                fobj.close()
        else:
            out = sys.stdout if args.out == "-" else open(args.out, "w")
            try:
                emit(out, unaligned_f, reads, per_read, gi, params, cmdline,
                     markers)
            finally:
                if out is not sys.stdout:
                    out.close()
    finally:
        if unaligned_f:
            unaligned_f.close()
    if args.metrics:
        with open(args.metrics, "w") as mf:
            mapper.metrics.print_summary(mf)
    if args.fullMetrics:
        with open(args.fullMetrics, "w") as mf:
            mapper.metrics.print_full(mf)
    log("ended.")
    return 0


@contextlib.contextmanager
def _torch_trace(out_dir: str, device):
    """torch.profiler over the mapping phase; writes
    ``<out_dir>/trace.json`` (chrome://tracing / Perfetto)."""
    import os

    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(out_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))


def emit(out, unaligned_f, reads, per_read, gi, params, cmdline="",
         markers=None):
    fmt = params.print_format
    ref_ids = {n: i for i, n in enumerate(gi.seqdb.names)}
    title_map = None
    if params.title_table_name:
        # TitleTable (Blasr.cpp:1149-1183): output tName becomes the
        # title's index in the table file
        with open(params.title_table_name) as tf:
            titles = [ln.strip() for ln in tf if ln.strip()]
        title_map = {t.split()[0]: i for i, t in enumerate(titles)}
    if fmt == "sam":
        out.write(formats.sam_header(gi, cmdline))
    elif fmt == "m4" and params.print_header:
        out.write(formats.M4_HEADER)
    # pass 1: select every read's printed alignments
    chosen_all = []
    from blasr_tpu_torch.pipeline.zmw import zmw_key
    for rec, alns in zip(reads, per_read):
        if params.store_map_qv:  # --noStoreMapQV skips it (Blasr.cpp:421)
            store_map_qvs(alns, params, gi)
        # the random int is drawn per ZMW, so every subread of a hole and
        # any parallel schedule sees the same stream (Blasr.cpp:192-194)
        rint = zmw_rand_int(zmw_key(rec.name), params.random_seed)
        chosen_all.append(select_alignments(alns, params, rint))
    # subread-context threading for SAM/BAM (PrintAllReadAlignments,
    # BlasrUtilsImpl.hpp:1127-1212): alignments of a ZMW's subreads point
    # at the next aligned subread's first alignment via RNEXT/PNEXT
    links = [None] * len(reads)
    if fmt in ("sam", "bam"):
        from blasr_tpu_torch.pipeline.zmw import group_by_zmw
        for g in group_by_zmw(reads):
            aligned = [i for i in g if chosen_all[i]]
            if len(aligned) > 1:
                for k, i in enumerate(aligned):
                    links[i] = chosen_all[aligned[(k + 1) % len(aligned)]][0]
    for ri, (rec, chosen) in enumerate(zip(reads, chosen_all)):
        if markers is not None:
            out.write(f"#@{markers[ri]}\n")
        if not chosen:
            if unaligned_f is not None:
                formats.write_unaligned(unaligned_f, rec.name, rec.seq,
                                        params.print_unaligned_names_only)
            continue
        link = links[ri]
        for a in chosen:
            if title_map is not None:
                if a.tname in title_map:
                    a.tname = str(title_map[a.tname])
                else:
                    sys.stderr.write(
                        f"ERROR: title {a.tname} not in title table\n")
                    raise SystemExit(1)
            if fmt == "bam":
                rec_b = formats.to_bam_record(a, params, ref_ids)
                if link is not None:
                    rec_b.next_ref_id = ref_ids.get(link.tname, link.tindex)
                    rec_b.next_pos = link.tstart
                out.write_record(rec_b)
            elif fmt == "sam":
                if link is not None:
                    rn = "=" if link.tname == a.tname else link.tname
                    formats.write_sam(out, a, params, rnext=rn,
                                      pnext=link.tstart)
                else:
                    formats.write_sam(out, a, params)
            elif fmt == "m0":
                formats.write_m0(out, a, gi, params=params)
            elif fmt == "m1":
                formats.write_m1(out, a, params=params)
            elif fmt == "m2":
                formats.write_m2(out, a, gi, params=params)
            elif fmt == "m3":
                formats.write_m3(out, a, params=params)
            elif fmt == "m4":
                formats.write_m4(out, a, params=params)
            elif fmt == "m5":
                formats.write_m5(out, a, gi, params=params)
            else:
                raise ValueError(f"unknown format {fmt}")


def main() -> None:
    sys.exit(run())


if __name__ == "__main__":
    main()

# Copied from blasr_tpu/cli/sam_filter.py; only the imports differ (blasr_tpu -> blasr_tpu_torch).
"""samFilter equivalent: filter SAM by criteria + hit policy.

Reference: utils/SamFilter.cpp (same FilterCriteria/HitPolicy machinery
as the mapper, applied to an existing SAM file).
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, List, Optional

from blasr_tpu_torch.io.samparse import read_sam
from blasr_tpu_torch.params import MappingParams
from blasr_tpu_torch.pipeline.select import select_alignments, zmw_rand_int


def run(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="samFilter",
        description="samFilter file.sam [reference.fasta] out.sam "
                    "(utils/SamFilter.cpp interface)")
    ap.add_argument("inSam")
    ap.add_argument("middle", nargs="?", default=None,
                    help="reference fasta (optional) or out.sam")
    ap.add_argument("outSamPos", nargs="?", default=None)
    ap.add_argument("--minAccuracy", type=float, default=0.0)
    ap.add_argument("--minPctSimilarity", type=float, default=0.0)
    ap.add_argument("--minLength", type=int, default=0)
    ap.add_argument("--scoreCutoff", type=int, default=None)
    ap.add_argument("--hitPolicy", default="all",
                    choices=["all", "allbest", "random", "randombest",
                             "leftmost"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--bestn", type=int, default=0,
                    help="0 = unlimited")
    ap.add_argument("-holeNumbers", default=None,
                    help="keep only these ZMW hole-number ranges")
    ap.add_argument("-smrtTitle", action="store_true")
    ap.add_argument("-titleTable", default=None,
                    help="map output reference names to table indices")
    ap.add_argument("-v", action="store_true")
    args = ap.parse_args(argv)
    if args.outSamPos is not None:
        out_sam = args.outSamPos        # 3-positional reference form
    elif args.middle is not None:
        out_sam = args.middle
    else:
        sys.stderr.write("samFilter: missing output file\n")
        return 1

    params = MappingParams(
        min_aln_length=args.minLength,
        min_pct_similarity=args.minPctSimilarity,
        min_pct_accuracy=args.minAccuracy,
        hit_policy=args.hitPolicy,
        n_best=args.bestn if args.bestn > 0 else 10**9,
        use_score_cutoff=args.scoreCutoff is not None,
        max_score=args.scoreCutoff if args.scoreCutoff is not None else 0,
        random_seed=args.seed,
    )

    header, alns = read_sam(args.inSam)
    if args.holeNumbers:
        from blasr_tpu_torch.cli.blasr import hole_of, parse_hole_numbers
        pred = parse_hole_numbers(args.holeNumbers)
        alns = [a for a in alns if pred(hole_of(a.qname))]
    by_read: Dict[str, List] = {}
    order: List[str] = []
    for a in alns:
        if a.qname not in by_read:
            order.append(a.qname)
        by_read.setdefault(a.qname, []).append(a)

    # re-emit original SAM lines for the kept alignments
    with open(args.inSam) as f:
        lines = [l.rstrip("\n") for l in f if not l.startswith("@")]
    keyed = {}
    idx_per_read: Dict[str, int] = {}
    for a, line in zip(alns, [l for l in lines if l.split("\t")[2] != "*"
                              and not (int(l.split("\t")[1]) & 4)]):
        i = idx_per_read.get(a.qname, 0)
        keyed[(a.qname, i)] = line
        idx_per_read[a.qname] = i + 1

    title_map = None
    if args.titleTable:
        with open(args.titleTable) as tf:
            titles = [ln.strip().split()[0] for ln in tf if ln.strip()]
        title_map = {t: i for i, t in enumerate(titles)}

    out = sys.stdout if out_sam == "-" else open(out_sam, "w")
    for h in header:
        out.write(h + "\n")
    kept = 0
    for qname in order:
        group = by_read[qname]
        key = qname.rsplit("/", 1)[0] if args.smrtTitle and "/" in qname \
            else qname
        sel = select_alignments(list(group), params,
                                zmw_rand_int(key, args.seed))
        for a in sel:
            i = group.index(a)
            line = keyed[(qname, i)]
            if title_map is not None:
                f = line.split("\t")
                if f[2] in title_map:
                    f[2] = str(title_map[f[2]])
                line = "\t".join(f)
            out.write(line + "\n")
            kept += 1
    if args.v:
        sys.stderr.write(f"samFilter kept {kept} alignments\n")
    if out is not sys.stdout:
        out.close()
    return 0


def main() -> None:
    sys.exit(run())


if __name__ == "__main__":
    main()

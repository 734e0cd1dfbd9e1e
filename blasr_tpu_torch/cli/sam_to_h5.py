# Copied from blasr_tpu/cli/sam_to_h5.py; only the imports differ (blasr_tpu -> blasr_tpu_torch).
"""samtoh5 equivalent: SAM alignments -> cmp.h5.

Reference: utils/SamToCmpH5.cpp (``samtoh5 in.sam reference.fasta out.cmp.h5
[-smrtTitle] [-useShortRefName]``).  SAM records are parsed back into
alignment candidates (SAMReader + SAMToAlignmentCandidateAdapter role,
handled by io/samparse) and written with per-column alignment arrays.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from blasr_tpu_torch.io.cmph5 import CmpH5Writer, encode_aln_array
from blasr_tpu_torch.io.fasta import md5_of_seq, read_fasta, revcomp
from blasr_tpu_torch.io.samparse import read_sam


def run(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="samtoh5")
    ap.add_argument("sam", help="input SAM")
    ap.add_argument("reference", help="reference fasta")
    ap.add_argument("cmpH5", help="output cmp.h5")
    ap.add_argument("-smrtTitle", action="store_true")
    ap.add_argument("-useShortRefName", action="store_true")
    args = ap.parse_args(argv)

    contigs = read_fasta(args.reference)
    names = [c.name if args.useShortRefName else c.title for c in contigs]
    ref_of = {c.name: i for i, c in enumerate(contigs)}
    w = CmpH5Writer(args.cmpH5, names, [len(c.seq) for c in contigs],
                    [md5_of_seq(c.seq) for c in contigs])

    _, alns = read_sam(args.sam)
    for a in alns:
        if a.tname not in ref_of or a.read is None or not a.cigar:
            continue
        ref_id = ref_of[a.tname]
        ref_seq = contigs[ref_id].seq
        oriented = a.read if a.strand == 0 else revcomp(a.read)
        if a.strand == 0:
            qa, qb = a.qstart, a.qend
        else:
            qa, qb = a.qlen - a.qend, a.qlen - a.qstart
        qcore = oriented[qa:qb] if len(oriented) >= qb else oriented
        aln = encode_aln_array(qcore, ref_seq[a.tstart:a.tend], a.cigar)
        movie, hole = "movie", 0
        parts = a.qname.split("/")
        if len(parts) >= 2 and parts[1].isdigit():
            movie, hole = parts[0], int(parts[1])
        r_start, r_end = a.qstart, a.qend
        if args.smrtTitle and len(parts) >= 3 and "_" in parts[2]:
            s0, _ = parts[2].split("_")
            r_start, r_end = int(s0) + a.qstart, int(s0) + a.qend
        w.add_alignment(
            movie=movie, hole=hole, ref_id=ref_id, t_start=a.tstart,
            t_end=a.tend, strand=a.strand,
            r_start=r_start, r_end=r_end, map_qv=a.map_qv,
            n_m=a.n_match, n_mm=a.n_mismatch, n_ins=a.n_ins, n_del=a.n_del,
            aln_array=aln)
    w.close()
    sys.stderr.write(f"wrote {args.cmpH5}\n")
    return 0


def main() -> None:
    sys.exit(run())


if __name__ == "__main__":
    main()

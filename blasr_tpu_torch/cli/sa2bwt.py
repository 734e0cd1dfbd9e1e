# Copied from blasr_tpu/cli/sa2bwt.py; only the imports differ (blasr_tpu -> blasr_tpu_torch).
"""sa2bwt equivalent: suffix-array index -> BWT index.

Reference: extrautils/SuffixArrayToBWT.cpp:48
(``sa2bwt genome.fasta genome.sa out.bwt``).  Reads the genome FASTA plus a
sawriter .npz index (the stored full suffix array is used when present,
else rebuilt), writes a .bwt.npz artifact loadable by ``blasr_tpu_torch --bwt``
and invertible by ``bwt2sa``.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

import numpy as np

from blasr_tpu_torch.index.bwt import build_bwt, save_bwt
from blasr_tpu_torch.index.genome import GenomeIndex, concat_contigs
from blasr_tpu_torch.io.fasta import read_fasta


def run(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="sa2bwt")
    ap.add_argument("fastaIn", help="reference fasta")
    ap.add_argument("saIn", help="sawriter index (.npz)")
    ap.add_argument("bwtOut", help="output BWT (.npz)")
    args = ap.parse_args(argv)

    contigs = read_fasta(args.fastaIn)
    genome, seqdb = concat_contigs(contigs)
    sa = None
    from blasr_tpu_torch.io.refsa import is_ref_sa, read_ref_sa
    if is_ref_sa(args.saIn):
        ref_sa, _, _ = read_ref_sa(args.saIn)
        if ref_sa is not None and len(ref_sa) in (len(genome),
                                                  len(genome) + 1):
            sa = ref_sa.astype("int64")
            if len(sa) == len(genome):  # add the sentinel rank if absent
                sa = None  # build path appends it consistently
    else:
        try:
            gi = GenomeIndex.load(args.saIn)
            if (gi.suffix_array is not None
                    and len(gi.suffix_array) == len(genome) + 1):
                sa = gi.suffix_array
        except (FileNotFoundError, KeyError, ValueError):
            sys.stderr.write(f"WARNING: could not read SA from {args.saIn}; "
                             "rebuilding\n")
    out = args.bwtOut
    if out.endswith(".npz"):
        bwt, counts = build_bwt(genome, sa)
        save_bwt(out[:-4], bwt, counts, seqdb.names, seqdb.lengths)
        sys.stderr.write(f"wrote {out} ({len(bwt)} rows)\n")
    else:
        # reference binary layout (Bwt::Write, SuffixArrayToBWT.cpp:43-44):
        # sequence + counts + sampled positions so Locate/bwt2sa works
        from blasr_tpu_torch.index.bwt import FMIndex
        from blasr_tpu_torch.io.refbin import write_ref_bwt
        fm = FMIndex.from_text(genome, sa)
        write_ref_bwt(out, fm.bwt, fm.counts, fm.sample_rate,
                      np.maximum(fm.sa_sample, 0))
        sys.stderr.write(f"wrote {out} ({len(fm.bwt)} rows, binary)\n")
    return 0


def main() -> None:
    sys.exit(run())


if __name__ == "__main__":
    main()

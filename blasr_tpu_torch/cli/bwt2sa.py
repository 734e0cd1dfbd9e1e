# Copied from blasr_tpu/cli/bwt2sa.py; only the imports differ (blasr_tpu -> blasr_tpu_torch).
"""bwt2sa equivalent: BWT index -> suffix-array index.

Reference: extrautils/BwtToSuffixArray.cpp:33 (``bwt2sa in.bwt out.sa``).
Inverts the BWT to recover the concatenated genome, rebuilds the suffix
array (SA-IS), and writes a full sawriter-style .npz index.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

import numpy as np

from blasr_tpu_torch.index.bwt import invert_bwt, load_bwt
from blasr_tpu_torch.index.genome import build_genome_index
from blasr_tpu_torch.io.fasta import FastaRecord


def contigs_from_concat(genome: np.ndarray, names, lengths):
    """Split a concatenated (N-spaced) genome back into contig records."""
    out, off = [], 0
    for name, ln in zip(names, lengths):
        out.append(FastaRecord(name, np.asarray(genome[off:off + ln],
                                                dtype=np.int8)))
        off += ln + 1  # single-N spacer
    return out


def run(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="bwt2sa")
    ap.add_argument("bwtIn", help="BWT index (.npz)")
    ap.add_argument("saOut", help="output sawriter index (.npz)")
    ap.add_argument("-kmer", type=int, default=12)
    args = ap.parse_args(argv)

    from blasr_tpu_torch.io.refbin import is_ref_bwt, read_ref_bwt
    if is_ref_bwt(args.bwtIn):
        # reference binary .bwt -> reference binary .sa, the exact
        # BwtToSuffixArray.cpp:25-31 contract (no contig names involved:
        # the recovered SA has length-1 entries, rows 1-based in Locate)
        from blasr_tpu_torch.index.suffix_array import build_suffix_array
        from blasr_tpu_torch.io.refsa import lookup_table_from_sa, write_ref_sa
        bwt, counts, _rate, _samples = read_ref_bwt(args.bwtIn)
        genome = invert_bwt(bwt, counts)
        # terminator-smallest convention, matching sawriter's .sa output
        sa = build_suffix_array(genome)
        p = min(args.kmer, 8)
        table = lookup_table_from_sa(genome, sa, p)
        write_ref_sa(args.saOut, sa.astype(np.uint32), p, table)
        sys.stderr.write(
            f"wrote {args.saOut} ({len(sa)} entries, reference layout)\n")
        return 0

    bwt, counts, names, lengths = load_bwt(args.bwtIn)
    genome = invert_bwt(bwt, counts)
    contigs = contigs_from_concat(genome, names, lengths)
    gi = build_genome_index(contigs, k=args.kmer, with_suffix_array=True)
    out = args.saOut
    if out.endswith(".npz"):
        out = out[:-4]
    gi.save(out)
    sys.stderr.write(f"wrote {out}.npz ({gi.glen} bp)\n")
    return 0


def main() -> None:
    sys.exit(run())


if __name__ == "__main__":
    main()

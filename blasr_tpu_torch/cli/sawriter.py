# Copied from blasr_tpu/cli/sawriter.py; only the imports differ (blasr_tpu -> blasr_tpu_torch).
"""sawriter equivalent: offline index construction.

Reference: utils/SAWriter.cpp (FASTA -> 3-bit -> Larsson-Sadakane SA ->
lookup table -> .sa).  Here: FASTA -> packed genome + sorted k-mer table +
ctab [+ optional true suffix array] -> one .npz artifact loadable with
``blasr_tpu_torch ... --sa index.npz``.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from blasr_tpu_torch.index import build_genome_index
from blasr_tpu_torch.io.fasta import read_fasta


def run(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="sawriter")
    ap.add_argument("saOut", help="output index (.npz)")
    ap.add_argument("fastaIn", help="reference fasta")
    ap.add_argument("-kmer", "--kmer", type=int, default=12,
                    help="anchor seed length (reference minMatch analog)")
    ap.add_argument("-blt", type=int, default=8,
                    help="lookup/ctab prefix length (reference -blt)")
    ap.add_argument("--fullSuffixArray", action="store_true",
                    help="also build and store the full suffix array "
                         "(needed by sa2bwt / SA tooling parity)")
    ap.add_argument("-larsson", "-mamy", "-mcilroy", "-slow", "-kark",
                    "-welter", dest="algo", action="store_true",
                    help="construction algorithm flags (accepted for "
                         "compatibility; the artifact is identical)")
    ap.add_argument("--saFormat", choices=("npz", "ref"), default="npz",
                    help="'ref' writes the reference's binary .sa layout "
                         "(SuffixArray::Write, utils/SAWriter.cpp:239) "
                         "instead of the .npz index artifact")
    args = ap.parse_args(argv)
    contigs = read_fasta(args.fastaIn)
    gi = build_genome_index(
        contigs, k=args.kmer, ctab_k=args.blt,
        with_suffix_array=args.fullSuffixArray or args.saFormat == "ref")
    out = args.saOut
    if args.saFormat == "ref":
        from blasr_tpu_torch.io.refsa import lookup_table_from_sa, write_ref_sa
        table = lookup_table_from_sa(gi.genome, gi.suffix_array, args.blt)
        write_ref_sa(out, gi.suffix_array, args.blt, table)
        sys.stderr.write(f"wrote {out} (reference .sa layout, "
                         f"{gi.glen} bp, blt={args.blt})\n")
        return 0
    if out.endswith(".npz"):
        out = out[:-4]
    gi.save(out)
    sys.stderr.write(f"wrote {out}.npz ({gi.glen} bp, k={gi.k})\n")
    return 0


def main() -> None:
    sys.exit(run())


if __name__ == "__main__":
    main()

# Copied from blasr_tpu/cli/sam_to_m4.py; only the imports differ (blasr_tpu -> blasr_tpu_torch).
"""samtom4 equivalent: convert blasr-style SAM to m4.

Reference: utils/SamToM4.cpp (SAM + reference fasta -> m4 records).
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from blasr_tpu_torch.io import formats
from blasr_tpu_torch.io.fasta import read_fasta
from blasr_tpu_torch.io.samparse import read_sam


def run(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="samtom4")
    ap.add_argument("inSam")
    ap.add_argument("reference")
    ap.add_argument("outM4")
    ap.add_argument("--header", action="store_true")
    ap.add_argument("--useShortRefName", action="store_true")
    args = ap.parse_args(argv)

    ref = {r.name: len(r.seq) for r in read_fasta(args.reference)}
    header, alns = read_sam(args.inSam)
    out = sys.stdout if args.outM4 == "-" else open(args.outM4, "w")
    if args.header:
        out.write(formats.M4_HEADER)
    for a in alns:
        if a.tlen == 0 and a.tname in ref:
            a.tlen = ref[a.tname]
        if args.useShortRefName:
            a.tname = a.tname.split()[0]
        formats.write_m4(out, a)
    if out is not sys.stdout:
        out.close()
    return 0


def main() -> None:
    sys.exit(run())


if __name__ == "__main__":
    main()

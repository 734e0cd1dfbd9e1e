# Copied from blasr_tpu/cli/cmph5_store_quality_by_context.py; only the imports differ (blasr_tpu -> blasr_tpu_torch).
"""cmpH5StoreQualityByContext equivalent.

Reference: extrautils/CmpH5StoreQualityByContext.cpp — reads an aligned
cmp.h5 (with loadPulses QV datasets) and derives a quality-by-sequence-
context table: for every k-base template context, the distribution of
observed QVs.  Output: text table ``context meanQV count``.
"""

from __future__ import annotations

import argparse
import sys
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np

from blasr_tpu_torch.io.cmph5 import ALN_COLUMNS, GAP, CmpH5

BASES = "ACGT"


def run(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="cmpH5StoreQualityByContext")
    ap.add_argument("cmpH5", help="aligned cmp.h5 with QualityValue loaded")
    ap.add_argument("out", help="output table")
    ap.add_argument("-contextLength", type=int, default=3)
    ap.add_argument("-metric", default="QualityValue")
    args = ap.parse_args(argv)
    k = args.contextLength

    cmp = CmpH5.open(args.cmpH5)
    sums: Dict[str, float] = defaultdict(float)
    counts: Dict[str, int] = defaultdict(int)
    try:
        gcol = ALN_COLUMNS.index("AlnGroupID")
        ob = ALN_COLUMNS.index("offset_begin")
        oe = ALN_COLUMNS.index("offset_end")
        for row in range(cmp.index.shape[0]):
            gid = int(cmp.index[row, gcol])
            path = cmp.group_paths[gid] + "/" + args.metric
            if path not in cmp.h5:
                continue
            a, b = int(cmp.index[row, ob]), int(cmp.index[row, oe])
            qv = np.asarray(cmp.h5[path][a:b])
            arr = cmp.aln_array(row)
            tmpl = arr & 0xF
            ok = (tmpl != GAP) & (qv != 255)
            # context = k template bases ending at the column
            for i in range(k - 1, len(arr)):
                if not ok[i]:
                    continue
                window = tmpl[i - k + 1:i + 1]
                if (window == GAP).any() or (window > 3).any():
                    continue
                ctx = "".join(BASES[c] for c in window)
                sums[ctx] += float(qv[i])
                counts[ctx] += 1
    finally:
        cmp.close()

    with open(args.out, "w") as f:
        f.write("context meanQV count\n")
        for ctx in sorted(counts):
            f.write(f"{ctx} {sums[ctx] / counts[ctx]:.2f} {counts[ctx]}\n")
    return 0


def main() -> None:
    sys.exit(run())


if __name__ == "__main__":
    main()

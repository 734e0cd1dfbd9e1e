# Copied from blasr_tpu/cli/bam2bax.py; only the imports differ (blasr_tpu -> blasr_tpu_torch).
"""bam2bax equivalent: PacBio subread (+scraps) BAM -> bax.h5 round trip.

Reference: utils/bam2bax/src — reconstructs a movie HDF5 from subread
BAM records: per-ZMW basecalls are re-concatenated from the subreads
(plus ``.scraps.bam`` adapter/LQ pieces when given, the reference's
two-file usage ``bam2bax movie.subreads.bam movie.scraps.bam``), QV tag
tracks become BaseCalls datasets, and the region table is rebuilt:
Insert region per subread, Adapter rows from ``sc:Z:A`` scraps, the HQ
region spanning the non-LQ pieces with its score recovered from ``rq``.
"""

from __future__ import annotations

import argparse
import sys
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np

from blasr_tpu_torch.io.bam import read_bam
from blasr_tpu_torch.io.hdf import REGION_TYPES, ZmwRead, write_bax

_TRACK_OF_TAG = {
    "iq": "InsertionQV", "dq": "DeletionQV", "sq": "SubstitutionQV",
    "mq": "MergeQV", "dt": "DeletionTag", "st": "SubstitutionTag",
}


def run(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="bam2bax")
    ap.add_argument("bams", nargs="+",
                    help="subreads BAM [+ scraps BAM] (reference usage: "
                    "bam2bax movie.subreads.bam movie.scraps.bam -o out)")
    ap.add_argument("-o", "--output", default="out",
                    help="output prefix (.bax.h5 appended)")
    args = ap.parse_args(argv)

    per_hole: Dict[int, List] = defaultdict(list)
    movie = "movie"
    for path in args.bams:
        _, _, _, records = read_bam(path)
        for r in records:
            parts = r.qname.split("/")
            if len(parts) >= 3 and "_" in parts[2]:
                movie = parts[0]
                hole = int(parts[1])
                s, e = (int(x) for x in parts[2].split("_"))
            else:
                hole = int(r.tags.get("zm", len(per_hole)))
                s = int(r.tags.get("qs", 0))
                e = int(r.tags.get("qe", s + len(r.seq)))
            per_hole[hole].append((s, e, r))

    zmws: List[ZmwRead] = []
    regions: List[List[int]] = []
    ins_id = REGION_TYPES.index("Insert")
    hq_id = REGION_TYPES.index("HQRegion")
    ad_id = REGION_TYPES.index("Adapter")
    for hole in sorted(per_hole):
        subs = sorted(per_hole[hole], key=lambda x: (x[0], x[1]))
        total = max(e for _, e, _ in subs)
        seq = np.full(total, 4, np.int8)
        tracks: Dict[str, np.ndarray] = {}
        any_qual = any(r.qual is not None for _, _, r in subs)
        if any_qual:
            tracks["QualityValue"] = np.zeros(total, np.uint8)
        tag_names = set()
        for _, _, r in subs:
            tag_names.update(t for t in r.tags if t in _TRACK_OF_TAG)
        for t in tag_names:
            tracks[_TRACK_OF_TAG[t]] = np.zeros(total, np.uint8)
        hq_lo, hq_hi, hq_score = 1 << 30, -1, 800
        for s, e, r in subs:
            seq[s:e] = r.seq[: e - s]
            if r.qual is not None and "QualityValue" in tracks:
                tracks["QualityValue"][s:e] = np.minimum(
                    r.qual[: e - s], 255).astype(np.uint8)
            for t in tag_names:
                if t in r.tags:
                    v = np.frombuffer(str(r.tags[t]).encode(),
                                      np.uint8).astype(np.int32) - 33
                    tracks[_TRACK_OF_TAG[t]][s:e] = v[: e - s].astype(
                        np.uint8)
            sc = r.tags.get("sc")
            if "rq" in r.tags:
                hq_score = int(round(float(r.tags["rq"]) * 1000))
            if sc == "A":
                # adapter scrap -> Adapter region row; adapters sit
                # inside the HQ region
                regions.append([hole, ad_id, s, e, -1])
                hq_lo, hq_hi = min(hq_lo, s), max(hq_hi, e)
            elif sc == "L":
                pass  # low-quality piece: sequence only, outside HQ
            else:
                regions.append([hole, ins_id, s, e, -1])
                hq_lo, hq_hi = min(hq_lo, s), max(hq_hi, e)
        if hq_hi < 0:
            hq_lo, hq_hi = 0, total
        regions.append([hole, hq_id, hq_lo, hq_hi, hq_score])
        zmws.append(ZmwRead(hole, seq, tracks))

    out_path = args.output + ".bax.h5"
    write_bax(out_path, movie, zmws, np.asarray(regions, np.int32))
    sys.stderr.write(f"wrote {out_path} ({len(zmws)} ZMWs)\n")
    return 0


def main() -> None:
    sys.exit(run())


if __name__ == "__main__":
    main()

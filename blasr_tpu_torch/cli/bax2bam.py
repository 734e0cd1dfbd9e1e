# Copied from blasr_tpu/cli/bax2bam.py; only the imports differ (blasr_tpu -> blasr_tpu_torch).
"""bax2bam equivalent: movie .h5 -> unaligned PacBio-style BAMs.

Reference: utils/bax2bam/src — converts bax.h5 into subread / hqregion /
polymerase / ccs BAMs with QV tag tracks.  Parity covered:

* modes --subread (default) / --hqregion / --polymeraseread / --ccs
* subread mode also emits the ``.scraps.bam`` (adapter pieces ``sc:Z:A``
  and low-quality head/tail pieces ``sc:Z:L``) so
  subreads + scraps reconstruct the full polymerase read (the reference's
  SubreadConverter + ScrapsWriter pair); hqregion mode likewise emits
  ``.lqregions.bam``
* PacBio BAM header conventions: ``@RG`` ID is the first 8 hex chars of
  md5("movie//READTYPE") (pbcore convention), PU carries the movie name,
  and DS carries READTYPE, the QV-track tag manifest, basecaller version
  and frame rate
* per-record tags: RG, zm, qs, qe, np, rq (HQ-region score / 1000), cx
  (subread local context: adapter_before|adapter_after), and the QV
  Z-string tags iq/dq/sq/mq/dt/st
"""

from __future__ import annotations

import argparse
import hashlib
import sys
from typing import List, Optional

import numpy as np

from blasr_tpu_torch.io.bam import BamRecord, BamWriter
from blasr_tpu_torch.io.fofn import expand_file_name_list
from blasr_tpu_torch.io.hdf import BaxReader

_TAG_OF_TRACK = {
    "InsertionQV": "iq", "DeletionQV": "dq", "SubstitutionQV": "sq",
    "MergeQV": "mq", "DeletionTag": "dt", "SubstitutionTag": "st",
}
# cx bit flags (pbcore LocalContextFlags)
CX_ADAPTER_BEFORE = 1
CX_ADAPTER_AFTER = 2


def _qv_string(v: np.ndarray) -> str:
    return "".join(chr(min(int(x), 93) + 33) for x in v)


def rg_id(movie: str, readtype: str) -> str:
    """PacBio read-group ID: md5("movie//READTYPE")[:8]."""
    return hashlib.md5(f"{movie}//{readtype}".encode()).hexdigest()[:8]


def _header(movie: str, readtype: str, tracks_present) -> str:
    ds = [f"READTYPE={readtype}"]
    for track, tag in _TAG_OF_TRACK.items():
        if track in tracks_present:
            ds.append(f"{track}={tag}")
    ds += ["BASECALLERVERSION=2.3", "FRAMERATEHZ=75.000000"]
    return ("@HD\tVN:1.5\tSO:unknown\tpb:3.0.1\n"
            f"@RG\tID:{rg_id(movie, readtype)}\tPL:PACBIO\tPU:{movie}\t"
            f"DS:{';'.join(ds)}\n"
            "@PG\tID:bax2bam\tPN:bax2bam\n")


def _record(movie, readtype, z, s, e, rq, extra=None):
    tags = {"RG": rg_id(movie, readtype), "zm": int(z.hole),
            "qs": int(s), "qe": int(e), "np": 1, "rq": float(rq)}
    if extra:
        tags.update(extra)
    for track, tag in _TAG_OF_TRACK.items():
        if track in z.tracks:
            tags[tag] = _qv_string(z.tracks[track][s:e])
    qual = None
    if "QualityValue" in z.tracks:
        qual = z.tracks["QualityValue"][s:e].astype(np.int32)
    return BamRecord(qname=f"{movie}/{z.hole}/{s}_{e}", flag=4,
                     ref_id=-1, pos=-1, mapq=255, cigar=[],
                     seq=z.seq[s:e], qual=qual, tags=tags)


def run(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="bax2bam")
    ap.add_argument("inputs", nargs="+", help="movie .h5 files (or fofn)")
    ap.add_argument("-o", "--output", default="out",
                    help="output prefix (.subreads.bam etc appended)")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--subread", action="store_true", default=True)
    mode.add_argument("--hqregion", action="store_true")
    mode.add_argument("--polymeraseread", action="store_true")
    mode.add_argument("--ccs", action="store_true")
    args = ap.parse_args(argv)

    if args.hqregion:
        suffix, readtype = ".hqregions.bam", "HQREGION"
    elif args.polymeraseread:
        suffix, readtype = ".polymerase.bam", "POLYMERASE"
    elif args.ccs:
        suffix, readtype = ".ccs.bam", "CCS"
    else:
        suffix, readtype = ".subreads.bam", "SUBREAD"

    movie = None
    records: List[BamRecord] = []
    scraps: List[BamRecord] = []   # subread mode: A + L pieces;
    #                                hqregion mode: the LQ pieces
    tracks_present = set()
    for path in expand_file_name_list(list(args.inputs)):
        rdr = BaxReader(path)
        try:
            movie = movie or rdr.movie
            for i in range(len(rdr.holes)):
                z = rdr.read_zmw(i)
                tracks_present.update(z.tracks)
                n = len(z.seq)
                if n == 0:
                    continue
                rt = rdr.region_table
                hq = rt.hq_region(z.hole) if rt is not None else None
                hq0, hq1, hq_sc = hq if hq is not None else (0, n, 0)
                hq0, hq1 = max(0, hq0), min(n, hq1)
                rq = min(max(hq_sc, 0), 1000) / 1000.0
                if args.polymeraseread or args.ccs:
                    records.append(_record(movie, readtype, z, 0, n, rq))
                    continue
                if args.hqregion:
                    if hq1 > hq0:
                        records.append(
                            _record(movie, readtype, z, hq0, hq1, rq))
                    for s, e in ((0, hq0), (hq1, n)):
                        if e > s:
                            scraps.append(_record(movie, "SCRAP", z, s, e,
                                                  rq, {"sc": "L"}))
                    continue
                # subread mode: subreads + adapter/LQ scraps
                ivals = (rt.subread_intervals(z.hole, split=True)
                         if rt is not None else ([(0, n)] if n else []))
                ivals = [(s, min(e, n)) for s, e in ivals if min(e, n) > s]
                adapters = []
                if rt is not None:
                    rows = rt.for_hole(z.hole)
                    aid = rt.types.index("Adapter") \
                        if "Adapter" in rt.types else -1
                    for row in rows:
                        if row[1] == aid:
                            a, b = max(int(row[2]), hq0), \
                                min(int(row[3]), hq1)
                            if b > a:
                                adapters.append((a, b))
                for s, e in ivals:
                    cx = 0
                    if any(b == s for a, b in adapters):
                        cx |= CX_ADAPTER_BEFORE
                    if any(a == e for a, b in adapters):
                        cx |= CX_ADAPTER_AFTER
                    records.append(_record(movie, readtype, z, s, e, rq,
                                           {"cx": cx}))
                for a, b in adapters:
                    scraps.append(_record(movie, "SCRAP", z, a, b, rq,
                                          {"sc": "A"}))
                for s, e in ((0, hq0), (hq1, n)):
                    if e > s:
                        scraps.append(_record(movie, "SCRAP", z, s, e, rq,
                                              {"sc": "L"}))
        finally:
            rdr.close()

    movie = movie or "movie"
    out_path = args.output + suffix
    with open(out_path, "wb") as f:
        w = BamWriter(f, _header(movie, readtype, tracks_present), [], [])
        for r in records:
            w.write_record(r)
        w.close()
    sys.stderr.write(f"wrote {out_path} ({len(records)} records)\n")
    if not (args.polymeraseread or args.ccs):
        name = (".scraps.bam" if not args.hqregion else ".lqregions.bam")
        sp = args.output + name
        with open(sp, "wb") as f:
            w = BamWriter(f, _header(movie, "SCRAP", tracks_present),
                          [], [])
            for r in scraps:
                w.write_record(r)
            w.close()
        sys.stderr.write(f"wrote {sp} ({len(scraps)} records)\n")
    return 0


def main() -> None:
    sys.exit(run())


if __name__ == "__main__":
    main()

# Copied from blasr_tpu/cli/pls2fasta.py; only the imports differ (blasr_tpu -> blasr_tpu_torch).
"""pls2fasta equivalent: plx/bax.h5 -> FASTA/FASTQ with region trimming.

Reference: utils/PulseToFasta.cpp — converts movie HDF5 files to
FASTA/FASTQ, with -trimByRegion (clip to HQ + split at inserts),
-maskByRegion (mask out-of-region bases with N), -noSplitSubreads,
-minSubreadLength, -holeNumber ranges, -fastq.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

import numpy as np

from blasr_tpu_torch.io.fasta import FastaRecord, decode
from blasr_tpu_torch.io.fofn import expand_file_name_list
from blasr_tpu_torch.io.hdf import BaxReader


def write_records(out, recs, fastq: bool):
    for r in recs:
        if fastq:
            q = r.qual if r.qual is not None else np.zeros(len(r.seq), int)
            out.write(f"@{r.title}\n{decode(r.seq)}\n+\n")
            out.write("".join(chr(min(int(x), 93) + 33) for x in q) + "\n")
        else:
            out.write(f">{r.title}\n{decode(r.seq)}\n")


def run(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="pls2fasta")
    ap.add_argument("in_file", help="movie .h5 (or fofn)")
    ap.add_argument("out_file", help="output fasta/fastq")
    ap.add_argument("-trimByRegion", action="store_true")
    ap.add_argument("-maskByRegion", action="store_true")
    ap.add_argument("-noSplitSubreads", action="store_true")
    ap.add_argument("-minSubreadLength", type=int, default=0)
    ap.add_argument("-holeNumber", default=None)
    ap.add_argument("-fastq", action="store_true")
    ap.add_argument("-regionTable", default=None,
                    help="accepted; regions are read from the movie file")
    args = ap.parse_args(argv)

    pred = None
    if args.holeNumber:
        from blasr_tpu_torch.cli.blasr import parse_hole_numbers
        pred = parse_hole_numbers(args.holeNumber)

    out = (sys.stdout if args.out_file == "-"
           else open(args.out_file, "w"))
    try:
        for path in expand_file_name_list([args.in_file]):
            rdr = BaxReader(path)
            try:
                recs: List[FastaRecord] = []
                for i in range(len(rdr.holes)):
                    z = rdr.read_zmw(i)
                    if pred is not None and not pred(z.hole):
                        continue
                    qual = z.tracks.get("QualityValue")
                    rt = rdr.region_table
                    if args.trimByRegion and rt is not None:
                        ivals = rt.subread_intervals(
                            z.hole, split=not args.noSplitSubreads)
                        for s, e in ivals:
                            e = min(e, len(z.seq))
                            if e - s < args.minSubreadLength:
                                continue
                            recs.append(FastaRecord(
                                f"{rdr.movie}/{z.hole}/{s}_{e}",
                                z.seq[s:e],
                                qual[s:e].astype(np.int32)
                                if qual is not None else None))
                    elif args.maskByRegion and rt is not None:
                        seq = z.seq.copy()
                        mask = np.ones(len(seq), bool)
                        for s, e in rt.subread_intervals(z.hole):
                            mask[s:min(e, len(seq))] = False
                        seq[mask] = 4
                        if len(seq) >= args.minSubreadLength:
                            recs.append(FastaRecord(
                                f"{rdr.movie}/{z.hole}/0_{len(seq)}", seq,
                                qual.astype(np.int32)
                                if qual is not None else None))
                    else:
                        if len(z.seq) >= args.minSubreadLength:
                            recs.append(FastaRecord(
                                f"{rdr.movie}/{z.hole}/0_{len(z.seq)}",
                                z.seq,
                                qual.astype(np.int32)
                                if qual is not None else None))
                write_records(out, recs, args.fastq)
            finally:
                rdr.close()
    finally:
        if out is not sys.stdout:
            out.close()
    return 0


def main() -> None:
    sys.exit(run())


if __name__ == "__main__":
    main()

# Copied from blasr_tpu/cli/load_pulses.py; only the imports differ (blasr_tpu -> blasr_tpu_torch).
"""loadPulses equivalent: add per-base pulse/QV datasets to a cmp.h5.

Reference: utils/LoadPulses.cpp (``loadPulses movies.fofn aligned.cmp.h5
-metrics QualityValue,InsertionQV,...``) — for every alignment in the
cmp.h5, the matching movie read's QV tracks are gathered onto alignment
columns (gap columns get 255) and stored next to the AlnArray.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, List, Optional

import numpy as np

from blasr_tpu_torch.io.cmph5 import ALN_COLUMNS, GAP, CmpH5
from blasr_tpu_torch.io.fofn import expand_file_name_list
from blasr_tpu_torch.io.hdf import BaxReader

DEFAULT_METRICS = ["QualityValue", "InsertionQV", "DeletionQV",
                   "SubstitutionQV"]

# full metric set (utils/LoadPulses.cpp supportedMetrics, :141-171) with
# (source track, dtype, gap fill); derived metrics computed below
DIRECT_METRICS = {
    "QualityValue": ("QualityValue", np.uint8, 255),
    "InsertionQV": ("InsertionQV", np.uint8, 255),
    "DeletionQV": ("DeletionQV", np.uint8, 255),
    "SubstitutionQV": ("SubstitutionQV", np.uint8, 255),
    "MergeQV": ("MergeQV", np.uint8, 255),
    "DeletionTag": ("DeletionTag", np.uint8, ord("N")),
    "SubstitutionTag": ("SubstitutionTag", np.uint8, ord("N")),
    "PreBaseFrames": ("PreBaseFrames", np.uint16, 0),
    "WidthInFrames": ("WidthInFrames", np.uint16, 0),
    "PulseWidth": ("WidthInFrames", np.uint16, 0),
    "IPD": ("PreBaseFrames", np.uint16, 0),
    "pkmid": ("MidSignal", np.uint16, 0),
}
DERIVED_METRICS = {"StartFrame"}   # cumsum(PreBaseFrames + WidthInFrames)
SUPPORTED = sorted(DIRECT_METRICS) + sorted(DERIVED_METRICS) + ["WhenStarted"]


def run(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="loadPulses")
    ap.add_argument("movies", help="movie .h5 file or fofn")
    ap.add_argument("cmpH5", help="aligned cmp.h5 to annotate")
    ap.add_argument("-metrics", default=",".join(DEFAULT_METRICS))
    args = ap.parse_args(argv)
    metrics = [m for m in args.metrics.split(",") if m]
    bad = [m for m in metrics if m not in SUPPORTED]
    if bad:
        sys.stderr.write(
            f"ERROR, metric {bad[0]} is not supported; supported metrics: "
            f"{', '.join(SUPPORTED)}\n")
        return 1

    # index all movie reads by (movie, hole)
    reads: Dict[tuple, dict] = {}
    for path in expand_file_name_list([args.movies]):
        rdr = BaxReader(path)
        try:
            for i in range(len(rdr.holes)):
                z = rdr.read_zmw(i)
                reads[(rdr.movie, z.hole)] = z.tracks
        finally:
            rdr.close()

    cmp = CmpH5.open(args.cmpH5)
    try:
        per_group: Dict[int, Dict[str, List[np.ndarray]]] = {}
        n = cmp.index.shape[0]
        gcol = ALN_COLUMNS.index("AlnGroupID")
        mcol = ALN_COLUMNS.index("MovieID")
        hcol = ALN_COLUMNS.index("HoleNumber")
        rcol = ALN_COLUMNS.index("rStart")
        for row in range(n):
            gid = int(cmp.index[row, gcol])
            movie = cmp.movie_names[int(cmp.index[row, mcol])]
            hole = int(cmp.index[row, hcol])
            r0 = int(cmp.index[row, rcol])
            arr = cmp.aln_array(row)
            consumes_q = (arr >> 4) != GAP
            qoff = r0 + np.cumsum(consumes_q) - consumes_q
            tracks = reads.get((movie, hole), {})
            bufs = per_group.setdefault(gid, {m: [] for m in metrics})
            for m in metrics:
                if m == "WhenStarted":
                    continue  # scan-level attribute, handled below
                if m in DERIVED_METRICS:  # StartFrame
                    pbf = tracks.get("PreBaseFrames")
                    wif = tracks.get("WidthInFrames")
                    if pbf is None or wif is None:
                        vals = np.zeros(len(arr), np.uint32)
                    else:
                        sf = (np.cumsum(pbf.astype(np.uint32)
                                        + wif.astype(np.uint32))
                              - wif.astype(np.uint32))
                        vals = np.where(
                            consumes_q,
                            sf[np.clip(qoff, 0, len(sf) - 1)],
                            np.uint32(0)).astype(np.uint32)
                    bufs[m].append(vals)
                    continue
                src, dt, gap = DIRECT_METRICS[m]
                t = tracks.get(src)
                if t is None:
                    vals = np.full(len(arr), gap, dt)
                else:
                    vals = np.where(
                        consumes_q,
                        np.asarray(t, dt)[np.clip(qoff, 0, len(t) - 1)],
                        dt(gap))
                bufs[m].append(vals.astype(dt))
        for gid, bufs in per_group.items():
            path = cmp.group_paths[gid]
            for m, parts in bufs.items():
                if m == "WhenStarted":
                    continue
                data = (np.concatenate(parts) if parts
                        else np.zeros(0, np.uint8))
                if path + "/" + m in cmp.h5:
                    del cmp.h5[path + "/" + m]
                cmp.h5.create_dataset(path + "/" + m, data=data)
        if "WhenStarted" in metrics:
            # scan-level acquisition timestamp copied into MovieInfo
            cmp.h5.require_group("MovieInfo").attrs["WhenStarted"] = (
                "unknown")
    finally:
        cmp.close()
    sys.stderr.write(f"annotated {args.cmpH5} with {metrics}\n")
    return 0


def main() -> None:
    sys.exit(run())


if __name__ == "__main__":
    main()

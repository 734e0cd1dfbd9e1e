# Copied from blasr_tpu/io/cmph5.py; only the imports differ (blasr_tpu -> blasr_tpu_torch).
"""cmp.h5 alignment-store I/O (HDFCmpFile analog).

Reference parity for the cmp.h5 side of the tool chain: ``samtoh5``
(utils/SamToCmpH5.cpp) writes alignments into a cmp.h5, ``loadPulses``
(utils/LoadPulses.cpp) adds per-base pulse/QV datasets from movie files,
``cmpH5StoreQualityByContext`` (extrautils) derives QV-by-context tables.

Structure written (cmp.h5 1.x conventions):
  /AlnInfo/AlnIndex      uint32 [n, 22]  (column layout in ALN_COLUMNS)
  /AlnGroup/{ID,Path}    alignment-array group per (ref, movie)
  /RefGroup/{ID,Path,RefInfoID}
  /RefInfo/{ID,FullName,Length,MD5}
  /MovieInfo/{ID,Name}
  /<refPath>/<movie>/AlnArray   uint8: one byte per alignment column,
      high nibble = query base, low nibble = ref base (0..3 ACGT, 0xF gap)
  /<refPath>/<movie>/<QVTrack>  uint8 per alignment column (loadPulses)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

ALN_COLUMNS = [
    "AlnID", "AlnGroupID", "MovieID", "RefGroupID", "tStart", "tEnd",
    "RCRefStrand", "HoleNumber", "SetNumber", "StrobeNumber", "MoleculeID",
    "rStart", "rEnd", "MapQV", "nM", "nMM", "nIns", "nDel",
    "offset_begin", "offset_end", "nBackRead", "nReadOverlap",
]
GAP = 0xF


def encode_aln_array(q_codes, t_codes, cigar) -> np.ndarray:
    """Alignment columns -> byte array (query nibble | ref nibble)."""
    out = []
    qi = ti = 0
    for op, n in cigar:
        for _ in range(n):
            if op in "M=X":
                out.append((int(q_codes[qi]) << 4) | int(t_codes[ti]))
                qi += 1
                ti += 1
            elif op == "I":
                out.append((int(q_codes[qi]) << 4) | GAP)
                qi += 1
            elif op == "D":
                out.append((GAP << 4) | int(t_codes[ti]))
                ti += 1
    return np.asarray(out, np.uint8)


class CmpH5Writer:
    def __init__(self, path: str, ref_names: List[str],
                 ref_lengths: List[int], ref_md5s: Optional[List[str]] = None):
        import h5py
        self.h5 = h5py.File(path, "w")
        self.h5.attrs["Version"] = b"2.0.0"
        self.ref_names = list(ref_names)
        self.ref_lengths = list(ref_lengths)
        self.ref_md5s = ref_md5s or [""] * len(ref_names)
        self.movies: Dict[str, int] = {}
        self.aln_groups: Dict[Tuple[int, str], int] = {}
        self.rows: List[List[int]] = []
        self.arrays: Dict[Tuple[int, str], List[np.ndarray]] = {}

    def movie_id(self, movie: str) -> int:
        if movie not in self.movies:
            self.movies[movie] = len(self.movies) + 1
        return self.movies[movie]

    def add_alignment(self, *, movie: str, hole: int, ref_id: int,
                      t_start: int, t_end: int, strand: int,
                      r_start: int, r_end: int, map_qv: int,
                      n_m: int, n_mm: int, n_ins: int, n_del: int,
                      aln_array: np.ndarray) -> None:
        mid = self.movie_id(movie)
        key = (ref_id, movie)
        if key not in self.aln_groups:
            self.aln_groups[key] = len(self.aln_groups) + 1
            self.arrays[key] = []
        buf = self.arrays[key]
        off = sum(len(a) for a in buf)
        buf.append(np.asarray(aln_array, np.uint8))
        self.rows.append([
            len(self.rows) + 1, self.aln_groups[key], mid, ref_id + 1,
            t_start, t_end, strand, hole, 0, 0, hole,
            r_start, r_end, map_qv, n_m, n_mm, n_ins, n_del,
            off, off + len(aln_array), 0, 0,
        ])

    def close(self) -> None:
        h5 = self.h5
        ai = h5.create_group("AlnInfo")
        ai.create_dataset(
            "AlnIndex",
            data=np.asarray(self.rows, np.uint32).reshape(
                len(self.rows), len(ALN_COLUMNS)))
        ai["AlnIndex"].attrs["ColumnNames"] = np.array(
            [c.encode() for c in ALN_COLUMNS])
        ri = h5.create_group("RefInfo")
        n_ref = len(self.ref_names)
        ri.create_dataset("ID", data=np.arange(1, n_ref + 1, dtype=np.uint32))
        ri.create_dataset("FullName",
                          data=np.array([n.encode() for n in self.ref_names]))
        ri.create_dataset("Length",
                          data=np.asarray(self.ref_lengths, np.uint32))
        ri.create_dataset("MD5",
                          data=np.array([m.encode() for m in self.ref_md5s]))
        rg = h5.create_group("RefGroup")
        rg.create_dataset("ID", data=np.arange(1, n_ref + 1, dtype=np.uint32))
        rg.create_dataset("RefInfoID",
                          data=np.arange(1, n_ref + 1, dtype=np.uint32))
        rg.create_dataset(
            "Path",
            data=np.array([f"/ref{i + 1:06d}".encode()
                           for i in range(n_ref)]))
        mi = h5.create_group("MovieInfo")
        mi.create_dataset(
            "ID", data=np.asarray(sorted(self.movies.values()), np.uint32))
        mi.create_dataset(
            "Name",
            data=np.array([m.encode() for m, _ in
                           sorted(self.movies.items(), key=lambda kv: kv[1])]))
        ag = h5.create_group("AlnGroup")
        ag.create_dataset(
            "ID",
            data=np.asarray(sorted(self.aln_groups.values()), np.uint32))
        paths = []
        for (ref_id, movie), gid in sorted(self.aln_groups.items(),
                                           key=lambda kv: kv[1]):
            path = f"/ref{ref_id + 1:06d}/{movie}"
            paths.append(path.encode())
            arr = (np.concatenate(self.arrays[(ref_id, movie)])
                   if self.arrays[(ref_id, movie)]
                   else np.zeros(0, np.uint8))
            h5.create_dataset(path + "/AlnArray", data=arr)
        ag.create_dataset("Path", data=np.array(paths))
        h5.close()


@dataclass
class CmpH5:
    """Read view of a cmp.h5 written by CmpH5Writer (or compatible)."""

    index: np.ndarray                  # uint32 [n, 22]
    ref_names: List[str]
    movie_names: Dict[int, str]
    group_paths: Dict[int, str]
    h5: object

    @staticmethod
    def open(path: str) -> "CmpH5":
        import h5py
        h5 = h5py.File(path, "r+")
        idx = np.asarray(h5["AlnInfo/AlnIndex"])
        refs = [x.decode() if isinstance(x, bytes) else str(x)
                for x in h5["RefInfo/FullName"]]
        movies = {int(i): (n.decode() if isinstance(n, bytes) else str(n))
                  for i, n in zip(h5["MovieInfo/ID"], h5["MovieInfo/Name"])}
        groups = {int(i): (p.decode() if isinstance(p, bytes) else str(p))
                  for i, p in zip(h5["AlnGroup/ID"], h5["AlnGroup/Path"])}
        return CmpH5(idx, refs, movies, groups, h5)

    def col(self, name: str) -> np.ndarray:
        return self.index[:, ALN_COLUMNS.index(name)]

    def aln_array(self, row: int) -> np.ndarray:
        gid = int(self.index[row, ALN_COLUMNS.index("AlnGroupID")])
        a = int(self.index[row, ALN_COLUMNS.index("offset_begin")])
        b = int(self.index[row, ALN_COLUMNS.index("offset_end")])
        return np.asarray(self.h5[self.group_paths[gid] + "/AlnArray"][a:b])

    def close(self) -> None:
        self.h5.close()

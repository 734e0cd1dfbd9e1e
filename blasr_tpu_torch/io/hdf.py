# Copied from blasr_tpu/io/hdf.py; only the imports differ (blasr_tpu -> blasr_tpu_torch).
"""HDF5 (bax.h5 / bas.h5 / plx.h5 / ccs.h5) I/O via h5py.

Reference parity for the libpbihdf layer (``HDFBasReader``,
``HDFRegionTableReader``, ``HDFPlsReader`` usage: Blasr.cpp:22,1276,1364,
1367-1402) and the region-table semantics of ``MakePrimaryIntervals``
(Blasr.cpp:89-179): per-ZMW Insert regions clipped to the HQ region become
subread intervals; ``-noSplitSubreads`` takes the whole HQ span.

Layout written/read (bas.h5 1.x conventions):
  /PulseData/BaseCalls/Basecall            uint8 ASCII, ZMW-concatenated
  /PulseData/BaseCalls/{QualityValue,InsertionQV,DeletionQV,
                        SubstitutionQV,MergeQV}   uint8 (optional)
  /PulseData/BaseCalls/{DeletionTag,SubstitutionTag} uint8 ASCII (optional)
  /PulseData/BaseCalls/ZMW/{HoleNumber,NumEvent,HoleStatus}
  /PulseData/Regions                       int32 [n, 5] + RegionTypes attr
  /ScanData/RunInfo                        attrs: MovieName
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from blasr_tpu_torch.io.fasta import FastaRecord, encode

REGION_TYPES = ["Adapter", "Insert", "HQRegion"]
REGION_COLUMNS = ["HoleNumber", "RegionType", "RegionStart", "RegionEnd",
                  "RegionScore"]
QV_TRACKS = ["QualityValue", "InsertionQV", "DeletionQV", "SubstitutionQV",
             "MergeQV"]
TAG_TRACKS = ["DeletionTag", "SubstitutionTag"]
# per-base pulse metrics (LoadPulses.cpp metric sources): frame counts are
# uint16, MidSignal (pkmid source) uint16
FRAME_TRACKS = ["PreBaseFrames", "WidthInFrames", "MidSignal"]


def expand_multipart(path: str) -> List[str]:
    """A new-style bas.h5 may carry no /PulseData but a /MultiPart/Parts
    dataset naming its bax.h5 parts (ctest/multipart.t; the reference's
    HDFBasReader part expansion).  Returns the part paths — relative
    names resolve against the bas.h5 directory — or [path] when the file
    is not multipart."""
    import os

    import h5py
    try:
        with h5py.File(path, "r") as f:
            if "MultiPart/Parts" not in f:
                return [path]
            parts = [p.decode() if isinstance(p, bytes) else str(p)
                     for p in f["MultiPart/Parts"][:]]
    except OSError:
        return [path]
    d = os.path.dirname(os.path.abspath(path))
    return [p if os.path.isabs(p) else os.path.join(d, p) for p in parts]


@dataclass
class RegionTable:
    """Per-ZMW region rows (HDFRegionTableReader analog)."""

    rows: np.ndarray                      # int32 [n, 5]
    types: List[str] = field(default_factory=lambda: list(REGION_TYPES))

    def _type_id(self, name: str) -> int:
        return self.types.index(name)

    def for_hole(self, hole: int) -> np.ndarray:
        return self.rows[self.rows[:, 0] == hole]

    def hq_region(self, hole: int) -> Optional[Tuple[int, int, int]]:
        """(start, end, score) of the HQ region, or None
        (LookupHQRegion analog)."""
        tid = self._type_id("HQRegion")
        r = self.for_hole(hole)
        r = r[r[:, 1] == tid]
        if len(r) == 0:
            return None
        return int(r[0, 2]), int(r[0, 3]), int(r[0, 4])

    def insert_intervals(self, hole: int) -> List[Tuple[int, int]]:
        tid = self._type_id("Insert")
        r = self.for_hole(hole)
        r = r[r[:, 1] == tid]
        return [(int(a), int(b)) for a, b in zip(r[:, 2], r[:, 3])]

    def subread_intervals(self, hole: int, min_score: int = 0,
                          split: bool = True,
                          use_hq: bool = True) -> List[Tuple[int, int]]:
        """Insert regions clipped to the HQ region
        (GetHighQualitySubreadsIntervals; MakePrimaryIntervals
        Blasr.cpp:89-179).  split=False returns the whole HQ span
        (-noSplitSubreads); use_hq=False skips HQ clipping and the score
        gate (--ignoreHQRegions)."""
        hq = self.hq_region(hole) if use_hq else None
        if hq is not None and hq[2] < min_score:
            return []
        lo, hi = (hq[0], hq[1]) if hq is not None else (0, 1 << 30)
        if not split:
            return [(lo, hi)] if hi > lo else []
        out = []
        for a, b in self.insert_intervals(hole):
            a2, b2 = max(a, lo), min(b, hi)
            if b2 > a2:
                out.append((a2, b2))
        if not out and hq is None:
            return []
        return out


@dataclass
class ZmwRead:
    hole: int
    seq: np.ndarray                        # codes 0..4
    tracks: Dict[str, np.ndarray] = field(default_factory=dict)


class BaxReader:
    """Read a bax/bas/plx/ccs .h5 movie file."""

    def __init__(self, path: str, region_path: Optional[str] = None):
        # region_path: separate region-table file (--regionTable rgn.h5,
        # RegisterBlasrOptions.h:34) overriding the movie's own Regions
        import h5py
        self.h5 = h5py.File(path, "r")
        self._region_h5 = h5py.File(region_path, "r") if region_path else None
        # ccs.h5 carries ConsensusBaseCalls (the primary reads) alongside
        # the raw BaseCalls; prefer the consensus group when present
        base = ("PulseData/ConsensusBaseCalls"
                if "PulseData/ConsensusBaseCalls" in self.h5
                else "PulseData/BaseCalls")
        self.base = base
        bc = self.h5[base]
        self.holes = np.asarray(bc["ZMW/HoleNumber"])
        self.num_event = np.asarray(bc["ZMW/NumEvent"])
        self.offsets = np.concatenate(
            [[0], np.cumsum(self.num_event)]).astype(np.int64)
        # ccs.h5 carries BOTH the consensus calls and the raw polymerase
        # calls + Passes (CCSIterator / FragmentCCSIterator inputs,
        # Blasr.cpp:639-708)
        self.raw = None
        if (base == "PulseData/ConsensusBaseCalls"
                and "PulseData/BaseCalls" in self.h5):
            rb = self.h5["PulseData/BaseCalls"]
            self.raw_num_event = np.asarray(rb["ZMW/NumEvent"])
            self.raw_offsets = np.concatenate(
                [[0], np.cumsum(self.raw_num_event)]).astype(np.int64)
            self.raw = rb
        self.passes = None
        pg = base + "/Passes"
        if pg in self.h5:
            p = self.h5[pg]
            npass = np.asarray(p["NumPasses"])
            poff = np.concatenate([[0], np.cumsum(npass)]).astype(np.int64)
            self.passes = {
                "offsets": poff,
                "direction": np.asarray(p["PassDirection"]),
                "start": np.asarray(p["PassStartBase"]),
                "nbases": np.asarray(p["PassNumBases"]),
                "before": (np.asarray(p["AdapterHitBefore"])
                           if "AdapterHitBefore" in p else None),
                "after": (np.asarray(p["AdapterHitAfter"])
                          if "AdapterHitAfter" in p else None),
            }
        self.movie = "movie"
        if "ScanData/RunInfo" in self.h5:
            attrs = self.h5["ScanData/RunInfo"].attrs
            if "MovieName" in attrs:
                v = attrs["MovieName"]
                self.movie = v.decode() if isinstance(v, bytes) else str(v)
        self.region_table = None
        rsrc = self._region_h5 if self._region_h5 is not None else self.h5
        if "PulseData/Regions" in rsrc:
            ds = rsrc["PulseData/Regions"]
            types = list(REGION_TYPES)
            if "RegionTypes" in ds.attrs:
                types = [t.decode() if isinstance(t, bytes) else str(t)
                         for t in ds.attrs["RegionTypes"]]
            self.region_table = RegionTable(np.asarray(ds), types)

    def read_zmw(self, i: int) -> ZmwRead:
        bc = self.h5[self.base]
        a, b = int(self.offsets[i]), int(self.offsets[i + 1])
        seq = encode(bytes(np.asarray(bc["Basecall"][a:b])))
        tracks = {}
        for t in QV_TRACKS + TAG_TRACKS + FRAME_TRACKS:
            if t in bc:
                tracks[t] = np.asarray(bc[t][a:b])
        return ZmwRead(int(self.holes[i]), seq, tracks)

    def subreads(self, min_score: int = 0, split: bool = True,
                 with_quals: bool = True, use_regions: bool = True,
                 use_hq: bool = True) -> List[FastaRecord]:
        """All subread records, named movie/hole/start_end
        (the ReaderAgglomerate HDF input path).  use_regions=False ignores
        the region table entirely (--ignoreRegions); use_hq=False skips HQ
        clipping (--ignoreHQRegions)."""
        out: List[FastaRecord] = []
        # consensus reads keep the movie/hole/ccs naming convention
        # (reference CcsConverter.cpp:86; region intervals describe raw
        # polymerase coordinates and never split a consensus)
        is_ccs = self.base == "PulseData/ConsensusBaseCalls"
        for i in range(len(self.holes)):
            z = self.read_zmw(i)
            if is_ccs:
                ivals = [(0, len(z.seq))] if len(z.seq) else []
            elif self.region_table is not None and use_regions:
                ivals = self.region_table.subread_intervals(
                    z.hole, min_score, split, use_hq=use_hq)
            else:
                ivals = [(0, len(z.seq))] if len(z.seq) else []
            for s, e in ivals:
                e = min(e, len(z.seq))
                if e <= s:
                    continue
                qual = None
                if with_quals and "QualityValue" in z.tracks:
                    qual = z.tracks["QualityValue"][s:e].astype(np.int32)
                tracks = ({n: v[s:e] for n, v in z.tracks.items()}
                          if z.tracks else None)
                name = (f"{self.movie}/{z.hole}/ccs" if is_ccs
                        else f"{self.movie}/{z.hole}/{s}_{e}")
                out.append(FastaRecord(name, z.seq[s:e], qual,
                                       tracks=tracks))
        return out

    def ccs_passes(self, i: int, full_only: bool = False):
        """Subread pass records of ZMW i from the raw polymerase read
        (FragmentCCSIterator per-pass direction/start/numBases; full_only
        keeps adapter-bounded passes — the useccs vs useccsall split,
        Blasr.cpp:639-708).  Returns FastaRecords in template (forward CCS)
        orientation, named movie/hole/start_end."""
        from blasr_tpu_torch.io.fasta import revcomp
        if self.passes is None or self.raw is None:
            return []
        hole = int(self.holes[i])
        a, b = (int(self.passes["offsets"][i]),
                int(self.passes["offsets"][i + 1]))
        ra, rb_off = int(self.raw_offsets[i]), int(self.raw_offsets[i + 1])
        raw_seq = encode(bytes(np.asarray(self.raw["Basecall"][ra:rb_off])))
        out = []
        for j in range(a, b):
            if full_only and self.passes["before"] is not None:
                if not (self.passes["before"][j]
                        and self.passes["after"][j]):
                    continue
            s = int(self.passes["start"][j])
            n = int(self.passes["nbases"][j])
            sub = raw_seq[s:s + n]
            if len(sub) == 0:
                continue
            if int(self.passes["direction"][j]) == 1:
                sub = revcomp(sub)
            out.append(FastaRecord(f"{self.movie}/{hole}/{s}_{s + n}", sub))
        return out

    def ccs_groups(self, full_only: bool = False):
        """[(consensus_record, [pass_records])] for CCS mapping modes."""
        groups = []
        for i in range(len(self.holes)):
            z = self.read_zmw(i)
            if not len(z.seq):
                continue
            qual = z.tracks.get("QualityValue")
            ccs = FastaRecord(
                f"{self.movie}/{z.hole}/ccs", z.seq,
                qual.astype(np.int32) if qual is not None else None)
            groups.append((ccs, self.ccs_passes(i, full_only)))
        return groups

    def close(self) -> None:
        self.h5.close()
        if self._region_h5 is not None:
            self._region_h5.close()


def write_ccs(path: str, movie: str, ccs_zmws: Sequence[ZmwRead],
              raw_zmws: Sequence[ZmwRead], passes: Sequence[Sequence[tuple]]
              ) -> None:
    """Write a ccs.h5 with consensus calls, raw polymerase calls, and the
    Passes group.  passes[i] = [(direction, start, nbases, adapter_before,
    adapter_after), ...] for ZMW i."""
    import h5py
    from blasr_tpu_torch.io.fasta import decode
    write_bax(path, movie, ccs_zmws, ccs=True)
    with h5py.File(path, "a") as h5:
        rb = h5.create_group("PulseData/BaseCalls")
        seqs = b"".join(decode(z.seq).encode() for z in raw_zmws)
        rb.create_dataset("Basecall",
                          data=np.frombuffer(seqs, dtype=np.uint8))
        zg = rb.create_group("ZMW")
        zg.create_dataset("HoleNumber", data=np.asarray(
            [z.hole for z in raw_zmws], np.uint32))
        zg.create_dataset("NumEvent", data=np.asarray(
            [len(z.seq) for z in raw_zmws], np.uint32))
        pg = h5.create_group("PulseData/ConsensusBaseCalls/Passes")
        flat = [p for ps in passes for p in ps]
        pg.create_dataset("NumPasses", data=np.asarray(
            [len(ps) for ps in passes], np.uint32))
        pg.create_dataset("PassDirection", data=np.asarray(
            [p[0] for p in flat], np.uint8))
        pg.create_dataset("PassStartBase", data=np.asarray(
            [p[1] for p in flat], np.uint32))
        pg.create_dataset("PassNumBases", data=np.asarray(
            [p[2] for p in flat], np.uint32))
        pg.create_dataset("AdapterHitBefore", data=np.asarray(
            [p[3] for p in flat], np.uint8))
        pg.create_dataset("AdapterHitAfter", data=np.asarray(
            [p[4] for p in flat], np.uint8))


def write_bax(path: str, movie: str, zmws: Sequence[ZmwRead],
              regions: Optional[np.ndarray] = None,
              ccs: bool = False) -> None:
    """Write a bax/ccs .h5 movie file from per-ZMW reads."""
    import h5py
    from blasr_tpu_torch.io.fasta import decode
    base = ("PulseData/ConsensusBaseCalls" if ccs
            else "PulseData/BaseCalls")
    with h5py.File(path, "w") as h5:
        bc = h5.create_group(base)
        seqs = b"".join(decode(z.seq).encode() for z in zmws)
        bc.create_dataset("Basecall",
                          data=np.frombuffer(seqs, dtype=np.uint8))
        present = set()
        for z in zmws:
            present.update(z.tracks)
        for t in sorted(present):
            dt = np.uint16 if t in FRAME_TRACKS else np.uint8
            parts = []
            for z in zmws:
                v = z.tracks.get(t)
                if v is None:
                    v = np.zeros(len(z.seq), dt)
                parts.append(np.asarray(v, dt))
            bc.create_dataset(t, data=np.concatenate(parts)
                              if parts else np.zeros(0, dt))
        zg = bc.create_group("ZMW")
        zg.create_dataset(
            "HoleNumber",
            data=np.asarray([z.hole for z in zmws], np.uint32))
        zg.create_dataset(
            "NumEvent",
            data=np.asarray([len(z.seq) for z in zmws], np.uint32))
        zg.create_dataset(
            "HoleStatus", data=np.zeros(len(zmws), np.uint8))
        if regions is not None:
            ds = h5.create_dataset(
                "PulseData/Regions", data=np.asarray(regions, np.int32))
            ds.attrs["RegionTypes"] = np.array(
                [t.encode() for t in REGION_TYPES])
            ds.attrs["ColumnNames"] = np.array(
                [c.encode() for c in REGION_COLUMNS])
        sd = h5.create_group("ScanData/RunInfo")
        sd.attrs["MovieName"] = movie.encode()


def is_hdf(path: str) -> bool:
    low = path.lower()
    if low.endswith((".bax.h5", ".bas.h5", ".plx.h5", ".pls.h5", ".ccs.h5",
                     ".h5")):
        return True
    try:
        with open(path, "rb") as f:
            return f.read(8) == b"\x89HDF\r\n\x1a\n"
    except OSError:
        return False

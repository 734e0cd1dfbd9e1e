# Copied from blasr_tpu/io/refbin.py; only the imports differ (blasr_tpu -> blasr_tpu_torch).
"""Reference binary ``.ctab`` and ``.bwt`` artifact interop.

Companion to :mod:`blasr_tpu.io.refsa` — the reference persists two more
index artifacts as raw binary files, both serialized by code living in the
empty ``libcpp`` submodule, so the layouts below are reconstructed from the
visible call sites and the serialization idiom the library uses elsewhere
(flat little-endian ints, a leading component/length header; see
extrautils/SALS.cpp:25-37 for the ``.sa`` precedent).

``.ctab`` — TupleCountTable (genome k-mer counts)
    Written by ``printTupleCountTable`` (extrautils/PrintTupleCountTable.cpp:
    ``table.Write(tableOut)`` after ``InitCountTable(tm)`` +
    ``AddSequenceTupleCountsLR``), read back by ``blasr --ctab``
    (Blasr.cpp:1136-1147: ``ct.Read(ctIn)`` then ``saLookupTupleMetrics =
    ct.tm`` — so the file must carry the tuple size).  The table is a flat
    ``int[4^tupleSize]`` count array plus the total tuple count:

        int32 countTableLength        # 4^tupleSize
        int32 nTuples                 # sum of counts
        int32 tupleSize               # k (TupleMetrics)
        int32 counts[countTableLength]

    ``read_ref_ctab`` validates countTableLength == 4^tupleSize and the
    section size against the file length and raises ``ValueError`` with a
    precise reason instead of misparsing.

``.bwt`` — BWT-FM index
    Written by ``sa2bwt`` (extrautils/SuffixArrayToBWT.cpp:43-44:
    ``bwt.InitializeFromSuffixArray(seq, suffixArray.index); bwt.Write``),
    read by ``blasr --bwt`` (Blasr.cpp:1073-1080, ``bwt.Read`` returning a
    status) and inverted by ``bwt2sa`` (BwtToSuffixArray.cpp:25-31, which
    shows ``bwtSequence.length`` includes the sentinel: the SA it recovers
    has ``length-1`` entries and rows are 1-based for ``Locate``).  The
    exact ``Bwt<PackedDNASequence, FASTASequence>`` byte layout (nibble
    packing, occ-table block structure) is inside the empty submodule and
    cannot be pinned from this snapshot; the layout here keeps the visible
    contract (length counts the sentinel; everything needed by ``Locate``
    is present) in the library's component-header idiom:

        int32  comps[3]               # {sequence, counts, positions} flags
        uint32 length                 # n + 1 (includes the sentinel row)
        uint8  bwt[length]            # codes 0..3 ACGT, 4 N, 5 sentinel
        int64  counts[6]              # C[c]: # of codes < c in the text
        int32  sampleRate
        uint32 nSamples
        uint32 saSample[nSamples]     # SA values at rows ≡ 0 mod rate

    Files produced by an actual reference build may deviate in the packed
    section; ``read_ref_bwt`` validates every section size and raises
    ``ValueError`` rather than misparsing.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

CTAB_MAX_K = 14          # 4^14 ints = 1 GiB; larger headers are bogus
BWT_COMP_NUM = 3


# ----------------------------------------------------------------- .ctab
def is_ref_ctab(path: str) -> bool:
    """Cheap sniff: not a zip (.npz) and a self-consistent header."""
    try:
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            head = f.read(12)
    except OSError:
        return False
    if len(head) < 12 or head[:2] == b"PK":
        return False
    length, _ntup, k = np.frombuffer(head, dtype="<i4")
    return bool(0 < k <= CTAB_MAX_K and length == 4 ** int(k)
                and size == 12 + 4 * int(length))


def read_ref_ctab(path: str) -> Tuple[int, np.ndarray]:
    """Returns (tuple_size, int32 counts[4^tuple_size])."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        head = np.fromfile(f, dtype="<i4", count=3)
        if head.size != 3:
            raise ValueError(f"{path}: truncated ctab header")
        length, ntuples, k = (int(x) for x in head)
        if not (0 < k <= CTAB_MAX_K):
            raise ValueError(f"{path}: bad ctab tupleSize {k}")
        if length != 4 ** k:
            raise ValueError(
                f"{path}: countTableLength {length} != 4^{k}")
        if size != 12 + 4 * length:
            raise ValueError(
                f"{path}: ctab wants {4 * length} count bytes, file has "
                f"{size - 12}")
        counts = np.fromfile(f, dtype="<i4", count=length)
    if int(counts.sum()) != ntuples:
        raise ValueError(
            f"{path}: nTuples {ntuples} != sum of counts {int(counts.sum())}")
    return k, counts.astype(np.int32)


def write_ref_ctab(path: str, k: int, counts: np.ndarray) -> None:
    counts = np.ascontiguousarray(counts, dtype="<i4")
    if counts.size != 4 ** k:
        raise ValueError(f"counts size {counts.size} != 4^{k}")
    with open(path, "wb") as f:
        np.asarray([counts.size, int(counts.sum()), k],
                   dtype="<i4").tofile(f)
        counts.tofile(f)


def load_any_ctab(path: str) -> Tuple[int, np.ndarray]:
    """Dispatch on content: reference binary layout or our .npz."""
    if is_ref_ctab(path):
        return read_ref_ctab(path)
    z = np.load(path, allow_pickle=False)
    return int(z["k"]), z["counts"]


# ------------------------------------------------------------------ .bwt
def is_ref_bwt(path: str) -> bool:
    try:
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            head = f.read(4 * BWT_COMP_NUM + 4)
    except OSError:
        return False
    if len(head) < 4 * BWT_COMP_NUM + 4 or head[:2] == b"PK":
        return False
    comps = np.frombuffer(head[:12], dtype="<i4")
    n = int(np.frombuffer(head[12:16], dtype="<u4")[0])
    return bool(np.all((comps == 0) | (comps == 1)) and comps[0]
                and 0 < n <= size)


def read_ref_bwt(path: str):
    """Returns (bwt codes uint8[n+1], counts int64[6],
    sample_rate | None, sa_sample | None)."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        comps = np.fromfile(f, dtype="<i4", count=BWT_COMP_NUM)
        if comps.size != BWT_COMP_NUM or not np.all(
                (comps == 0) | (comps == 1)) or not comps[0]:
            raise ValueError(f"{path}: not a bwt (bad component bitmap)")
        n = np.fromfile(f, dtype="<u4", count=1)
        if n.size != 1:
            raise ValueError(f"{path}: truncated bwt length")
        n = int(n[0])
        if f.tell() + n > size:
            raise ValueError(
                f"{path}: bwt sequence wants {n} bytes, file has "
                f"{size - f.tell()}")
        bwt = np.fromfile(f, dtype=np.uint8, count=n)
        if bwt.max(initial=0) > 5:
            raise ValueError(f"{path}: bwt codes out of range 0..5")
        counts = sample_rate = sa_sample = None
        if comps[1]:
            counts = np.fromfile(f, dtype="<i8", count=6)
            if counts.size != 6:
                raise ValueError(f"{path}: truncated counts section")
            counts = counts.astype(np.int64)
        if comps[2]:
            hdr = np.fromfile(f, dtype="<i4", count=1)
            ns = np.fromfile(f, dtype="<u4", count=1)
            if hdr.size != 1 or ns.size != 1 or int(hdr[0]) <= 0:
                raise ValueError(f"{path}: bad position-sample header")
            sample_rate, ns = int(hdr[0]), int(ns[0])
            sa_sample = np.fromfile(f, dtype="<u4", count=ns)
            if sa_sample.size != ns:
                raise ValueError(
                    f"{path}: position section wants {ns} entries, got "
                    f"{sa_sample.size}")
        if counts is None:
            hist = np.bincount(bwt, minlength=6)
            counts = np.concatenate(
                [[0], np.cumsum(hist)[:-1]]).astype(np.int64)
    return bwt, counts, sample_rate, sa_sample


def write_ref_bwt(path: str, bwt: np.ndarray, counts: np.ndarray,
                  sample_rate: Optional[int] = None,
                  sa_sample: Optional[np.ndarray] = None) -> None:
    comps = np.zeros(BWT_COMP_NUM, dtype="<i4")
    comps[0] = 1
    comps[1] = counts is not None
    comps[2] = sa_sample is not None
    with open(path, "wb") as f:
        comps.tofile(f)
        bwt = np.ascontiguousarray(bwt, dtype=np.uint8)
        np.asarray([bwt.size], dtype="<u4").tofile(f)
        bwt.tofile(f)
        if counts is not None:
            np.ascontiguousarray(counts, dtype="<i8").tofile(f)
        if sa_sample is not None:
            np.asarray([sample_rate], dtype="<i4").tofile(f)
            sa = np.ascontiguousarray(sa_sample, dtype="<u4")
            np.asarray([sa.size], dtype="<u4").tofile(f)
            sa.tofile(f)

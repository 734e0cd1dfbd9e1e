# Copied from blasr_tpu/io/refsa.py; only the imports differ (blasr_tpu -> blasr_tpu_torch).
"""Reference binary ``.sa`` (suffix array) interop.

The reference persists its suffix array with ``SuffixArray::Write``
(utils/SAWriter.cpp:239, extrautils/SAModify.cpp:74) and inspects it with
``LightRead`` (extrautils/SALS.cpp:20-37).  The algorithm library holding
the exact serializer is an empty submodule in this snapshot, so the layout
below is reconstructed from every visible call site:

* ``sals`` reads a ``componentList[]`` indexed by ``CompArray`` and
  ``CompLookupTable`` and then ``lookupPrefixLength``
  (extrautils/SALS.cpp:25-37) — so the file leads with a component
  bitmap and the lookup table carries its prefix length.
* the SA is a flat 32-bit index array bounded by the 4 Gbp limit
  (utils/SAWriter.cpp:186-193), with ``length`` stored alongside
  (``SuffixArray`` fields ``index, length`` per iblasr/MappingIPC.h:45-56).
* the lookup table maps every p-mer to an SA bucket via
  ``startPosTable``/``endPosTable`` (MappingIPC.h:45-56); adjacent buckets
  share boundaries, so one ``4^p + 1`` boundary table round-trips both.

Layout (little-endian):

    int32  componentList[3]        # {array, lookup table, LCP} present flags
    if componentList[0]:
        uint32 length
        uint32 index[length]
    if componentList[1]:
        int32  lookupPrefixLength  # p
        uint32 table[4^p + 1]      # SA bucket boundaries per p-mer

Files written by a different build of the reference may deviate in the
optional sections; ``read_ref_sa`` validates section sizes against the
file length and raises ``ValueError`` with a precise reason instead of
misparsing.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

COMP_NUM = 3  # CompArray, CompLookupTable, CompLCPTable


def is_ref_sa(path: str) -> bool:
    """Cheap sniff: not a zip (.npz) and a plausible component bitmap."""
    try:
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            head = f.read(4 * COMP_NUM)
    except OSError:
        return False
    if len(head) < 4 * COMP_NUM or head[:2] == b"PK":
        return False
    comps = np.frombuffer(head, dtype="<i4")
    return bool(np.all((comps == 0) | (comps == 1)) and comps.any()
                and size > 4 * COMP_NUM)


def read_ref_sa(path: str) -> Tuple[Optional[np.ndarray],
                                    Optional[int], Optional[np.ndarray]]:
    """Returns (suffix_array | None, lookup_prefix_len | None,
    lookup_table | None)."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        comps = np.fromfile(f, dtype="<i4", count=COMP_NUM)
        if comps.size != COMP_NUM or not np.all((comps == 0) | (comps == 1)):
            raise ValueError(f"{path}: not a reference .sa "
                             "(bad component bitmap)")
        sa = None
        if comps[0]:
            n = np.fromfile(f, dtype="<u4", count=1)
            if n.size != 1:
                raise ValueError(f"{path}: truncated SA length")
            n = int(n[0])
            need = f.tell() + 4 * n
            if need > size:
                raise ValueError(
                    f"{path}: SA section wants {4 * n} bytes, file has "
                    f"{size - f.tell()}")
            sa = np.fromfile(f, dtype="<u4", count=n)
        p = table = None
        if comps[1]:
            pl = np.fromfile(f, dtype="<i4", count=1)
            if pl.size != 1 or not (0 < int(pl[0]) <= 16):
                raise ValueError(f"{path}: bad lookupPrefixLength")
            p = int(pl[0])
            m = 4 ** p + 1
            table = np.fromfile(f, dtype="<u4", count=m)
            if table.size != m:
                raise ValueError(
                    f"{path}: lookup table wants {m} entries, got "
                    f"{table.size}")
        return sa, p, table


def write_ref_sa(path: str, sa: Optional[np.ndarray],
                 lookup_prefix_len: Optional[int] = None,
                 lookup_table: Optional[np.ndarray] = None) -> None:
    comps = np.zeros(COMP_NUM, dtype="<i4")
    comps[0] = sa is not None
    comps[1] = lookup_table is not None
    with open(path, "wb") as f:
        comps.tofile(f)
        if sa is not None:
            sa = np.ascontiguousarray(sa, dtype="<u4")
            np.asarray([sa.size], dtype="<u4").tofile(f)
            sa.tofile(f)
        if lookup_table is not None:
            np.asarray([lookup_prefix_len], dtype="<i4").tofile(f)
            np.ascontiguousarray(lookup_table, dtype="<u4").tofile(f)


def lookup_table_from_sa(genome: np.ndarray, sa: np.ndarray,
                         p: int) -> np.ndarray:
    """SA bucket boundaries per p-mer (BuildLookupTable analog): entry i is
    the first SA slot whose suffix starts with p-mer i; suffixes shorter
    than p or containing non-ACGT sort outside every bucket's range."""
    G = len(genome)
    # p-mer key at each genome position (BIG for invalid)
    keys = np.zeros(G, dtype=np.int64)
    ok = np.ones(G, dtype=bool)
    g = genome.astype(np.int64)
    for j in range(p):
        shifted = np.concatenate([g[j:], np.full(j, 4, np.int64)])
        keys = (keys << 2) | (shifted & 3)
        ok &= shifted < 4
    ok &= np.arange(G) + p <= G
    valid = ok[sa]
    sa_keys = np.where(valid, keys[sa], -1)
    # valid keys are nondecreasing along a correct SA; slots with short or
    # N-containing prefixes inherit the preceding bucket so the boundary
    # table stays monotone and covers every slot
    keys_mono = np.maximum.accumulate(sa_keys)
    table = np.searchsorted(keys_mono, np.arange(4 ** p + 1), side="left")
    return table.astype(np.uint32)

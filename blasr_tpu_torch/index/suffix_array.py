# Copied from blasr_tpu/index/suffix_array.py; only the imports differ (blasr_tpu -> blasr_tpu_torch).
"""Suffix-array construction (host-side, index-build time).

Reference parity: sawriter's construction algorithms (Larsson-Sadakane et al,
utils/SAWriter.cpp:201-235) all produce the same artifact — the
lexicographic suffix order.  We build that artifact with a NumPy
prefix-doubling (Manber-Myers) algorithm, O(n log^2 n) fully vectorized,
optionally accelerated by the C++ SA-IS extension in blasr_tpu/native.
The hot mapping path does NOT binary-search this SA at runtime; it uses the
sorted fixed-k k-mer index (see index/genome.py), which is the TPU-friendly
equivalent of SA prefix-lookup + binary search (Blasr.cpp:1082-1121).
"""

from __future__ import annotations

import numpy as np


def build_suffix_array_numpy(codes: np.ndarray) -> np.ndarray:
    """Suffix array by prefix doubling over int codes (any small alphabet).

    Returns int32/int64 positions sorted by suffix lexicographic order.
    The (virtual) suffix terminator sorts before all characters, matching
    conventional suffix-array order.
    """
    s = np.asarray(codes)
    n = len(s)
    if n == 0:
        return np.zeros(0, dtype=np.int32)
    dtype = np.int64 if n > 2**31 - 2 else np.int32
    # initial rank = character code (+1 so that 0 can mean "past the end")
    rank = (s.astype(np.int64) + 1)
    idx = np.arange(n, dtype=np.int64)
    k = 1
    while True:
        # key = (rank[i], rank[i+k] or 0)
        second = np.zeros(n, dtype=np.int64)
        second[: n - k] = rank[k:]
        order = np.lexsort((second, rank))
        # new ranks: 1 + number of strictly-smaller keys
        r_sorted = rank[order]
        s_sorted = second[order]
        changed = np.empty(n, dtype=np.int64)
        changed[0] = 1
        if n > 1:
            diff = (r_sorted[1:] != r_sorted[:-1]) | (s_sorted[1:] != s_sorted[:-1])
            changed[1:] = diff
        new_rank_sorted = np.cumsum(changed)
        rank = np.empty(n, dtype=np.int64)
        rank[order] = new_rank_sorted
        if new_rank_sorted[-1] == n:
            return order.astype(dtype)
        k *= 2
        if k >= n:
            return order.astype(dtype)


def build_suffix_array(codes: np.ndarray) -> np.ndarray:
    """SA via the native SA-IS extension when available, else NumPy doubling."""
    try:
        from blasr_tpu_torch.native import sais_native
        sa = sais_native(np.asarray(codes, dtype=np.uint8))
        if sa is not None:
            return sa
    except Exception:
        pass
    return build_suffix_array_numpy(codes)


def build_lookup_table(codes: np.ndarray, sa: np.ndarray, prefix_len: int = 8):
    """Prefix lookup table bounding the SA range per p-mer
    (reference BuildLookupTable, Blasr.cpp:1101; default p=8).

    Returns (starts, ends) int arrays of length 4**p + 1 convention:
    bucket b covers sa[starts[b]:ends[b]].  Suffixes containing a non-ACGT
    base or shorter than p in their first p characters are excluded.
    """
    p = prefix_len
    n = len(codes)
    s = np.asarray(codes, dtype=np.int64)
    # base-5 prefix key per position (N = 4 participates as an ordinary
    # digit): lexicographic SA order makes this key monotone along the SA,
    # so every bucket's suffixes are one contiguous SA range even though
    # N-containing suffixes interleave between valid buckets
    key5 = np.zeros(n, dtype=np.int64)
    for j in range(p):
        d = np.full(n, 4, dtype=np.int64)
        d[: n - j] = np.minimum(s[j:], 4)
        key5 = key5 * 5 + d
    sa_key5 = key5[sa]
    # expand each valid base-4 bucket id into its base-5 key
    nb = 4**p
    b = np.arange(nb, dtype=np.int64)
    b5 = np.zeros(nb, dtype=np.int64)
    for j in range(p):
        b5 = b5 * 5 + ((b >> (2 * (p - 1 - j))) & 3)
    starts = np.searchsorted(sa_key5, b5, side="left")
    ends = np.searchsorted(sa_key5, b5, side="right")
    return starts.astype(np.int64), ends.astype(np.int64)


def kmer_keys(codes: np.ndarray, k: int):
    """(keys, valid) for every position: base-4 packed k-mer starting there.

    valid[i] == True iff positions i..i+k-1 exist and contain only ACGT.
    Invalid or out-of-range positions get key 0.
    """
    s = np.asarray(codes, dtype=np.uint8)
    n = len(s)
    if n < k:
        return np.zeros(n, dtype=np.uint64), np.zeros(n, dtype=bool)
    # uint32 path for k <= 16 (one third the memory traffic of int64 —
    # matters for 100 Mbp+ genomes); the rolling OR works in-place on
    # precomputed base codes so each of the k passes allocates nothing
    dt = np.uint32 if k <= 16 else np.uint64
    s2 = (s & 3).astype(dt)
    okbase = s < 4
    keys = s2.copy()
    ok = okbase.copy()
    for j in range(1, k):
        keys <<= dt(2)
        # the j-shifted tail pad is 'N' (code 4): key bits 0, valid False
        np.bitwise_or(keys[: n - j], s2[j:], out=keys[: n - j])
        np.logical_and(ok[: n - j], okbase[j:], out=ok[: n - j])
        ok[n - j:] = False
    ok[n - k + 1:] = False
    keys[~ok] = 0
    return keys.astype(np.uint64) if dt == np.uint64 else keys, ok

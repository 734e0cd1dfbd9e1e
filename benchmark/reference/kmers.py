# Frozen copy of kmer_keys from blasr_tpu_torch/index/suffix_array.py.
"""Base-4 packed k-mer keys of a genome (index build)."""

from __future__ import annotations

import numpy as np


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

# Frozen copy of blasr_tpu_torch/pipeline/metrics.py: the plain PyTorch path only,
# imports pointed inside benchmark/reference (see __init__.py).
"""Mapping metrics: named timers + counters.

Re-derivation of the reference's ``MappingMetrics`` clocks
(BlasrAlignImpl.hpp:22-348: total, mapToGenome, sortMatchPosList,
findMaxIncreasingInterval, alignIntervals; counters numReads,
totalAnchors, cells/bases) with the same summary-print contract
(--metrics, Blasr.cpp:958-964,1520-1525).  Device stages are fused under
jit, so stage timing is per-jit-call wall clock plus device counters
returned by the kernels (anchors found, candidates kept, DP cells).
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict


class MappingMetrics:
    def __init__(self, store_list: bool = False):
        self.clocks: Dict[str, float] = defaultdict(float)
        self.counters: Dict[str, int] = defaultdict(int)
        self.store_list = store_list
        self.lists: Dict[str, list] = defaultdict(list)

    @contextmanager
    def clock(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.clocks[name] += dt
            if self.store_list:
                self.lists[name].append(dt)

    def add(self, name: str, n: int = 1) -> None:
        self.counters[name] += int(n)

    def collect(self, other: "MappingMetrics") -> None:
        """Merge another metrics object (reference: per-thread Collect,
        Blasr.cpp:1454,1490)."""
        for k, v in other.clocks.items():
            self.clocks[k] += v
        for k, v in other.counters.items():
            self.counters[k] += v


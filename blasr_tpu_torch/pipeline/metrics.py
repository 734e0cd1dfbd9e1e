# Copied from blasr_tpu/pipeline/metrics.py; only the imports differ.
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

import json
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, TextIO


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

    def print_summary(self, f: TextIO) -> None:
        for k in sorted(self.clocks):
            f.write(f"{k} {self.clocks[k]:.4f}\n")
        for k in sorted(self.counters):
            f.write(f"{k} {self.counters[k]}\n")

    def print_full(self, f: TextIO) -> None:
        self.print_summary(f)
        for k in sorted(self.lists):
            f.write(f"{k}_list {json.dumps(self.lists[k])}\n")

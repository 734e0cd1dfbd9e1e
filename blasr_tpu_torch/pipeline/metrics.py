# MappingMetrics is copied from blasr_tpu/pipeline/metrics.py; its clock
# also opens a timeline span.  span(), timeline(), count() and the sink
# that Mapper.map_reads sets are the port's own.
"""Mapping metrics: named timers + counters.

Re-derivation of the reference's ``MappingMetrics`` clocks
(BlasrAlignImpl.hpp:22-348: total, mapToGenome, sortMatchPosList,
findMaxIncreasingInterval, alignIntervals; counters numReads,
totalAnchors, cells/bases) with the same summary-print contract
(--metrics, Blasr.cpp:958-964,1520-1525).  Device stages are fused under
jit, so stage timing is per-jit-call wall clock plus device counters
returned by the kernels (anchors found, candidates kept, DP cells).

Spans.  :func:`span` times a stretch of host code into the ``clocks``
and ``counters`` of the sink, the metrics of the Mapper whose outermost
``map_reads`` started last (:func:`records_spans`), so code that runs
without a Mapper (the CLI's ``emit``, ``unpack_batch``) reports to the
object ``--metrics`` prints; code that has a Mapper times its spans on
the Mapper's own :meth:`MappingMetrics.clock`, under dotted names such
as ``collect.survey``.  While a torch.profiler records, a span
and every :meth:`MappingMetrics.clock` also open a ``record_function``
range of the same name (:func:`timeline`), on the clock of the device
events; with no profiler they enter none (a ``record_function`` costs
~15 us even then).  A span taken once a read or more often is kept to
its clock (``timeline=False``): with a profiler on, such ranges made
the CLI's output ~20% slower on an H100 machine's host.  Names are fixed
strings, so the profiler sums them.
"""

from __future__ import annotations

import contextlib
import functools
import json
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, Optional, TextIO

import torch.autograd.profiler as _profiler


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
            with timeline(name):
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


_NO_RANGE = contextlib.nullcontext()
# the metrics spans and counts go into (see records_spans)
_sink: Optional[MappingMetrics] = None
_depth = 0


def timeline(name: str):
    """A torch.profiler range ``name`` while a profiler records, else a
    context that does nothing."""
    if _profiler._is_profiler_enabled:
        return _profiler.record_function(name)
    return _NO_RANGE


class _Span:
    __slots__ = ("name", "n", "ranged", "t0", "range")

    def __init__(self, name: str, n: int, ranged: bool):
        self.name, self.n, self.ranged = name, n, ranged

    def __enter__(self):
        self.range = None
        if self.ranged and _profiler._is_profiler_enabled:
            self.range = _profiler.record_function(self.name)
            self.range.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        if self.range is not None:
            self.range.__exit__(*exc)
        m = _sink
        if m is not None:
            m.clocks[self.name] += dt
            m.counters[self.name] += self.n


def span(name: str, n: int = 1, timeline: bool = True) -> _Span:
    """``with span(name, n):`` adds the block's seconds to the sink's
    ``clocks[name]`` and ``n`` (the items the block handled) to its
    ``counters[name]``; with ``timeline``, a range of ``name`` while a
    profiler records."""
    return _Span(name, n, timeline)


def count(name: str, n: int) -> None:
    """Add ``n`` to the sink's ``counters[name]``."""
    if _sink is not None:
        _sink.counters[name] += int(n)


def records_spans(method):
    """Decorate ``Mapper.map_reads``: an outermost call makes its Mapper's
    ``metrics`` the sink, and it stays the sink after the call (for the
    output that follows) until another outermost call starts.  The calls
    nested in it (the retry, deep-pass and rescue Mappers) leave it."""
    @functools.wraps(method)
    def wrapper(self, *args, **kwargs):
        global _sink, _depth
        if _depth == 0:
            _sink = self.metrics
        _depth += 1
        try:
            return method(self, *args, **kwargs)
        finally:
            _depth -= 1
    return wrapper

"""What the benchmark reads from a torch.profiler trace of its window.

Each call of the window runs ``Mapper.map_reads`` inside a
``record_function`` span of the benchmark's own (``CALL_SPAN``) and the
CLI's first output pass (mapQVs, selection) inside another
(``EMIT_SPAN``), and the whole profiled stretch inside ``WINDOW_SPAN``;
nothing inside the program is spanned yet.  From the trace's events this
module takes:

* the device's busy time: the union of the intervals in which a kernel,
  a copy or a memset ran, clipped to the window;
* the device operations by their summed time, by the profiler's names;
* the idle gaps of the device inside the window, each named by the
  benchmark span and the innermost host operator running at its middle;
* the CUDA runtime calls the host made (kernel and graph launches,
  copies, memsets).
"""

from __future__ import annotations

from bisect import bisect_right
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

WINDOW_SPAN = "bench.window"
CALL_SPAN = "bench.map_reads"
EMIT_SPAN = "bench.emit_pass"
SPANS = (CALL_SPAN, EMIT_SPAN)

# device activities that are work on the card (user annotations mirrored
# onto the device timeline are not)
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
# runtime calls that launch work or move bytes
RUNTIME_CALLS = frozenset((
    "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
    "cuLaunchKernelEx", "cudaGraphLaunch", "cuGraphLaunch",
    "cudaMemcpyAsync", "cudaMemcpy", "cudaMemsetAsync", "cudaMemset",
    "cudaMemcpy2DAsync"))
NAME_CHARS = 120    # device-op names are cut to this length


@dataclass
class Event:
    name: str
    kind: str       # the profiler's activity type
    device: bool    # on the card's timeline
    start: int      # ns
    end: int


@dataclass
class TraceSummary:
    window_s: float = 0.0
    busy_s: float = 0.0
    runtime_calls: int = 0
    device_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)


def _ns(ev, what: str) -> int:
    fn = getattr(ev, f"{what}_ns", None)
    if fn is not None:
        return int(fn())
    return int(getattr(ev, f"{what}_us")() * 1000)


def _kind(ev, device: bool) -> str:
    """The event's activity type, as the profiler names it where it says
    (``activity_type``), else from what the event is."""
    fn = getattr(ev, "activity_type", None)
    if fn is not None:
        kind = fn()
        return kind if isinstance(kind, str) else str(kind)
    name = ev.name()
    annotation = getattr(ev, "is_user_annotation", None)
    if annotation is not None and annotation():
        return "gpu_user_annotation" if device else "user_annotation"
    if name == WINDOW_SPAN or name in SPANS:
        return "gpu_user_annotation" if device else "user_annotation"
    if device:
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        if name.startswith("Memset"):
            return "gpu_memset"
        return "kernel"
    if name.startswith("cuda") or (name.startswith("cu")
                                   and name[2:3].isupper()):
        return "cuda_runtime"
    return "cpu_op"


def events_of(prof) -> List[Event]:
    """The profiler's raw (kineto) events as :class:`Event`."""
    out = []
    for ev in prof.profiler.kineto_results.events():
        start = _ns(ev, "start")
        device = "CUDA" in str(ev.device_type())
        out.append(Event(ev.name(), _kind(ev, device), device, start,
                         start + _ns(ev, "duration")))
    return out


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1] = (merged[-1][0], e)
        else:
            merged.append((s, e))
    return merged


def device_busy_s(events: List[Event]) -> float:
    """The seconds in which a kernel, a copy or a memset ran on the card:
    the union of every device interval of the trace (a trace that covers
    only the window, as the untraced run's does)."""
    busy = _union([(e.start, e.end) for e in events
                   if e.device and e.kind in DEVICE_KINDS])
    return sum(e - s for s, e in busy) / 1e9


def summarize(events: List[Event], top: int = 10) -> Optional[TraceSummary]:
    """The window's busy time, device operations, idle gaps and runtime
    calls, or None if the trace holds no window span."""
    win = [e for e in events if e.name == WINDOW_SPAN and not e.device]
    if not win:
        return None
    w0, w1 = win[0].start, win[0].end
    dev = [e for e in events if e.device and e.kind in DEVICE_KINDS
           and e.end > w0 and e.start < w1]
    busy = _union([(max(e.start, w0), min(e.end, w1)) for e in dev])
    by_name: Dict[str, int] = {}
    for e in dev:
        by_name[e.name[:NAME_CHARS]] = (by_name.get(e.name[:NAME_CHARS], 0)
                                        + e.end - e.start)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]

    host = [e for e in events if not e.device and w0 <= e.start < w1]
    calls = sum(1 for e in host if e.name in RUNTIME_CALLS)
    # innermost host op at a time: the latest-starting op that covers it
    cpu_ops = sorted((e for e in host if e.kind == "cpu_op"),
                     key=lambda e: e.start)
    spans = [e for e in host if e.name in SPANS]
    starts = [e.start for e in cpu_ops]

    def label(t: int) -> str:
        where = next((s.name for s in spans if s.start <= t < s.end),
                     "between_calls")
        i = bisect_right(starts, t) - 1
        inner = "host_code"
        # look back over a bounded number of ops for one still running
        for j in range(i, max(i - 64, -1), -1):
            if cpu_ops[j].end > t:
                inner = cpu_ops[j].name
                break
        return f"{where}/{inner}"

    gaps = []
    prev = w0
    for s, e in busy + [(w1, w1)]:
        if s > prev:
            gaps.append((s - prev, prev))
        prev = max(prev, e)
    gaps.sort(key=lambda g: -g[0])
    idle = [(label(t0 + dur // 2), dur / 1e9) for dur, t0 in gaps[:top]]
    return TraceSummary(
        window_s=(w1 - w0) / 1e9,
        busy_s=sum(e - s for s, e in busy) / 1e9,
        runtime_calls=calls,
        device_ops=[(n, ns / 1e9) for n, ns in ops],
        idle_gaps=idle)

"""Where the card waits, by the program's own spans: one benchmark cell's
inputs through the port on the card, as ``benchmark/run.py`` maps and
writes them (``Mapper.map_reads``, then the CLI's ``emit`` into a stream
that keeps nothing), call after call, under torch.profiler.

    python3 tools/torch_span_trace.py --workload ecoli_k12.clr_fasta \
        --seed 4100000001 [--calls 3] [--out spans.json]

After one warm call it prints (and writes to ``--out`` as JSON) the
device's idle seconds over ``--calls`` calls, each idle stretch named by
the innermost program range running on the host at that time (a
``record_function`` range: ``pipeline/metrics.py``'s spans and clocks,
and this tool's ``tool.map_reads`` / ``tool.emit``), or ``unnamed``.
It needs the card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from bisect import bisect_right

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

import torch  # noqa: E402

WINDOW = "tool.window"


class Discard:
    def write(self, text: str) -> int:
        return len(text)


def idle_by_span(events, w0, w1):
    """Seconds of [w0, w1) with no kernel, copy or memset on the card, by
    the innermost host range covering them (the one that started last),
    or "unnamed"; with the idle and busy seconds."""
    from benchmark.devtrace import DEVICE_KINDS, _union
    busy = _union([(max(e.start, w0), min(e.end, w1)) for e in events
                   if e.device and e.kind in DEVICE_KINDS
                   and e.end > w0 and e.start < w1])
    gaps, prev = [], w0
    for s, e in busy + [(w1, w1)]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    spans = sorted((e.start, e.end, e.name) for e in events
                   if not e.device and e.kind == "user_annotation"
                   and e.name != WINDOW and e.end > w0 and e.start < w1)
    starts = [s for s, _, _ in spans]
    out = {}
    for g0, g1 in gaps:
        cuts = sorted({g0, g1} | {t for s, e, _ in spans
                                  for t in (s, e) if g0 < t < g1})
        for a, b in zip(cuts, cuts[1:]):
            mid = (a + b) / 2
            name = "unnamed"
            for j in range(bisect_right(starts, mid) - 1, -1, -1):
                s, e, n = spans[j]
                if e > mid:
                    name = n
                    break
            out[name] = out.get(name, 0.0) + (b - a) / 1e9
    return out, sum(b - a for a, b in gaps) / 1e9, \
        sum(e - s for s, e in busy) / 1e9


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--calls", type=int, default=3)
    ap.add_argument("--out", default="")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile, record_function

    from benchmark import devtrace, inputs, registry
    from blasr_tpu_torch.cli.blasr import emit
    from blasr_tpu_torch.index.genome import build_genome_index
    from blasr_tpu_torch.io.fasta import FastaRecord
    from blasr_tpu_torch.params import MappingParams
    from blasr_tpu_torch.pipeline.map_read import Mapper
    from blasr_tpu_torch.pipeline.metrics import MappingMetrics

    cell = registry.workload(registry.load_benchmark(), a.workload)
    inp = inputs.make(registry.config(cell["config"]),
                      registry.traffic(cell["traffic"]), a.seed)
    recs = [FastaRecord(r.name, r.seq) for r in inp.pool]
    params = MappingParams(**inp.mapper).make_sane()
    gi = build_genome_index([FastaRecord(c.title, c.seq)
                             for c in inp.contigs],
                            k=min(params.min_match_length, 16))
    mapper = Mapper(gi, params, metrics=MappingMetrics(), device="cuda")

    def call():
        with record_function("tool.map_reads"):
            per_read = mapper.map_reads(recs)
        with record_function("tool.emit"):
            emit(Discard(), None, recs, per_read, gi, params)

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            for _ in range(a.calls):
                call()
            torch.cuda.synchronize()
    ev = devtrace.events_of(prof)
    w0, w1 = next((e.start, e.end) for e in ev
                  if e.name == WINDOW and not e.device)
    by, idle_s, busy_s = idle_by_span(ev, w0, w1)
    out = dict(workload=a.workload, seed=a.seed,
               card=torch.cuda.get_device_name(), calls=a.calls,
               window_s=(w1 - w0) / 1e9, idle_s=idle_s, busy_s=busy_s,
               idle_by_span=dict(sorted(by.items(), key=lambda kv: -kv[1])))
    print(json.dumps(out, indent=1))
    if a.out:
        os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
        with open(a.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

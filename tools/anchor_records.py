"""K5 with and without the 24-byte records, on one benchmark cell's index
and pool, on the card.

    python3 tools/anchor_records.py --workload athaliana_tair10.clr_fasta \
        --seed 4123000001 [--rounds 2] [--out records.json]

Builds the cell's genome index as ``benchmark/run.py`` does and uploads
it with ``DeviceIndex.from_host`` (its set-up spans, ``INDEX_SPANS``, and
the peak of allocated device memory across it against what stays
resident), then maps the pool with two Mappers that share that index:
one with its records (K5 reads one 24-byte row a slot), one with
``pos_records`` left out (K5's separate gathers of the position, the
previous base and the packed words).  After a warm call each, the calls
alternate R W W R per round under the program's ``StageTimer``; it prints
each call's ``anchors`` stage (the reads' reverse complements, K5 and
the batch's seed counts) in ms a Mbase, then one call of each under
torch.profiler for K5's two kernels alone, and whether both Mappers gave
the same alignments.  It needs the card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

import torch  # noqa: E402

K5_KERNELS = ("anchor_candidates", "anchor_select")


def canon(per_read):
    return [[(a.tindex, a.strand, a.qstart, a.qend, a.tstart, a.tend,
              a.score, a.n_match, a.n_mismatch, a.n_ins, a.n_del)
             for a in alns] for alns in per_read]


def k5_device_ms(mapper, recs) -> float:
    """K5's kernels' device milliseconds over one call, by
    torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    from benchmark.devtrace import events_of
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        mapper.map_reads(recs)
        torch.cuda.synchronize()
    return sum(e.end - e.start for e in events_of(prof)
               if e.device and any(k in e.name for k in K5_KERNELS)) / 1e6


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    from benchmark import inputs, registry
    from blasr_tpu_torch.index.genome import build_genome_index
    from blasr_tpu_torch.io.fasta import FastaRecord
    from blasr_tpu_torch.params import MappingParams
    from blasr_tpu_torch.pipeline import map_read
    from blasr_tpu_torch.pipeline.map_read import (DeviceIndex, Mapper,
                                                   StageTimer)
    dev = torch.device("cuda")
    torch.zeros(1, device=dev)
    cell = registry.workload(registry.load_benchmark(), a.workload)
    inp = inputs.make(registry.config(cell["config"]),
                      registry.traffic(cell["traffic"]), a.seed)
    recs = [FastaRecord(r.name, r.seq) for r in inp.pool]
    params = MappingParams(**inp.mapper).make_sane()
    t0 = time.time()
    gi = build_genome_index([FastaRecord(c.title, c.seq)
                             for c in inp.contigs],
                            k=min(params.min_match_length, 16))
    host_s = time.time() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    ix = DeviceIndex.from_host(gi, dev)
    torch.cuda.synchronize()
    out = dict(workload=a.workload, seed=a.seed,
               card=torch.cuda.get_device_name(dev),
               slots=int(gi.pos_sorted.shape[0]), host_index_s=host_s,
               index_spans=dict(map_read.INDEX_SPANS),
               records=ix.pos_records is not None,
               resident_bytes=torch.cuda.memory_allocated() - before,
               from_host_peak_bytes=torch.cuda.max_memory_allocated()
               - before)
    print(json.dumps(out), flush=True)
    if ix.pos_records is None:
        print("the index holds no records", file=sys.stderr)
        return 1
    mappers = {"records": Mapper(gi, params, dev=ix),
               "words": Mapper(gi, params,
                               dev=ix._replace(pos_records=None))}
    answers = {k: canon(m.map_reads(recs)) for k, m in mappers.items()}
    out["same_alignments"] = answers["records"] == answers["words"]
    mbase = inp.pool_bases / 1e6
    runs = {k: [] for k in mappers}
    for _ in range(a.rounds):
        for k in ("records", "words", "words", "records"):
            with StageTimer() as st:
                mappers[k].map_reads(recs)
            ms = st.totals()
            runs[k].append(dict(anchors=ms["anchors"] / mbase,
                                device=sum(ms[s] for s in StageTimer.STAGES)
                                / mbase))
            print(f"# {k}: anchors {runs[k][-1]['anchors']:.4f}, all "
                  f"stages {runs[k][-1]['device']:.4f} ms a Mbase",
                  file=sys.stderr, flush=True)
    out["stage_ms_per_mbase"] = runs
    out["k5_kernels_ms_per_mbase"] = {
        k: k5_device_ms(m, recs) / mbase for k, m in mappers.items()}
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    print(json.dumps(out), flush=True)
    if a.out:
        with open(a.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0 if out["same_alignments"] else 1


if __name__ == "__main__":
    sys.exit(main())

"""The benchmark of blasr_tpu_torch: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

A cell (an entry of ``workloads`` in ``BENCHMARK.json``) pairs a
configuration (``configs/<name>.json``: the genome) with a traffic mix
(``traffic/<name>.json``: the pool of reads and the mapper's options).
The run, in one process on the card:

1. set-up: makes the genome and the pool from ``--seed``, builds the
   genome index as the CLI does (k = min(minMatch, 16)), constructs one
   ``Mapper`` with the CLI's defaults and the mix's options, and makes
   one warm call over the pool, which builds or loads the kernels and
   captures the CUDA graphs of the buckets the pool uses;
2. the window: one client, call after call, maps the pool with
   ``Mapper.map_reads`` and writes it with the CLI's own
   ``cli/blasr.py::emit`` (mapQVs, the hit policy, the default m1 lines)
   into a stream that throws it away, for ``--seconds`` seconds; a call
   started in the window runs to its end;
3. checks one call of the window, drawn from the seed, against the plain
   reference (``check.py``), once the program's state is freed;
4. prints one JSON line: the cell's end-to-end metrics (the window runs
   under a torch.profiler trace of the device alone, for the card's busy
   time), or with ``--trace 1`` its per-layer metrics (the window's
   first half under torch.profiler, the second under the program's
   ``StageTimer``).

The process keeps to four CPUs, and the garbage collector leaves the
set-up's objects alone in the window (``gc.freeze``): both narrow the
spread of the host's work from run to run.

It exits 2, printing no result, where CUDA is missing or the card has
fewer devices than the cell asks for, and 3 where ``jax``, ``jaxlib``,
``flax`` or ``blasr_tpu`` is loaded once the window has closed.
"""

from __future__ import annotations

import os
import sys
import time

import argparse
import contextlib
import gc
import json
import subprocess
from pathlib import Path
from typing import Dict, List, Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
_REPO = os.path.dirname(_HERE)

# modules that may not be loaded in the process that prints the result
FORBIDDEN = ("jax", "jaxlib", "flax", "blasr_tpu")
# the checked call is drawn from this many first calls of the window
CHECK_FROM = 8
# the run keeps to this many CPUs (the last it may use): on an H100
# machine's eight cores, five runs spread by 7% pinned to four against
# 17% unpinned
PIN_CPUS = 4


def process_start() -> float:
    """The wall-clock time this process started (from /proc), or now
    where /proc cannot tell."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - start_ticks
                              / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


_STARTED = process_start()


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "not read"


def gc_clock():
    """A garbage-collector callback that sums the collections' pauses
    (``.seconds``, ``.count``), installed until it is removed."""
    def cb(phase, info):
        if phase == "start":
            cb.t0 = time.perf_counter()
        else:
            cb.seconds += time.perf_counter() - cb.t0
            cb.count += 1
    cb.seconds, cb.count, cb.t0 = 0.0, 0, 0.0
    gc.callbacks.append(cb)
    return cb


class Discard:
    """The stream the CLI writes its alignments to, which keeps nothing."""

    def write(self, text: str) -> int:
        return len(text)


def log(msg: str) -> None:
    print(f"# {msg}", file=sys.stderr, flush=True)


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             bench: Optional[dict] = None, root: Optional[Path] = None,
             device: Optional[str] = None, out=None) -> int:
    """One run of cell ``name``; returns the exit code.  ``device`` None
    is the card (with the look for it); a test passes "cpu" to drive the
    rest of a run on the port's plain CPU path, and its own ``bench`` and
    ``root`` for a cell of its own."""
    import numpy as np
    import torch

    from benchmark import check, devtrace, inputs, registry
    from benchmark.roofline import banded_dp

    out = out or sys.stdout
    root = root or registry.ROOT
    bench = bench or registry.load_benchmark()
    cell = registry.workload(bench, name)
    if device is None:
        if not torch.cuda.is_available():
            print("torch.cuda.is_available() is false", file=sys.stderr)
            return 2
        if torch.cuda.device_count() < cell["chips"]:
            print(f"{torch.cuda.device_count()} CUDA devices, the cell "
                  f"needs {cell['chips']}", file=sys.stderr)
            return 2
        device = "cuda"
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    phases: Dict[str, float] = {}

    def mark(phase: str, t0: float) -> float:
        now = time.time()
        phases[phase] = now - t0
        return now

    t = time.time()
    from blasr_tpu_torch.cli.blasr import emit as cli_emit
    from blasr_tpu_torch.index.genome import build_genome_index
    from blasr_tpu_torch.io.fasta import FastaRecord
    from blasr_tpu_torch.params import MappingParams
    from blasr_tpu_torch.pipeline import graphs
    from blasr_tpu_torch.pipeline import select as psel
    from blasr_tpu_torch.pipeline.map_read import Mapper, StageTimer
    from blasr_tpu_torch.pipeline.metrics import MappingMetrics
    from blasr_tpu_torch.pipeline.zmw import zmw_key
    phases["imports"] = t - _STARTED
    t = mark("program_imports", t)
    if cuda:
        torch.cuda.init()
        torch.zeros(1, device=dev)
        torch.cuda.synchronize(dev)
    t = mark("cuda_context", t)
    cfg = registry.config(cell["config"], root)
    mix = registry.traffic(cell["traffic"], root)
    inp = inputs.make(cfg, mix, seed)
    recs = [FastaRecord(r.name, r.seq) for r in inp.pool]
    t = mark("inputs", t)
    params = MappingParams(**inp.mapper).make_sane()
    gi = build_genome_index([FastaRecord(c.title, c.seq)
                             for c in inp.contigs],
                            k=min(params.min_match_length, 16))
    mapper = Mapper(gi, params, metrics=MappingMetrics(), device=dev)
    if cuda:
        torch.cuda.synchronize(dev)
    t = mark("index", t)
    sink = Discard()

    def call(span=lambda name: contextlib.nullcontext()):
        """map_reads over the pool, then the CLI's emit of its answers;
        returns the answers and the seconds of each of the two."""
        t0 = time.perf_counter()
        with span(devtrace.CALL_SPAN):
            per_read = mapper.map_reads(recs)
        t1 = time.perf_counter()
        with span(devtrace.EMIT_SPAN):
            cli_emit(sink, None, recs, per_read, gi, params)
        return per_read, t1 - t0, time.perf_counter() - t1

    graphs.reset_counts()
    call()
    if cuda:
        torch.cuda.synchronize(dev)
    captures = list(graphs.CAPTURES)
    t = mark("warm_call", t)

    # the call that is checked: one of the first CHECK_FROM calls (the
    # last one where the window holds fewer), drawn from the seed; the
    # window keeps no other call's answers, so it holds the memory of one
    pick = int(np.random.default_rng(inputs.sub_seeds(seed, 4)[3])
               .integers(CHECK_FROM))
    kept: list = []     # [the answers of the latest call up to pick]
    per_call: List[tuple] = []  # each call's map, emit, collector, CPU s

    def window(span_s: float, profiled: bool = False):
        from torch.profiler import record_function
        ends, emit_s = [], 0.0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < span_s:
            gc0, cpu0 = gc_pauses.seconds, time.process_time()
            per_read, map_s, e_s = (call(record_function) if profiled
                                    else call())
            ends.append(time.perf_counter())
            emit_s += e_s
            per_call.append((map_s, e_s, gc_pauses.seconds - gc0,
                             time.process_time() - cpu0))
            if len(per_call) <= pick + 1:
                kept[:] = [per_read]
            del per_read
        return t0, ends, emit_s

    mode = ("qv" if mapper.use_qv else
            "hp" if params.affine_align else "distance")
    ctx: dict = dict(
        device_name=torch.cuda.get_device_name(dev) if cuda else "cpu",
        mode=mode, band_width=mapper.cfg.band_width, setup=phases,
        captures=captures, pool_bases=inp.pool_bases)
    ctx["peaks"] = banded_dp.peaks(ctx["device_name"])
    # set-up's objects (genome, index, pool, graphs) out of the
    # collector's reach: its full passes then walk only what calls make
    gc.collect()
    gc.freeze()
    gc_pauses = gc_clock()
    setup_s = time.time() - _STARTED
    if not trace:
        # the card's busy time over the whole window, from a trace of
        # the device alone (no host operators are recorded)
        from torch.profiler import ProfilerActivity, profile
        with (profile(activities=[ProfilerActivity.CUDA]) if cuda
              else contextlib.nullcontext()) as prof:
            t0, ends, _ = window(seconds)
            if cuda:
                torch.cuda.synchronize(dev)
        n_calls = len(ends)
        gbases = n_calls * inp.pool_bases / 1e9
        busy_s = devtrace.device_busy_s(devtrace.events_of(prof)) \
            if cuda else 0.0
        del prof
        # the card's seconds a Gbase of reads costs (none on the CPU)
        e2e = {"device_s_per_gbase": busy_s / gbases if busy_s else None,
               "setup_s": setup_s}
        log(f"window {ends[-1] - t0:.3f} s, {n_calls} calls: device busy "
            f"{busy_s:.4f} s; read bases/s "
            f"{bases_per_s(t0, ends, inp.pool_bases)}")
    else:
        from torch.profiler import ProfilerActivity, profile, \
            record_function
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if cuda else [])
        mapper.metrics = MappingMetrics()
        graphs.reset_counts()
        with profile(activities=acts) as prof:
            with record_function(devtrace.WINDOW_SPAN):
                t1, ends1, _ = window(seconds / 2, profiled=True)
                if cuda:
                    torch.cuda.synchronize(dev)
        ctx["profiled"] = dict(dispatches=dict(graphs.DISPATCHES),
                               calls=len(ends1),
                               bases_per_s=bases_per_s(t1, ends1,
                                                       inp.pool_bases))
        mapper.metrics = MappingMetrics()
        graphs.reset_counts()
        with StageTimer() as st:
            _, ends, emit_s = window(seconds - seconds / 2)
        ctx["staged"] = dict(
            stages_ms=st.totals() if cuda else {},
            clocks=dict(mapper.metrics.clocks),
            counters=dict(mapper.metrics.counters),
            dispatches=dict(graphs.DISPATCHES), calls=len(ends),
            bases=len(ends) * inp.pool_bases, emit_s=emit_s)
        n_calls = len(ends1) + len(ends)
        ctx["trace"] = devtrace.summarize(devtrace.events_of(prof))
        del prof
    mem_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0

    # the checked call's answers (emit stored their mapQVs; the hit
    # policy's choice is taken again from them); the program's state is
    # freed
    per_read = kept.pop()
    program = check.finish_reads(per_read, recs, params, gi, psel,
                                 zmw_key, store=False)
    unaligned = sum(1 for alns in per_read if not alns)
    placed = check.placed_share(inp.pool, per_read)
    del per_read, mapper, call
    gc.collect()
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
    loaded = forbidden_modules()
    if loaded:
        print(f"loaded after the window: {', '.join(loaded)}",
              file=sys.stderr)
        return 3

    for k, v in phases.items():
        log(f"setup phase {k}: {v:.3f} s")
    log(f"setup_s {setup_s:.3f}; card: {power_limit() if cuda else 'cpu'}"
        f"; torch threads {torch.get_num_threads()}, CPUs "
        f"{sorted(os.sched_getaffinity(0))}")
    gc.callbacks.remove(gc_pauses)
    if per_call:
        cols = np.array(per_call)
        for j, what in enumerate(("map_reads", "emit", "collector",
                                  "process CPU")):
            q = np.percentile(cols[:, j], [0, 25, 50, 75, 100])
            log(f"per call {what} s: min {q[0]:.3f} q1 {q[1]:.3f} median "
                f"{q[2]:.3f} q3 {q[3]:.3f} max {q[4]:.3f}")
    log(f"garbage collector {gc_pauses.seconds:.3f} s in "
        f"{gc_pauses.count} collections")
    log(f"checked call {min(pick, n_calls - 1)}; "
        f"calls in the window: {n_calls} of {len(inp.pool)} reads, "
        f"{inp.pool_bases} bases; unaligned reads of that call: "
        f"{unaligned}; "
        f"placed on their simulated interval: {placed:.4f}")
    t_ref = time.time()
    ref = check.run_reference(inp, seed, dev)
    numbers = check.compare(program, ref)
    correct, checks = check.verdict(numbers)
    log(f"reference: {len(ref.batches)} batches {sorted(ref.batches)}, "
        f"{numbers['reads_compared']} reads compared, "
        f"{numbers['deep_reads']} sent to the rescue "
        f"({numbers['deep_replaced']} replaced), "
        f"{time.time() - t_ref:.1f} s")

    if not trace:
        metrics = end_to_end_values(registry.end_to_end(bench, name), e2e)
    else:
        metrics = {}
        for m in registry.per_layer(bench, name):
            value = registry.metric_reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": ctx["device_name"], "count": cell["chips"],
                   "memory_peak_bytes": int(mem_peak)}
    result = {"correct": correct,
              "attempted": n_calls * len(inp.pool),
              "failed": n_calls * unaligned,
              "metrics": metrics, "device": device_info}
    if trace:
        tr = ctx.get("trace")
        device_info["busy_s"] = tr.busy_s if tr else 0.0
        device_info["window_s"] = tr.window_s if tr else 0.0
        if tr:
            result["breakdown"] = {
                "device_ops": [list(x) for x in tr.device_ops],
                "idle_gaps": [list(x) for x in tr.idle_gaps]}
        st = ctx["staged"]
        log(f"StageTimer half: {st['calls']} calls, stages (ms) "
            f"{json.dumps(st['stages_ms'])}, MappingMetrics clocks (s) "
            f"{json.dumps(st['clocks'])}, output pass {st['emit_s']:.3f} "
            f"s, counters "
            f"{json.dumps(st['counters'])}, dispatches "
            f"{json.dumps(st['dispatches'])}")
    for k, v in metrics.items():
        log(f"{k} = {v['value']} {v['unit']}")
    for k, c in checks.items():
        print(f"{k} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    result["checks"] = checks
    if forbidden_modules():
        print(f"loaded: {', '.join(forbidden_modules())}", file=sys.stderr)
        return 3
    print(json.dumps(result), file=out, flush=True)
    return 0


def end_to_end_values(entries: List[dict], values: Dict[str, float]
                      ) -> Dict[str, dict]:
    """The cell's end-to-end metrics from the run's readings: a qualified
    name (``device_s_per_gbase.repeats``) is its base's quantity under a
    bound of its own; a metric with no reading (the card's busy time on
    the CPU) is left out."""
    out = {}
    for m in entries:
        value = values.get(m["name"], values.get(m["name"].split(".")[0]))
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def pin_cpus(n: int = PIN_CPUS) -> None:
    """Keep this process, and the threads it starts later, on the last
    ``n`` CPUs it may use, where it may use more."""
    try:
        cpus = sorted(os.sched_getaffinity(0))
        if len(cpus) > n:
            os.sched_setaffinity(0, cpus[-n:])
    except (AttributeError, OSError):
        pass


def set_cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the program's own kernels build into build/blasr_tpu_torch/)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = os.path.join(_REPO, "build", "benchmark", sub)


def bases_per_s(t0: float, ends: List[float], bases_per_call: int) -> float:
    """The read bases of every call completed in the window over the time
    from the window's start to the end of the last completed call."""
    return len(ends) * bases_per_call / (ends[-1] - t0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    return run_cell(a.workload, a.seed, a.seconds, bool(a.trace))


if __name__ == "__main__":
    # the benchmark imports as the package ``benchmark`` (never its files
    # as top-level modules), the program from the checkout
    if os.path.abspath(sys.path[0] or ".") == _HERE:
        sys.path[0] = _REPO
    else:
        sys.path.insert(0, _REPO)
    pin_cpus()
    set_cache_dirs()
    sys.exit(main())

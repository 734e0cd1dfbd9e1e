#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (blasr_tpu_torch) on one GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases (any failed check exits nonzero):
  1. header: torch / CUDA / nvcc versions, the card's name and power limit;
     build the hand-written kernels K1 (banded DP) and K2 (traceback walk)
     from ``blasr_tpu_torch/csrc``;
  2. each kernel against its plain PyTorch version at the main path's
     shapes (N=640 items, L=2048 rows, W=3072 window), exact equality,
     timed with CUDA events;
  3. the golden worlds of tests/test_golden.py (small: 60 kb, 12 reads;
     big: 4.6 Mbp, 11 reads) through the port's CLI with ``--device cuda``,
     byte for byte against tests/golden/golden.{m4,sam,m4.big,sam.big};
  4. the bench.py workload (4.6 Mbp genome, k=12, 512 CLR reads of
     0.5-2 kb at 85% accuracy): reads/s, per-stage device times, and the
     share of reads placed on their simulated interval (>= 95%).
The second-to-last lines are a JSON kernel table and the card's name and
power limit; the last line is ``{"ok": true, "device": {...}}``.
Exits nonzero without a result when no CUDA device is present or when
the blasr_tpu_torch package is not beside this file.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

sys.modules["jax"] = None  # the port must not need JAX: fail loudly if it does

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "tests", "golden")
DP_SRC = "blasr_tpu_torch/csrc/banded_dp.cu"
TB_SRC = "blasr_tpu_torch/csrc/banded_traceback.cu"


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- phase 2

def random_case(rng, N, L, W, w_b=128, steep_every=8):
    """Banded-DP inputs as tests/test_pallas_banded.py::_random_case makes
    them (numpy only): each read's span planted into its window on a noisy
    diagonal, offsets slope-limited to {0,1,2}.  Every ``steep_every``-th
    item instead spans twice as many window columns as rows, on a slope-2
    band: its global alignment needs a deletion per row, about two pairs
    per row, so its traceback overflows t_max = 3T/8 (and fits T)."""
    reads = rng.integers(0, 4, (N, L)).astype(np.int8)
    windows = rng.integers(0, 4, (N, W)).astype(np.int8)
    qa = rng.integers(0, 8, N).astype(np.int32)
    qb = (qa + rng.integers(L // 2, L - 8, N)).astype(np.int32)
    ta = rng.integers(1, 40, N).astype(np.int32)
    offs = np.zeros((N, L), np.int64)
    tb = np.zeros(N, np.int32)
    for i in range(N):
        steep = i % steep_every == 0
        if steep:
            qb[i] = qa[i] + min(L - 8, (W - int(ta[i]) - 2 * w_b) // 2)
            span = int(qb[i] - qa[i])
            windows[i, ta[i]:ta[i] + 2 * span:2] = reads[i, qa[i]:qb[i]]
            tb[i] = ta[i] + 2 * span
            slope = 2
        else:
            t = int(ta[i])
            u = rng.random(L)
            v = rng.random(L)
            for r in range(int(qa[i]), int(qb[i])):
                if u[r] < 0.08:
                    pass                           # insertion
                elif u[r] < 0.16 and t + 2 < W:
                    windows[i, t] = rng.integers(0, 4)
                    t += 2                         # deletion
                else:
                    if v[r] < 0.9:
                        windows[i, t] = reads[i, r]
                    t += 1
                t = min(t, W - 1)
            tb[i] = min(t + 1, W)
            slope = 1
        center = np.minimum(
            ta[i] + slope * np.maximum(np.arange(L) - int(qa[i]), 0), W - 1)
        offs[i] = np.clip(center - w_b // 2, 0, W - w_b)
    r = np.arange(L)
    offs = np.maximum.accumulate(offs, axis=1)
    offs = 2 * r + np.minimum.accumulate(offs - 2 * r, axis=1)
    return reads, windows, offs.astype(np.int32), qa, qb, ta, tb


def cuda_ms(fn, reps: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs(a_list, b_list) -> float:
    m = 0.0
    for a, b in zip(a_list, b_list):
        d = (a.double() - b.double()).abs()
        if d.numel():
            m = max(m, float(d.max()))
    return m


def phase_kernels(card):
    from blasr_tpu.params import MappingParams, ShapeConfig
    from blasr_tpu_torch.kernels import cuda_ops
    from blasr_tpu_torch.kernels.banded import (banded_align,
                                                banded_traceback,
                                                banded_traceback_plain)
    from blasr_tpu_torch.kernels.pallas_banded import banded_align_cuda

    N, L = 640, 2048
    W = ShapeConfig().window_len(L)
    T = L + W
    assert W == 3072, W
    rng = np.random.default_rng(7)
    t0 = time.time()
    arrs = random_case(rng, N, L, W)
    log(f"# phase 2: case N={N} L={L} W={W} built in {time.time()-t0:.1f}s")
    dev = torch.device("cuda")
    reads, windows, offs, qa, qb, ta, tb = (
        torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrs)
    sm = np.asarray(MappingParams().make_sane().score_matrix,
                    np.float32).reshape(25)
    gaps = (4.0, 4.0, 5.0, 5.0)
    args = (reads, windows, offs, qa, qb, ta, tb, sm, *gaps)

    out = banded_align_cuda(*args)
    torch.cuda.synchronize()
    ref = banded_align(*args)          # plain version, same inputs
    torch.cuda.synchronize()
    for name in ("score", "valid", "final_state"):
        a, b = getattr(out, name), getattr(ref, name)
        assert torch.equal(a, b), f"K1 {name} differs from the plain DP"
    bad_rows = int((out.tbbits != ref.tbbits).any(dim=2).sum())
    assert bad_rows == 0, f"K1 tbbits differ in {bad_rows} rows"
    dp_err = max_abs([out.score[out.valid], out.final_state, out.tbbits],
                     [ref.score[ref.valid], ref.final_state, ref.tbbits])
    log(f"# K1 == plain: score/valid/final_state/tbbits exact "
        f"({int(out.valid.sum())}/{N} valid)")

    dp_ms = cuda_ms(lambda: banded_align_cuda(*args), 5)
    dp_plain_ms = cuda_ms(lambda: banded_align(*args), 1)
    log(f"# K1 banded_dp: kernel {dp_ms:.3f} ms, plain {dp_plain_ms:.1f} ms "
        f"per call (N={N}, L={L}) on {card}")

    tb_err = 0.0
    tb_times = {}
    n_ovf = {}
    for t_max in ((3 * T) // 8, T):
        k2 = banded_traceback(out, offs, qa, qb, ta, tb, t_max=t_max)
        torch.cuda.synchronize()
        pl = banded_traceback_plain(out, offs, qa, qb, ta, tb, t_max=t_max)
        torch.cuda.synchronize()
        for name in k2._fields:
            assert torch.equal(getattr(k2, name), getattr(pl, name)), \
                f"K2 {name} differs from the plain walk at t_max={t_max}"
        tb_err = max(tb_err, max_abs(list(k2), list(pl)))
        n_ovf[t_max] = int(k2.overflow.sum())
        kms = cuda_ms(lambda: banded_traceback(
            out, offs, qa, qb, ta, tb, t_max=t_max), 5)
        pms = cuda_ms(lambda: banded_traceback_plain(
            out, offs, qa, qb, ta, tb, t_max=t_max), 1)
        tb_times[t_max] = (kms, pms)
        log(f"# K2 == plain at t_max={t_max}: exact, {n_ovf[t_max]} rows "
            f"overflow; kernel {kms:.3f} ms, plain {pms:.1f} ms on {card}")
    assert n_ovf[(3 * T) // 8] > 0, "the overflow path of K2 was not exercised"
    kms, pms = tb_times[(3 * T) // 8]
    return {
        "banded_dp": dict(err=dp_err, ms=dp_ms, plain_ms=dp_plain_ms),
        "banded_traceback": dict(err=tb_err, ms=kms, plain_ms=pms),
    }, cuda_ops


# ---------------------------------------------------------------- phase 3

def make_small(d):
    """tests/test_golden.py::make_small (copied: that module's conftest
    imports JAX)."""
    from blasr_tpu.io.fasta import FastaRecord, write_fasta
    from blasr_tpu.sim import random_genome, simulate_reads
    contigs = random_genome(60_000, seed=777, n_contigs=2)
    sims = simulate_reads(contigs, 12, read_len=(250, 900), accuracy=0.87,
                          seed=778)
    recs = [FastaRecord(f"movie/{i}/0_{len(s.rec.seq)}", s.rec.seq)
            for i, s in enumerate(sims)]
    write_fasta(os.path.join(d, "genome.fa"), contigs)
    write_fasta(os.path.join(d, "reads.fa"), recs)
    return os.path.join(d, "reads.fa"), os.path.join(d, "genome.fa")


def make_big(d):
    """tests/test_golden.py::make_big (copied)."""
    from blasr_tpu.io.fasta import FastaRecord, write_fasta
    from blasr_tpu.sim import random_genome, simulate_reads
    contigs = random_genome(4_600_000, seed=4600)
    sims = simulate_reads(contigs, 10, read_len=(400, 2200), accuracy=0.85,
                          seed=4601)
    recs = [FastaRecord(f"movie/{i}/0_{len(s.rec.seq)}", s.rec.seq)
            for i, s in enumerate(sims)]
    g = contigs[0].seq
    recs.append(FastaRecord(f"movie/{len(recs)}/0_900", g[-900:].copy()))
    write_fasta(os.path.join(d, "genome_big.fa"), contigs)
    write_fasta(os.path.join(d, "reads_big.fa"), recs)
    return (os.path.join(d, "reads_big.fa"),
            os.path.join(d, "genome_big.fa"))


def phase_goldens(d, cuda_ops):
    from blasr_tpu_torch.cli.blasr import run
    worlds = {"small": make_small(d), "big": make_big(d)}
    cases = [("m4", "small", ["-m", "4"]),
             ("sam", "small", ["--sam", "--clipping", "soft"]),
             ("m4.big", "big", ["-m", "4"]),
             ("sam.big", "big", ["--sam", "--clipping", "soft"])]
    before = dict(cuda_ops.LAUNCHES)
    n_ok = 0
    for name, world, flags in cases:
        reads, genome = worlds[world]
        out = os.path.join(d, f"out.{name}")
        t0 = time.time()
        rc = run([reads, genome, "--out", out, "--device", "cuda"] + flags)
        assert rc == 0, f"CLI exit {rc} for {name}"
        text = open(out).read()
        if name.startswith("sam"):
            text = "\n".join(l for l in text.splitlines()
                             if not l.startswith("@PG")) + "\n"
        want = open(os.path.join(GOLDEN, f"golden.{name}")).read()
        same = text == want
        n_ok += same
        log(f"# golden.{name}: {'IDENTICAL' if same else 'DIFFERS'} "
            f"({time.time() - t0:.1f}s)")
        if not same:
            import difflib
            diff = list(difflib.unified_diff(want.splitlines(True),
                                             text.splitlines(True)))
            sys.stdout.write("".join(diff[:40]))
    grew = {k: cuda_ops.LAUNCHES[k] - before[k] for k in before}
    log(f"# goldens identical: {n_ok}/{len(cases)}; launches {grew}")
    assert n_ok == len(cases), "golden outputs differ"
    assert all(v > 0 for v in grew.values()), f"kernels not launched: {grew}"


# ---------------------------------------------------------------- phase 4

def phase_bench(card, cuda_ops):
    from blasr_tpu.index.genome import build_genome_index
    from blasr_tpu.params import MappingParams, ShapeConfig
    from blasr_tpu.sim import random_genome, simulate_reads
    from blasr_tpu_torch.pipeline.map_read import Mapper, StageTimer

    t0 = time.time()
    contigs = random_genome(4_600_000, seed=11)
    gi = build_genome_index(contigs, k=12)
    sims = simulate_reads(contigs, 512, read_len=(500, 1980),
                          accuracy=0.85, seed=12)
    recs = [s.rec for s in sims]
    cfg = ShapeConfig(buckets=(1024, 2048), batch_size=32, max_anchors=512)
    mapper = Mapper(gi, MappingParams().make_sane(), cfg, device="cuda")
    torch.cuda.synchronize()
    log(f"# phase 4: genome + index + device upload {time.time()-t0:.1f}s")

    t0 = time.time()
    mapper.map_reads(recs)                      # warm: allocator, kernels
    torch.cuda.synchronize()
    log(f"# warm pass {time.time()-t0:.1f}s")

    from blasr_tpu_torch.pipeline.metrics import MappingMetrics
    mapper.metrics = MappingMetrics()
    cuda_ops.reset_launch_counts()
    with StageTimer() as st:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        per_read = mapper.map_reads(recs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = dict(cuda_ops.LAUNCHES)
    stages = st.totals()
    rps = len(recs) / wall
    placed = 0
    for s, alns in zip(sims, per_read):
        if not alns:
            continue
        best = min(alns, key=lambda a: a.score)
        if (best.strand == s.strand and best.tstart < s.tend
                and best.tend > s.tstart):
            placed += 1
    frac = placed / len(recs)
    log(f"# bench: {len(recs)} reads in {wall:.3f}s = {rps:.2f} reads/s on "
        f"{card}; placed {placed}/{len(recs)} ({100 * frac:.1f}%)")
    log("# per-stage device ms (CUDA events, summed over batches): "
        + json.dumps({k: round(v, 3) for k, v in stages.items()}))
    log("# host clocks (s): " + json.dumps(
        {k: round(v, 3) for k, v in mapper.metrics.clocks.items()})
        + " counters: " + json.dumps(dict(mapper.metrics.counters)))
    log(f"# main-path launches: {launches}")
    assert frac >= 0.95, f"only {100 * frac:.1f}% of reads placed"
    assert all(v > 0 for v in launches.values()), \
        f"a kernel of the main path was not launched: {launches}"
    return launches


def main() -> int:
    global np, torch
    try:
        import numpy as np
        import torch
    except ImportError as e:
        sys.stderr.write(f"chip_smoke: {e}\n")
        return 2
    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke: no CUDA device available\n")
        return 2
    if not os.path.isdir(os.path.join(HERE, "blasr_tpu_torch")):
        sys.stderr.write("chip_smoke: run it from a checkout of the "
                         "repository (blasr_tpu_torch/ not found)\n")
        return 2
    sys.path.insert(0, HERE)
    os.chdir(HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    nvcc = subprocess.run(["/usr/local/cuda/bin/nvcc", "--version"],
                          capture_output=True, text=True).stdout
    log(f"# python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}; nvcc: "
        f"{nvcc.strip().splitlines()[-1] if nvcc else 'not found'}")
    log(f"# card: {card}; devices: {torch.cuda.device_count()}")

    from blasr_tpu_torch.kernels import cuda_ops
    t0 = time.time()
    cuda_ops.build()
    cuda_ops._load()
    log(f"# kernels built in {time.time() - t0:.1f}s -> "
        f"{cuda_ops.library_path()}")
    for line in cuda_ops.build_log().splitlines():
        if "registers" in line or "spill" in line:
            log(f"#   ptxas: {line.strip()}")

    t0 = time.time()
    kres, _ = phase_kernels(card)
    log(f"# phase 2 done in {time.time() - t0:.1f}s")
    with tempfile.TemporaryDirectory() as d:
        t0 = time.time()
        phase_goldens(d, cuda_ops)
        log(f"# phase 3 done in {time.time() - t0:.1f}s")
    t0 = time.time()
    launches = phase_bench(card, cuda_ops)
    log(f"# phase 4 done in {time.time() - t0:.1f}s")
    assert "jax" not in sys.modules or sys.modules["jax"] is None

    table = {"kernels": [
        {"name": "banded_dp", "route": "cuda", "source": DP_SRC,
         "replaces": "blasr_tpu/kernels/pallas_banded.py:388",
         "launches": launches["banded_dp"],
         "max_abs_err": kres["banded_dp"]["err"],
         "ms": kres["banded_dp"]["ms"],
         "plain_ms": kres["banded_dp"]["plain_ms"]},
        {"name": "banded_traceback", "route": "cuda", "source": TB_SRC,
         "replaces": "blasr_tpu/kernels/banded.py:424",
         "launches": launches["banded_traceback"],
         "max_abs_err": kres["banded_traceback"]["err"],
         "ms": kres["banded_traceback"]["ms"],
         "plain_ms": kres["banded_traceback"]["plain_ms"]},
    ]}
    print(json.dumps(table))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

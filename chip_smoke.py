#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (blasr_tpu_torch) on one GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases (any failed check exits nonzero):
  1. header: torch / CUDA / nvcc versions, the card's name and power limit;
     build the hand-written kernels K1 (banded DP, distance and QV modes)
     and K2 (traceback walk) from ``blasr_tpu_torch/csrc``;
  2. each kernel against its plain PyTorch version at the main path's
     shapes (N=640 items, L=2048 rows, W=3072 window), exact equality,
     timed with CUDA events: K1, K1-QV (random QV words in the three
     flavours: IDS tracks, plain base qualities, none) and K2;
  3. the golden worlds of tests/test_golden.py through the port's CLI with
     ``--device cuda``, byte for byte against tests/golden/: the main path
     (small: 60 kb, 12 reads; big: 4.6 Mbp, 11 reads; golden.{m4,sam,
     m4.big,sam.big}) and the ``--useQuality`` path (FASTQ and hp-biased
     STR worlds; golden.{m4.fastq,sam.fastq,sam.hpstr.qv}); then the IDS
     world of make_qvsteer, built in memory (its bax.h5 needs h5py), mapped
     with the port's Mapper on ``cuda`` and on ``cpu``: identical
     positions, CIGARs, scores and mapQV;
  4. the bench.py workload (4.6 Mbp genome, k=12, 512 CLR reads of
     0.5-2 kb at 85% accuracy), once in distance mode and once under
     ``--useQuality`` with per-base qualities 8-39: reads/s, per-stage
     device times, and the share of reads placed on their simulated
     interval (>= 95%).  Launch counts are zeroed just before each of the
     two runs and read just after it.
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

# the port needs neither JAX nor the JAX package: fail loudly if it does
sys.modules["jax"] = None
sys.modules["blasr_tpu"] = None

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "tests", "golden")
DP_SRC = "blasr_tpu_torch/csrc/banded_dp.cu"
TB_SRC = "blasr_tpu_torch/csrc/banded_traceback.cu"
# published H100 SXM peaks: HBM bytes/s, float32 (non-tensor-core) ops/s
HBM_BPS = 3.35e12
F32_OPS = 67e12
# float32 operations per active banded cell of K1 (the recurrence: diagonal
# min 2, source compares 2, M 1, I 2+1+1, base 1, g 3, prefix-min ~2.5,
# D 4, d_open 2, d_from_m 1, ~25) and of K1-QV (+ the prefix-sum scan of
# the deletion costs, g and D one add each instead of the affine terms)
K1_OPS_PER_CELL = 25
K1QV_OPS_PER_CELL = 27
# a dependent 4-byte gather still moves one 32-byte DRAM sector
SECTOR = 32


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def bound(nbytes: float, ops: float):
    """(bound ms, what sets it): the larger of bytes over the HBM rate and
    operations over the float32 peak."""
    tb, to = nbytes / HBM_BPS, ops / F32_OPS
    return 1e3 * max(tb, to), ("bytes" if tb >= to else "operations")


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


def qv_words(rng, N, L, params, mismatch):
    """Packed QV words (kernels/banded.py::unpack_qv layout) in the three
    flavours of Mapper.pack_qv_rows, item i taking flavour i % 3: IDS
    (random costs 1-29, tags 0-3 and 7, the global priors), plain base
    qualities 8-39 with flat indels, and the flat no-QV costs."""
    q1 = np.zeros((N, L), np.int64)
    q2 = np.zeros((N, L), np.int64)
    z, seven = np.zeros(L, np.int64), np.full(L, 7, np.int64)
    for i in range(N):
        if i % 3 == 0:
            insq, delq, subq = (rng.integers(1, 30, L) for _ in range(3))
            dtag, stag = (rng.choice([0, 1, 2, 3, 7], L) for _ in range(2))
            dpri = np.full(L, params.global_deletion_prior)
            spri = np.full(L, params.substitution_prior)
        elif i % 3 == 1:
            insq, delq, subq, dtag, stag = (np.full(L, params.indel), z, z,
                                            seven, seven)
            dpri, spri = np.full(L, params.indel), rng.integers(8, 40, L)
        else:
            insq, delq, subq, dtag, stag = (np.full(L, params.insertion), z,
                                            z, seven, seven)
            dpri, spri = np.full(L, params.deletion), np.full(L, mismatch)
        q1[i] = insq | (delq << 8) | (subq << 16) | (dtag << 24) | (stag << 27)
        q2[i] = dpri | (spri << 8)
    return q1.astype(np.int32), q2.astype(np.int32)


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


def check_dp(out, ref, name: str) -> float:
    """Exact equality of a K1 result with the plain DP; max |diff|."""
    for f in ("score", "valid", "final_state"):
        a, b = getattr(out, f), getattr(ref, f)
        assert torch.equal(a, b), f"{name} {f} differs from the plain DP"
    bad_rows = int((out.tbbits != ref.tbbits).any(dim=2).sum())
    assert bad_rows == 0, f"{name} tbbits differ in {bad_rows} rows"
    return max_abs([out.score[out.valid], out.final_state, out.tbbits],
                   [ref.score[ref.valid], ref.final_state, ref.tbbits])


def phase_kernels(card):
    from blasr_tpu_torch.kernels import cuda_ops
    from blasr_tpu_torch.kernels.banded import (banded_align,
                                                banded_traceback,
                                                banded_traceback_plain)
    from blasr_tpu_torch.kernels.pallas_banded import banded_align_cuda
    from blasr_tpu_torch.params import MappingParams, ShapeConfig

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
    params = MappingParams().make_sane()
    sm = np.asarray(params.score_matrix, np.float32).reshape(25)
    gaps = (4.0, 4.0, 5.0, 5.0)
    args = (reads, windows, offs, qa, qb, ta, tb, sm, *gaps)
    cells = float((qb - qa).sum()) * 128
    k1_bytes = (N * L + N * W + 4 * N * L + 16 * N     # reads .. tb
                + 512 * N * L + 9 * N)                # tbbits, score, state

    out = banded_align_cuda(*args)
    torch.cuda.synchronize()
    ref = banded_align(*args)          # plain version, same inputs
    torch.cuda.synchronize()
    dp_err = check_dp(out, ref, "K1")
    log(f"# K1 == plain: score/valid/final_state/tbbits exact "
        f"({int(out.valid.sum())}/{N} valid)")
    dp_ms = cuda_ms(lambda: banded_align_cuda(*args), 5)
    dp_plain_ms = cuda_ms(lambda: banded_align(*args), 1)
    dp_bound = bound(k1_bytes, cells * K1_OPS_PER_CELL)
    log(f"# K1 banded_dp: kernel {dp_ms:.3f} ms, plain {dp_plain_ms:.1f} ms, "
        f"bound {dp_bound[0]:.3f} ms ({dp_bound[1]}) per call "
        f"(N={N}, L={L}) on {card}")

    q1, q2 = qv_words(rng, N, L, params, int(sm[1]))
    qv = dict(qv1=torch.from_numpy(q1).to(dev),
              qv2=torch.from_numpy(q2).to(dev))
    outq = banded_align_cuda(*args, **qv)
    torch.cuda.synchronize()
    refq = banded_align(*args, **qv)
    torch.cuda.synchronize()
    qv_err = check_dp(outq, refq, "K1-QV")
    log(f"# K1-QV == plain: score/valid/final_state/tbbits exact "
        f"({int(outq.valid.sum())}/{N} valid; flavours IDS/QV/none)")
    qv_ms = cuda_ms(lambda: banded_align_cuda(*args, **qv), 5)
    qv_plain_ms = cuda_ms(lambda: banded_align(*args, **qv), 1)
    qv_bound = bound(k1_bytes + 8 * N * L, cells * K1QV_OPS_PER_CELL)
    log(f"# K1-QV banded_dp_qv: kernel {qv_ms:.3f} ms, plain "
        f"{qv_plain_ms:.1f} ms, bound {qv_bound[0]:.3f} ms ({qv_bound[1]}) "
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
        # the walk needs one dependent cell gather (one DRAM sector) per
        # emitted pair, its per-row inputs (qa, qb, ta, tb, final_state,
        # valid: 21 B) and its outputs (pairs, five counts, overflow);
        # about 30 integer operations per step
        steps = float(k2.n_pairs.sum())
        k2_bytes = (SECTOR * steps + 21 * N
                    + 4 * k2.pairs.numel() + 21 * N)
        tb_times[t_max] = (kms, pms, bound(k2_bytes, 30 * steps))
        log(f"# K2 == plain at t_max={t_max}: exact, {n_ovf[t_max]} rows "
            f"overflow; kernel {kms:.3f} ms, plain {pms:.1f} ms, bound "
            f"{tb_times[t_max][2][0]:.4f} ms "
            f"({tb_times[t_max][2][1]}) on {card}")
    assert n_ovf[(3 * T) // 8] > 0, "the overflow path of K2 was not exercised"
    kms, pms, kb = tb_times[(3 * T) // 8]
    return {
        "banded_dp": dict(err=dp_err, ms=dp_ms, plain_ms=dp_plain_ms,
                          bound=dp_bound),
        "banded_dp_qv": dict(err=qv_err, ms=qv_ms, plain_ms=qv_plain_ms,
                             bound=qv_bound),
        "banded_traceback": dict(err=tb_err, ms=kms, plain_ms=pms, bound=kb),
    }


# ---------------------------------------------------------------- phase 3

def make_small(d):
    """tests/test_golden.py::make_small (copied: that module's conftest
    imports JAX)."""
    from blasr_tpu_torch.io.fasta import FastaRecord, write_fasta
    from blasr_tpu_torch.sim import random_genome, simulate_reads
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
    from blasr_tpu_torch.io.fasta import FastaRecord, write_fasta
    from blasr_tpu_torch.sim import random_genome, simulate_reads
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


def make_fastq(d):
    """tests/test_golden.py::make_fastq (copied): FASTQ reads over a genome
    with a near-duplicate repeat."""
    from blasr_tpu_torch.io.fasta import FastaRecord, decode, write_fasta
    from blasr_tpu_torch.sim import random_genome, simulate_reads
    contigs = random_genome(60_000, seed=555, n_contigs=2)
    g = contigs[0].seq
    rng = np.random.default_rng(557)
    block = g[5_000:8_000].copy()
    mut = rng.random(len(block)) < 0.015
    block[mut] = rng.integers(0, 4, int(mut.sum()))
    g[20_000:23_000] = block
    sims = simulate_reads([FastaRecord("rep", g[4_500:8_500])], 5,
                          read_len=(300, 900), accuracy=0.87, seed=556)
    sims += simulate_reads(contigs, 3, read_len=(250, 800), accuracy=0.87,
                           seed=558)
    path = os.path.join(d, "reads.fastq")
    with open(path, "w") as f:
        for i, s in enumerate(sims):
            seq = s.rec.seq
            qual = rng.integers(8, 40, len(seq))
            f.write(f"@movie/{i}/0_{len(seq)}\n{decode(seq)}\n+\n")
            f.write("".join(chr(int(x) + 33) for x in qual) + "\n")
    write_fasta(os.path.join(d, "genome_fq.fa"), contigs)
    return path, os.path.join(d, "genome_fq.fa")


def make_hpstr(d):
    """tests/test_golden.py::make_hpstr (copied): homopolymer-insertion-
    biased reads over STR arrays and planted fat homopolymer runs."""
    from blasr_tpu_torch.io.fasta import decode, write_fasta
    from blasr_tpu_torch.sim import mutate, structured_genome
    contigs, features = structured_genome(
        80_000, seed=901, n_str=4, str_period=(2, 6), str_len=(400, 1200))
    g = contigs[0].seq
    rng = np.random.default_rng(902)
    for pos, ln in ((12_000, 12), (33_000, 9), (61_000, 15)):
        g[pos:pos + ln] = g[pos]
    targets = [12_000 - 200, 33_000 - 350, 61_000 - 100]
    targets += [f.start - 150 for f in features if f.kind == "str"][:3]
    path = os.path.join(d, "reads_hp.fastq")
    with open(path, "w") as f:
        for i, ts in enumerate(targets):
            ln = int(rng.integers(500, 800))
            ts = max(0, min(ts, len(g) - ln))
            seq = mutate(g[ts:ts + ln], rng, 0.02, 0.06, 0.03,
                         hp_ins_mult=6.0)
            qual = rng.integers(8, 40, len(seq))
            f.write(f"@movie/{i}/0_{len(seq)}\n{decode(seq)}\n+\n")
            f.write("".join(chr(int(x) + 33) for x in qual) + "\n")
    write_fasta(os.path.join(d, "genome_hp.fa"), contigs)
    return path, os.path.join(d, "genome_hp.fa")


def qvsteer_world():
    """tests/test_golden.py::make_qvsteer's genome and reads, built in
    memory as records carrying the same tracks its bax.h5 holds (the
    subreads BaxReader extracts: the whole read, its QualityValue as
    ``qual``, every track as ``tracks``)."""
    from blasr_tpu_torch.io.fasta import FastaRecord
    from blasr_tpu_torch.sim import random_genome
    contigs = random_genome(30_000, seed=9911)
    g = contigs[0].seq
    g[4999] = 0
    g[5000:5008] = 3
    g[5008] = 1
    recs = []
    for k, hole in enumerate((5, 9)):
        start = 4800 + 40 * k
        seg = np.asarray(g[start:start + 400])
        run0 = 5000 - start
        read = np.concatenate(
            [seg[:run0 + 4], [3], seg[run0 + 4:]]).astype(np.int8)
        n = len(read)
        insq = np.full(n, 18, np.uint8)
        insq[run0 + 1 + 7 * (k % 2)] = 2
        tracks = {
            "QualityValue": np.full(n, 30, np.uint8),
            "InsertionQV": insq,
            "DeletionQV": np.full(n, 13, np.uint8),
            "SubstitutionQV": np.full(n, 21, np.uint8),
            "DeletionTag": np.full(n, ord("N"), np.uint8),
            "SubstitutionTag": np.full(n, ord("N"), np.uint8),
        }
        recs.append(FastaRecord(f"m_qv/{hole}/0_{n}", read,
                                tracks["QualityValue"].astype(np.int32),
                                tracks))
    return contigs, recs


def run_goldens(d, cases, worlds):
    from blasr_tpu_torch.cli.blasr import run
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
    return n_ok


def phase_goldens(d, cuda_ops):
    worlds = {"small": make_small(d), "big": make_big(d),
              "fastq": make_fastq(d), "hpstr": make_hpstr(d)}
    # (label, cases, kernels it must launch, kernel it must not launch)
    for label, cases, needed, unused in (
            ("main path", [("m4", "small", ["-m", "4"]),
                           ("sam", "small", ["--sam", "--clipping", "soft"]),
                           ("m4.big", "big", ["-m", "4"]),
                           ("sam.big", "big",
                            ["--sam", "--clipping", "soft"])],
             ("banded_dp", "banded_traceback"), "banded_dp_qv"),
            ("--useQuality", [("m4.fastq", "fastq",
                               ["-m", "4", "--useQuality"]),
                              ("sam.fastq", "fastq",
                               ["--sam", "--clipping", "soft",
                                "--useQuality"]),
                              ("sam.hpstr.qv", "hpstr",
                               ["--sam", "--clipping", "soft",
                                "--useQuality"])],
             ("banded_dp_qv", "banded_traceback"), "banded_dp")):
        cuda_ops.reset_launch_counts()
        n_ok = run_goldens(d, cases, worlds)
        launches = dict(cuda_ops.LAUNCHES)
        log(f"# goldens ({label}) identical: {n_ok}/{len(cases)}; "
            f"launches {launches}")
        assert n_ok == len(cases), f"golden outputs differ ({label})"
        assert all(launches[k] > 0 for k in needed), \
            f"kernels not launched ({label}): {launches}"
        assert launches[unused] == 0, f"the {label} path launched {unused}"


def phase_ids(cuda_ops):
    """The IDS flavour end to end: make_qvsteer's reads mapped by the
    port's Mapper on cuda (K1-QV) and on cpu (the plain DP)."""
    from blasr_tpu_torch.index.genome import build_genome_index
    from blasr_tpu_torch.params import MappingParams
    from blasr_tpu_torch.pipeline.map_read import Mapper
    from blasr_tpu_torch.pipeline.select import store_map_qvs
    contigs, recs = qvsteer_world()
    params = MappingParams(ignore_qualities=False).make_sane()
    gi = build_genome_index(contigs, k=min(params.min_match_length, 16))

    def summary(device, p):
        per_read = Mapper(gi, p, device=device).map_reads(recs)
        out = []
        for alns in per_read:
            store_map_qvs(alns, p, gi)
            out.append(sorted((a.strand, a.tindex, a.tstart, a.tend,
                               a.qstart, a.qend, list(a.cigar), a.score,
                               a.map_qv) for a in alns))
        return out

    cuda_ops.reset_launch_counts()
    on_card = summary("cuda", params)
    launches = dict(cuda_ops.LAUNCHES)
    on_cpu = summary("cpu", params)
    flat = summary("cuda", MappingParams().make_sane())
    log(f"# IDS world: {sum(map(len, on_card))} alignments; cuda == cpu: "
        f"{on_card == on_cpu}; launches {launches}")
    assert all(on_card), "an IDS read did not map"
    assert on_card == on_cpu, "IDS alignments differ between cuda and cpu"
    assert launches["banded_dp_qv"] > 0 and launches["banded_dp"] == 0
    steered = sum(a[6] != b[6] for x, y in zip(on_card, flat)
                  for a, b in zip(x, y))
    log(f"# IDS world: QV steering moved {steered} CIGAR(s) against the "
        f"run without --useQuality")
    assert steered > 0, "QV steering changed no CIGAR"


# ---------------------------------------------------------------- phase 4

def bench_world():
    from blasr_tpu_torch.index.genome import build_genome_index
    from blasr_tpu_torch.sim import random_genome, simulate_reads
    contigs = random_genome(4_600_000, seed=11)
    gi = build_genome_index(contigs, k=12)
    sims = simulate_reads(contigs, 512, read_len=(500, 1980),
                          accuracy=0.85, seed=12)
    return gi, sims


def phase_bench(card, cuda_ops, gi, sims, use_qv: bool, dev=None):
    """One bench pass (warm, then timed with launch counts zeroed just
    before and read just after); returns (launches, device index)."""
    from blasr_tpu_torch.io.fasta import FastaRecord
    from blasr_tpu_torch.params import MappingParams, ShapeConfig
    from blasr_tpu_torch.pipeline import map_read
    from blasr_tpu_torch.pipeline.map_read import Mapper, StageTimer
    from blasr_tpu_torch.pipeline.metrics import MappingMetrics

    label = "--useQuality" if use_qv else "distance"
    recs = [s.rec for s in sims]
    params = MappingParams().make_sane()
    if use_qv:
        # per-base qualities 8-39, drawn as make_fastq draws them
        rng = np.random.default_rng(13)
        recs = [FastaRecord(r.title, r.seq,
                            rng.integers(8, 40, len(r.seq))) for r in recs]
        params = MappingParams(ignore_qualities=False).make_sane()
    t0 = time.time()
    cfg = ShapeConfig(buckets=(1024, 2048), batch_size=32, max_anchors=512)
    mapper = Mapper(gi, params, cfg, device="cuda", dev=dev)
    torch.cuda.synchronize()
    log(f"# phase 4 ({label}): mapper + device index {time.time()-t0:.1f}s")

    t0 = time.time()
    mapper.map_reads(recs)                      # warm: allocator, kernels
    torch.cuda.synchronize()
    log(f"# warm pass {time.time()-t0:.1f}s")

    # count the batch dispatches: first passes, and dense reruns at
    # tb_cap = T (an overflowed traceback that can reach the output)
    calls = {"batches": 0, "dense_reruns": 0}
    inner = map_read.map_batch

    def counted(*a, **kw):
        calls["dense_reruns" if kw.get("tb_cap") else "batches"] += 1
        return inner(*a, **kw)

    mapper.metrics = MappingMetrics()
    map_read.map_batch = counted
    cuda_ops.reset_launch_counts()
    try:
        with StageTimer() as st:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            per_read = mapper.map_reads(recs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        map_read.map_batch = inner
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
    log(f"# bench ({label}): {len(recs)} reads in {wall:.3f}s = {rps:.2f} "
        f"reads/s on {card}; placed {placed}/{len(recs)} "
        f"({100 * frac:.1f}%)")
    log(f"# per-stage device ms ({label}; CUDA events, summed over "
        "batches): " + json.dumps({k: round(v, 3) for k, v in stages.items()}))
    log("# host clocks (s): " + json.dumps(
        {k: round(v, 3) for k, v in mapper.metrics.clocks.items()})
        + " counters: " + json.dumps(dict(mapper.metrics.counters)))
    log(f"# main-path launches ({label}): {launches}; dispatches "
        f"{json.dumps(calls)}")
    assert frac >= 0.95, f"only {100 * frac:.1f}% of reads placed ({label})"
    dp = "banded_dp_qv" if use_qv else "banded_dp"
    other = "banded_dp" if use_qv else "banded_dp_qv"
    assert launches[dp] > 0 and launches["banded_traceback"] > 0, \
        f"a kernel of the {label} path was not launched: {launches}"
    assert launches[other] == 0, f"the {label} path launched {other}"
    return launches, mapper.dev


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
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"#   ptxas: {line.strip()}")

    t0 = time.time()
    kres = phase_kernels(card)
    log(f"# phase 2 done in {time.time() - t0:.1f}s")
    with tempfile.TemporaryDirectory() as d:
        t0 = time.time()
        phase_goldens(d, cuda_ops)
        phase_ids(cuda_ops)
        log(f"# phase 3 done in {time.time() - t0:.1f}s")
    t0 = time.time()
    gi, sims = bench_world()
    log(f"# phase 4: genome + index {time.time()-t0:.1f}s")
    dist, dev = phase_bench(card, cuda_ops, gi, sims, use_qv=False)
    qvl, _ = phase_bench(card, cuda_ops, gi, sims, use_qv=True, dev=dev)
    log(f"# phase 4 done in {time.time() - t0:.1f}s")
    assert "jax" not in sys.modules or sys.modules["jax"] is None
    loaded = [m for m in sys.modules if m.startswith("blasr_tpu.")]
    assert not loaded, f"JAX-package modules were loaded: {loaded}"

    launches = {"banded_dp": dist["banded_dp"],
                "banded_dp_qv": qvl["banded_dp_qv"],
                "banded_traceback": (dist["banded_traceback"]
                                     + qvl["banded_traceback"])}
    rows = [("banded_dp", DP_SRC, "blasr_tpu/kernels/pallas_banded.py:388"),
            ("banded_dp_qv", DP_SRC,
             "blasr_tpu/kernels/pallas_banded.py:388"),
            ("banded_traceback", TB_SRC, "blasr_tpu/kernels/banded.py:424")]
    table = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": kres[name]["err"],
         "ms": kres[name]["ms"], "plain_ms": kres[name]["plain_ms"],
         "bound_ms": kres[name]["bound"][0],
         "bound_by": kres[name]["bound"][1], "library_ms": None}
        for name, src, rep in rows]}
    print(json.dumps(table))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (blasr_tpu_torch) on one GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py
    python3 chip_smoke.py --compare K1|K2|K3|K5|K6 A/kernel.cu B/kernel.cu

The second form only builds the named kernel from each given source (K1
banded_dp.cu, K2 banded_traceback.cu, K3 chain_scan.cu, K5
anchor_search.cu, K6 band_offsets.cu; e.g. a parent commit's unpacked
beside this one's), holds their outputs equal on phase 2's inputs (K3:
the bench batch and A = 8192; K5: the bench batch's find_anchors call and
a long read's at L = 65536; K6: the bench batch's two _band_offsets calls
and a long read's) and times them in turns, A B B A (see ``compare_k1``
.. ``compare_k6``): K5 and K6 by their device time alone (``device_ms``)
and by the call's.  ``--device-times`` (run by phase 2 as a child) and
``--k4-kernels`` (phase 5's) are the script's own child modes.

Phases (any failed check exits nonzero):
  1. header: torch / CUDA / nvcc versions, the card's name and power limit;
     build the hand-written kernels K1 (banded DP, distance and QV modes),
     K2 (traceback walk), K3 (chain scan), K4 (SDP window pass), K5 (anchor
     search) and K6 (band offsets) from ``blasr_tpu_torch/csrc``, one nvcc
     per source, all at once;
  2. each kernel against its plain PyTorch version at the main path's
     shapes, exact equality, timed with CUDA events: K1, K1-QV (random QV
     words in the three flavours: IDS tracks, plain base qualities, none)
     and K2 at N=640 items, L=2048 rows, W=3072 window (K2 warm, and cold
     with the L2 flushed before each call), K1 and K1-QV also on the edge
     shapes of their 16-row tiles, K2 on their cell words and on planted
     walks at the edges of its own 16-row tiles; K3 on the anchors of the
     bench workload's first batch (2B=64 strand-rows, A=512) in its
     candidate and guide passes, a lookback-64 global chain and the edge
     inputs of tests/torch_edge_cases.py; K4 (the whole
     window_fragment_diags_banded, one launch) at N=192, L=2048,
     W=3072, D=512, occ 2 and 1, on bench-genome windows with planted
     read k-mers, and on the edge inputs; K3 at A=8192 (past one
     block's shared memory) and K4 at L=65536 (a row over 64 CTAs); K5
     on the bench batch (the
     find_anchors call of its map_batch) and K6 on the two _band_offsets
     calls of that batch's map_batch, captured, both also on the edge
     inputs; K5's and K6's calls timed three ways: the call (events around
     20 back to back), the device behind a spin kernel (``device_ms``)
     and each kernel by torch.profiler in a child process
     (``--device-times``: one profiler session of its own);
  3. the golden worlds of tests/test_golden.py through the port's CLI with
     ``--device cuda``, byte for byte against tests/golden/, each group
     launching K1 or K1-QV and K2-K6: the main path (small: 60 kb, 12
     reads; big: 4.6 Mbp, 11 reads; golden.{m4,sam,m4.big,sam.big}, and
     on the big world --fastMaxInterval, the chain scan with lookback 64,
     and --aggressiveIntervalCut: golden.{m4.fastmax,m4.aggressive}); the
     ``--useQuality`` path (FASTQ and hp-biased STR worlds;
     golden.{m4.fastq,sam.fastq,sam.hpstr.qv}); the small world's other
     formats and mapping flags (golden.{m0,m1,m2,m3,m5,sam.hard,
     sam.subread,m4.rb,m4.scores,m4.filter}; m4.scores with gap costs 6 and
     7); the other inputs (golden.{m4.bwt,m4.fofn,m4.bamin,m4.xml,m4.unal,
     m4.unal.names}); concordant mapping (golden.m4.concordant, with the
     padded mini index's host build and upload timed); then the IDS world
     of make_qvsteer, built in memory (its bax.h5 needs h5py), mapped with
     the port's Mapper on ``cuda`` and on ``cpu``: identical positions,
     CIGARs, scores and mapQV; then --onegap with --bam, and --extend, on
     a world of a spliced read and reads with noisy ends, each equal to
     the same run with ``--device cpu`` (decoded BAM records, m4 text; the
     BAM also decodes to the --sam output), and the --anchors and
     --clusters dumps of the small world, cuda == cpu; then two simulated
     reads of ~40 kb on a 1 Mbp genome (bucket 65536) and one of ~100 kb
     (map_long_reads: two segments at bucket 65536, stitched) mapped on
     the card, each on its simulated interval and strand, every K2, K4,
     K5 and K6 launch of that run captured and held to the plain version
     (L = 65536); and
     tests/test_longread.py's ~20 kb CLR read at buckets (1024, 2048),
     held to its bounds and to the same read mapped on ``cpu``;
  4. the bench.py workload (4.6 Mbp genome, k=12, 512 CLR reads of
     0.5-2 kb at 85% accuracy), once in distance mode and once under
     ``--useQuality`` with per-base qualities 8-39: reads/s, per-stage
     device times, and the share of reads placed on their simulated
     interval (>= 95%).  Launch counts are zeroed just before each of the
     two runs and read just after it: K3 and K6 launch twice per batch
     dispatch (candidate and guide passes; band offsets before and after
     the SDP pass), K4 and K5 once;
  5. torch.profiler over one more pass in each mode: launches per read, the
     device's busy share, the kernels with the most device time, each
     hand-written kernel's device ms per call; over one
     bench-shape call of K4's function, which must be one kernel (in a
     child process, ``--k4-kernels``, with a profiler session of its
     own); then
     rule 2's measure for K1-K6: launches per pass pair x (kernel ms -
     bound ms), with the kernel's ms as phase 2 times the call and as its
     device time alone (K5, K6: phase 2's profiled calls; K1-K4: phase 5's
     passes, per launch).
The second-to-last lines are a JSON kernel table and the card's name and
power limit; the last line is ``{"ok": true, "device": {...}}``.
Exits nonzero without a result when no CUDA device is present or when
the blasr_tpu_torch package is not beside this file.
"""

from __future__ import annotations

import contextlib
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
CHAIN_SRC = "blasr_tpu_torch/csrc/chain_scan.cu"
SDP_SRC = "blasr_tpu_torch/csrc/sdp_window.cu"
ANCHOR_SRC = "blasr_tpu_torch/csrc/anchor_search.cu"
BAND_SRC = "blasr_tpu_torch/csrc/band_offsets.cu"
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
# K3: float32/int operations per predecessor test (two differences, the
# drift and span conversions, the fused bound, five compares, the gain's
# min and conversion, the add and the running max, ~20) and per anchor
# per selection round (the rank key, the overlap test, ~12)
K3_OPS_PER_PAIR = 20
K3_OPS_PER_SELECT = 12
# float32 operations per active cell of the hp-band DP (K1's recurrence plus
# the homopolymer open/extend terms, ~10 more)
HP_OPS_PER_CELL = 35


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


def timed(fn):
    """(fn(), its device ms): one call between two CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def cuda_ms(fn, reps: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# cycles a spin kernel holds the stream for while the host enqueues one
# call behind it (~1 ms at the H100's clocks, longer than any wrapper's
# host time here)
SPIN_CYCLES = 2_000_000


def device_ms(fn, reps: int) -> float:
    """Mean device ms of one call of ``fn``, the host's time hidden: a spin
    kernel (``torch.cuda._sleep``) keeps the stream busy while the host
    enqueues two CUDA events around the call, so the events time only the
    call's kernels and the gaps between them on the device."""
    evs = []
    for _ in range(reps):
        torch.cuda._sleep(SPIN_CYCLES)
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        fn()
        ev[1].record()
        evs.append(ev)
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in evs) / reps


def short_name(name: str) -> str:
    """A kernel's name as torch.profiler records it, without its return
    type, namespace and parameter list: 'banded_dp_kernel<false>'."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    return name.split("(")[0]


def is_kernel(name: str, names) -> bool:
    """Whether a short kernel name is one of ``names``, or an instance of
    one of them that names no template arguments ('anchor_candidates'
    takes 'anchor_candidates<3, false>')."""
    return any(name == n or ("<" not in n and name.startswith(n + "<"))
               for n in names)


def cold_ms(fn, reps: int) -> float:
    """Mean device ms of ``fn`` with the L2 flushed before each call (128
    MB written, so the 50 MB L2 holds none of its inputs), each call timed
    alone between two CUDA events (the flush outside them)."""
    flush = torch.empty(1 << 27, dtype=torch.uint8, device="cuda")
    evs = []
    for _ in range(reps):
        flush.fill_(1)
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        fn()
        ev[1].record()
        evs.append(ev)
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in evs) / reps


def check_walk(res, rest, t_max: int, name: str):
    """K2 (banded_traceback on CUDA tensors) against the plain walk, every
    output exactly; its pair buffer is handed out dirty first, so the
    zeros after each stop are the kernel's own.  Returns (K2's result,
    max |diff|)."""
    from blasr_tpu_torch.kernels.banded import (banded_traceback,
                                                banded_traceback_plain,
                                                pair_capacity)
    N = res.tbbits.shape[0]
    torch.full((N, pair_capacity(t_max) // 2), -1, dtype=torch.int32,
               device="cuda")
    k2 = banded_traceback(res, *rest, t_max=t_max)
    torch.cuda.synchronize()
    pl = banded_traceback_plain(res, *rest, t_max=t_max)
    torch.cuda.synchronize()
    for f in k2._fields:
        a, b = getattr(k2, f), getattr(pl, f)
        assert a.dtype == b.dtype and torch.equal(a, b), \
            f"{name}: {f} differs from the plain walk"
    return k2, max_abs(list(k2), list(pl))


def profiled_kernels(fn) -> list:
    """Names of the CUDA kernels one call of ``fn`` launches, as
    torch.profiler records them (copies and memsets left out), after one
    warm call."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.name.startswith(("Memcpy", "Memset"))]


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
    from blasr_tpu_torch.kernels.banded import (BandedResult, banded_align,
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
    dist_kw = dict(match=float(sm[0]), mismatch=float(sm[1]),
                   ins_open=gaps[0], ins_ext=gaps[1], del_open=gaps[2],
                   del_ext=gaps[3])
    launch = (reads, windows, offs, qa, qb, ta, tb)
    dp_ms = cuda_ms(lambda: cuda_ops.banded_dp_launch(*launch, **dist_kw), 5)
    dp_fn_ms = cuda_ms(lambda: banded_align_cuda(*args), 5)
    dp_plain_ms = cuda_ms(lambda: banded_align(*args), 1)
    dp_bound = bound(k1_bytes, cells * K1_OPS_PER_CELL)
    log(f"# K1 banded_dp: kernel {dp_ms:.4f} ms (banded_align_cuda with its "
        f"slope check {dp_fn_ms:.4f} ms), plain {dp_plain_ms:.1f} ms, bound "
        f"{dp_bound[0]:.3f} ms ({dp_bound[1]}) per call (N={N}, L={L}) on "
        f"{card}")

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
    qv_ms = cuda_ms(lambda: cuda_ops.banded_dp_launch(*launch, **dist_kw,
                                                      **qv), 5)
    qv_fn_ms = cuda_ms(lambda: banded_align_cuda(*args, **qv), 5)
    qv_plain_ms = cuda_ms(lambda: banded_align(*args, **qv), 1)
    qv_bound = bound(k1_bytes + 8 * N * L, cells * K1QV_OPS_PER_CELL)
    log(f"# K1-QV banded_dp_qv: kernel {qv_ms:.4f} ms (banded_align_cuda "
        f"with its slope check {qv_fn_ms:.4f} ms), plain {qv_plain_ms:.1f} "
        f"ms, bound {qv_bound[0]:.3f} ms ({qv_bound[1]}) per call (N={N}, "
        f"L={L}) on {card}")

    from torch_edge_cases import (BANDED_CASES, BANDED_QV_SEED,
                                  TRACEBACK_CASES, banded_case,
                                  traceback_case)
    tb_err = 0.0
    for name in BANDED_CASES:
        # the QV words of tests/test_torch_cuda.py::qv_words, same draws
        e = [torch.from_numpy(x).to(dev) for x in banded_case(name)]
        n_e, l_e = e[0].shape
        w_e = e[1].shape[1]
        q1e, q2e = qv_words(np.random.default_rng(BANDED_QV_SEED), n_e, l_e,
                            params, int(sm[1]))
        for label, qkw in (("K1", {}),
                           ("K1-QV", dict(qv1=torch.from_numpy(q1e).to(dev),
                                          qv2=torch.from_numpy(q2e).to(dev)))):
            a_e = (*e, sm, *gaps)
            k1e = banded_align_cuda(*a_e, **qkw)
            err = check_dp(k1e, banded_align(*a_e, **qkw), f"{label} {name}")
            if label == "K1":
                dp_err = max(dp_err, err)
            else:
                qv_err = max(qv_err, err)
            # K2 on these cell words, at t_max = 3T/8 and T
            for t_e in ((3 * (l_e + w_e)) // 8, l_e + w_e):
                tb_err = max(tb_err, check_walk(
                    k1e, e[2:], t_e, f"K2 on {label} {name} t_max={t_e}")[1])
    log(f"# K1 and K1-QV == plain on the {len(BANDED_CASES)} edge shapes of "
        f"their 16-row tiles: exact; K2 == plain on their cell words at "
        f"t_max = 3T/8 and T: exact")
    for name in TRACEBACK_CASES:
        tbb, st, ok, *rest, t_e = traceback_case(name)
        res_e = BandedResult(torch.zeros(len(st), device=dev),
                             *(torch.from_numpy(x).to(dev)
                               for x in (tbb, st, ok)))
        tb_err = max(tb_err, check_walk(
            res_e, [torch.from_numpy(x).to(dev) for x in rest], t_e,
            f"K2 {name}")[1])
    log(f"# K2 == plain on the {len(TRACEBACK_CASES)} planted-walk edge "
        f"inputs: exact")

    tb_times = {}
    n_ovf = {}
    for t_max in ((3 * T) // 8, T):
        run = (lambda: banded_traceback(out, offs, qa, qb, ta, tb,  # noqa
                                        t_max=t_max))
        k2, err = check_walk(out, (offs, qa, qb, ta, tb), t_max,
                             f"K2 at t_max={t_max}")
        tb_err = max(tb_err, err)
        n_ovf[t_max] = int(k2.overflow.sum())
        kms = cuda_ms(run, 5)
        cold = cold_ms(run, 5)
        pms = cuda_ms(lambda: banded_traceback_plain(
            out, offs, qa, qb, ta, tb, t_max=t_max), 1)
        # the walk needs one dependent cell read (one DRAM sector) per
        # emitted pair, its per-row inputs (qa, qb, ta, tb, final_state,
        # valid: 21 B) and its outputs (pairs, five counts, overflow);
        # about 30 integer operations per step
        steps = float(k2.n_pairs.sum())
        k2_bytes = (SECTOR * steps + 21 * N
                    + 4 * k2.pairs.numel() + 21 * N)
        tb_times[t_max] = (kms, pms, bound(k2_bytes, 30 * steps), cold)
        # the rows [qa, qb) of the valid items, which K2 stages whole
        rows = (torch.clamp(qb - 1, max=L - 1) - torch.clamp(qa, min=0)
                + 1).clamp(min=0)
        staged = 512.0 * float((rows * out.valid).sum())
        log(f"# K2 == plain at t_max={t_max}: exact, {n_ovf[t_max]} rows "
            f"overflow, {steps:.0f} steps (longest walk "
            f"{int(k2.n_pairs.max())}), {staged / 1e6:.1f} MB of rows "
            f"staged ({1e3 * staged / HBM_BPS:.4f} ms at the HBM rate); "
            f"kernel {kms:.3f} ms warm (5 reps "
            f"back to back), {cold:.3f} ms cold (L2 flushed before each), "
            f"plain {pms:.1f} ms, bound {tb_times[t_max][2][0]:.4f} ms "
            f"({tb_times[t_max][2][1]}) on {card}")
    assert n_ovf[(3 * T) // 8] > 0, "the overflow path of K2 was not exercised"
    kms, pms, kb, _ = tb_times[(3 * T) // 8]
    hp_bound = bound(k1_bytes, cells * HP_OPS_PER_CELL)
    log(f"# not ported: banded_align with the hp band at these shapes "
        f"(N={N}, L={L}, W={W}, {cells:.0f} active cells): bound "
        f"{hp_bound[0]:.4f} ms ({hp_bound[1]})")
    return {
        "banded_dp": dict(err=dp_err, ms=dp_ms, plain_ms=dp_plain_ms,
                          bound=dp_bound),
        "banded_dp_qv": dict(err=qv_err, ms=qv_ms, plain_ms=qv_plain_ms,
                             bound=qv_bound),
        "banded_traceback": dict(err=tb_err, ms=kms, plain_ms=pms, bound=kb),
    }


def build_source(kernel: str, src: str):
    """One kernel source (e.g. a parent commit's, unpacked beside this
    one) built alone into a shared library with the package's nvcc flags;
    (the ctypes library, the source's bytes)."""
    import ctypes
    import hashlib
    from blasr_tpu_torch.kernels import cuda_ops
    data = open(src, "rb").read()
    so = (cuda_ops.BUILD_DIR
          / f"{kernel.lower()}_{hashlib.sha256(data).hexdigest()[:16]}.so")
    so.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([cuda_ops._nvcc(), *cuda_ops.NVCC_FLAGS, "-shared",
                    "-I", str(cuda_ops.SRC_DIR), "-o", str(so), src],
                   check=True, capture_output=True)
    return ctypes.CDLL(str(so)), data


def in_turns(card, what: str, sources, run, reps: int, mode="warm"):
    """Each source's ``run(i)`` timed in turns, first to last and back
    (A B B A): "warm" (reps back to back, events around them: the call's
    time, host included when the host is the slower), "cold" (L2 flushed
    before each call) or "device" (each call behind a spin kernel, the
    device's time alone, ``device_ms``); one line per source.  Returns
    {source index: [ms, ms]}."""
    order = list(range(len(sources))) + list(reversed(range(len(sources))))
    times = {i: [] for i in range(len(sources))}
    timer = {"warm": cuda_ms, "cold": cold_ms, "device": device_ms}[mode]
    for i in order:
        fn = lambda: run(i)  # noqa: E731
        times[i].append(timer(fn, reps))
    for i, src in enumerate(sources):
        log(f"# {what} from {src}: "
            f"{', '.join(f'{t:.4f}' for t in times[i])} ms per call "
            f"{mode} (outputs equal to the first source's) on {card}")
    return times


def compare_k1(card, sources, reps: int = 5) -> None:
    """K1 and K1-QV from each given banded_dp.cu on phase 2's inputs
    (N=640, L=2048), every output held to the first source's."""
    import ctypes
    from blasr_tpu_torch.params import MappingParams
    libs = []
    for src in sources:
        lib = build_source("K1", src)[0]
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.blasr_banded_dp.argtypes = [P] * 7 + [I] * 3 + [F] * 6 + [P] * 5
        lib.blasr_banded_dp_qv.argtypes = [P] * 9 + [I] * 3 + [F] + [P] * 5
        libs.append(lib)
    N, L, W = 640, 2048, 3072
    rng = np.random.default_rng(7)
    dev = torch.device("cuda")
    ins = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
           for a in random_case(rng, N, L, W)]
    params = MappingParams().make_sane()
    sm = np.asarray(params.score_matrix, np.float32).reshape(25)
    q1, q2 = (torch.from_numpy(q).to(dev)
              for q in qv_words(rng, N, L, params, int(sm[1])))

    def run(lib, use_qv):
        outs = (torch.empty(N, dtype=torch.float32, device=dev),
                torch.empty((N, L, 128), dtype=torch.int32, device=dev),
                torch.empty(N, dtype=torch.int32, device=dev),
                torch.empty(N, dtype=torch.bool, device=dev))
        stream = torch.cuda.current_stream().cuda_stream
        p = [x.data_ptr() for x in ins]
        o = [x.data_ptr() for x in outs]
        if use_qv:
            rc = lib.blasr_banded_dp_qv(*p, q1.data_ptr(), q2.data_ptr(), N,
                                        L, W, float(sm[0]), *o, stream)
        else:
            rc = lib.blasr_banded_dp(*p, N, L, W, float(sm[0]), float(sm[1]),
                                     4.0, 4.0, 5.0, 5.0, *o, stream)
        assert rc == 0, f"launch failed: {rc}"
        return outs

    for use_qv in (False, True):
        ref = run(libs[0], use_qv)
        for i, lib in enumerate(libs[1:], 1):
            for a, b in zip(run(lib, use_qv), ref):
                assert torch.equal(a, b), f"{sources[i]} differs from " \
                    f"{sources[0]} (qv={use_qv})"
        in_turns(card, f"K1{'-QV' if use_qv else ''} (N={N}, L={L})",
                 sources, lambda i: run(libs[i], use_qv), reps)


def compare_k2(card, sources, reps: int = 5) -> None:
    """K2 from each given banded_traceback.cu on phase 2's inputs (K1's
    cell words at N=640, L=2048) at t_max = 3T/8 and T: every output held
    to the first source's, then timed warm and cold.  Each source's walk
    writes into one pre-zeroed pair buffer (an older walk stores only up
    to its stop), so the times are its launches alone."""
    import ctypes
    from blasr_tpu_torch.kernels.banded import pair_capacity
    from blasr_tpu_torch.kernels.pallas_banded import banded_align_cuda
    from blasr_tpu_torch.params import MappingParams
    libs = []
    for src in sources:
        lib = build_source("K2", src)[0]
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.blasr_banded_traceback.argtypes = [P] * 8 + [I] * 3 + [P] * 8
        libs.append(lib)
    N, L, W = 640, 2048, 3072
    dev = torch.device("cuda")
    ins = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
           for a in random_case(np.random.default_rng(7), N, L, W)]
    sm = np.asarray(MappingParams().make_sane().score_matrix,
                    np.float32).reshape(25)
    res = banded_align_cuda(*ins, sm, 4.0, 4.0, 5.0, 5.0)
    T = L + W
    for t_max in ((3 * T) // 8, T):
        Pc = pair_capacity(t_max)
        bufs = [(torch.zeros((N, Pc // 2), dtype=torch.int32, device=dev),
                 torch.empty((5, N), dtype=torch.int32, device=dev),
                 torch.empty(N, dtype=torch.bool, device=dev))
                for _ in libs]

        def run(i):
            pairs, counts, ovf = bufs[i]
            rc = libs[i].blasr_banded_traceback(
                res.tbbits.data_ptr(), ins[2].data_ptr(),
                *(x.data_ptr() for x in ins[3:]),
                res.final_state.data_ptr(), res.valid.data_ptr(), N, L, Pc,
                pairs.data_ptr(), *(counts[k].data_ptr() for k in range(5)),
                ovf.data_ptr(), torch.cuda.current_stream().cuda_stream)
            assert rc == 0, f"launch failed: {rc}"
            return bufs[i]

        for i in range(len(libs)):
            run(i)
        torch.cuda.synchronize()
        for i in range(1, len(libs)):
            for a, b in zip(bufs[i], bufs[0]):
                assert torch.equal(a, b), \
                    f"{sources[i]} differs from {sources[0]} (t_max={t_max})"
        for mode in ("warm", "cold"):
            in_turns(card, f"K2 (N={N}, L={L}, t_max={t_max})", sources, run,
                     reps, mode)


def compare_k3(card, sources, reps: int = 20) -> None:
    """K3 from each given chain_scan.cu on the bench batch's anchors
    (2B=64, A=512; candidate and guide passes) and at B=2, A=8192: every
    output held to the first source's, then timed in turns.  A source of
    the int32 interface (before the kernel read the mapper's int64 anchors)
    gets the anchors cast beforehand, outside the timing, and its outputs
    are widened for the comparison."""
    import ctypes
    from blasr_tpu_torch.kernels import cuda_ops
    from blasr_tpu_torch.kernels.anchor import Anchors
    from blasr_tpu_torch.kernels.chain import k3_arguments
    from torch_edge_cases import chain_rows
    libs = []
    for src in sources:
        lib, data = build_source("K3", src)
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        LL = ctypes.c_longlong
        wide = b"wide_pos" in data
        lib.blasr_chain_scan.argtypes = (
            ([P] * 3 + [I] + [P] * 3 + [I] * 5) if wide
            else ([P] * 6 + [I] * 4)) + [F] * 3 + [I, F, I, I] + [P] * 10 \
            + [P, LL] + [P]
        libs.append((lib, wide))
    cuda_ops.build()
    gi, sims = bench_world()
    bb = bench_batch(gi, sims)
    dev = torch.device("cuda")
    c = chain_rows(np.random.default_rng(8192), 2, 8192, (8192, 6000),
                   read_len=(20_000, 40_000))
    big = Anchors(**{f: torch.from_numpy(c[f]).to(dev)
                     for f in ("q", "t", "l", "valid", "nlogp")},
                  n_total=None)
    cases = [("bench candidate pass", bb["anchors"], bb["rlen2"],
              bb["chain_kw"]),
             ("bench guide pass", bb["anchors"], bb["rlen2"],
              dict(bb["chain_kw"], n_cand=1, drift_penalty=1.0)),
             ("global scratch rows", big,
              torch.from_numpy(c["read_len"]).to(dev),
              dict(n_cand=20, rank_by_pvalue=True, p_value_type=0))]
    for label, an, rl, kw in cases:
        B, A = an.q.shape
        a = k3_arguments(A, **kw)
        C = a["n_cand"]
        narrow = [x.to(torch.int32).contiguous()
                  for x in (an.q, an.t, an.l, rl)]
        row_bytes = 0
        scratch = None
        if A > cuda_ops.CHAIN_MAX_ANCHORS:
            row_bytes = -(-A * cuda_ops.CHAIN_SMEM_PER_ANCHOR // 16) * 16
            scratch = torch.empty(B * row_bytes, dtype=torch.uint8,
                                  device=dev)
        bufs = []
        for _, wide in libs:
            it = torch.int64 if wide else torch.int32
            bufs.append([torch.empty((B, C), dtype=dt, device=dev)
                         for dt in (it, it, it, it, torch.float32, it,
                                    torch.float32, torch.bool, it)]
                        + [torch.empty((B, A), dtype=it, device=dev)])

        def run(i):
            lib, wide = libs[i]
            if wide:
                pos = (an.q.data_ptr(), an.t.data_ptr(), an.l.data_ptr(), 1,
                       an.valid.data_ptr(), an.nlogp.data_ptr(),
                       rl.data_ptr(), int(rl.dtype == torch.int64))
            else:
                pos = (*(x.data_ptr() for x in narrow[:3]),
                       an.valid.data_ptr(), an.nlogp.data_ptr(),
                       narrow[3].data_ptr())
            rc = lib.blasr_chain_scan(
                *pos, B, A, a["lookback"], C, a["rate"], a["drift_frac"],
                a["drift_slack"], int(a["drift_penalty"] > 0.0),
                -float(a["drift_penalty"]), int(a["global_chain"]),
                a["rank_mode"], *(o.data_ptr() for o in bufs[i]),
                None if scratch is None else scratch.data_ptr(), row_bytes,
                torch.cuda.current_stream().cuda_stream)
            assert rc == 0, f"launch failed: {rc}"

        for i in range(len(libs)):
            run(i)
        torch.cuda.synchronize()
        ref = [x.long() if x.dtype == torch.int32 else x for x in bufs[0]]
        for i in range(1, len(libs)):
            for x, y in zip(bufs[i], ref):
                x = x.long() if x.dtype == torch.int32 else x
                assert torch.equal(x, y), \
                    f"{sources[i]} differs from {sources[0]} ({label})"
        in_turns(card, f"K3 ({label}: B={B}, A={A}, "
                 f"lookback={a['lookback']}, "
                 f"n_cand={C})", sources, run, reps if A <= 512 else 3)


def compare_k5(card, sources, reps: int = 20) -> None:
    """K5 from each given anchor_search.cu (one C interface) through the
    package's wrapper, on the bench batch's find_anchors call and on the
    long-read world's first one (L = 65536): every Anchors field held to
    the first source's, then timed in turns, the device alone and the
    call."""
    from blasr_tpu_torch.kernels import cuda_ops
    libs = [cuda_ops.bind(build_source("K5", src)[0],
                          ("blasr_anchor_search",)) for src in sources]
    cuda_ops.build()
    gi, sims = bench_world()
    bb = bench_batch(gi, sims)
    long_a, long_kw = long_read_calls("find_anchors")[0]
    for label, a, kw, n in (("bench batch", bb["anchor_args"],
                             bb["anchor_kw"], reps),
                            ("long read", long_a, long_kw, 5)):
        a = (*a[:3], a[3].contiguous(), a[4].to(torch.int32).contiguous())

        def run(i):
            return cuda_ops.anchor_search_launch(*a, **kw, lib=libs[i])

        outs = [run(i) for i in range(len(libs))]
        torch.cuda.synchronize()
        for i in range(1, len(libs)):
            check_equal(outs[i], outs[0], outs[0]._fields,
                        f"K5 from {sources[i]} ({label})")
        B, L = a[3].shape
        what = (f"K5 ({label}: B={B}, L={L}, O={kw['occ_per_pos']}, "
                f"A={outs[0].q.shape[1]})")
        for mode in ("device", "warm"):
            in_turns(card, what, sources, run, n, mode)


def band_launch_args(a, kw) -> dict:
    """A captured ``_band_offsets`` call's arguments by name, the tensors
    as the K6 wrapper takes them."""
    import inspect
    from blasr_tpu_torch.pipeline import map_read
    b = inspect.signature(map_read._band_offsets_plain).bind(*a, **kw)
    b.apply_defaults()
    x = dict(b.arguments)
    for f in ("mq", "mt", "ws", "frag_diag", "frag_valid"):
        if x[f] is not None:
            x[f] = x[f].contiguous()
    return x


def compare_k6(card, sources, reps: int = 20) -> None:
    """K6 from each given band_offsets.cu (one C interface) through the
    package's wrapper, on the two _band_offsets calls of the bench batch's
    map_batch and on the long-read world's first one (L = 65536): outputs
    held to the first source's, then timed in turns, the device alone and
    the call."""
    from blasr_tpu_torch.kernels import cuda_ops
    libs = [cuda_ops.bind(build_source("K6", src)[0],
                          ("blasr_band_offsets",)) for src in sources]
    cuda_ops.build()
    gi, sims = bench_world()
    calls = [(f"bench call {i + 1}", a, kw, reps)
             for i, (a, kw, _) in enumerate(band_calls(bench_batch(gi,
                                                                   sims)))]
    calls.append(("long read",
                  *long_read_calls("_band_offsets")[0], 5))
    for label, a, kw, n in calls:
        x = band_launch_args(a, kw)

        def run(i):
            return cuda_ops.band_offsets_launch(
                x["mq"], x["mt"], x["ws"], L=x["L"], W=x["W"], w_b=x["w_b"],
                frag_diag=x["frag_diag"], frag_valid=x["frag_valid"],
                between_only=x["between_only"], lib=libs[i])

        outs = [run(i) for i in range(len(libs))]
        torch.cuda.synchronize()
        for i in range(1, len(libs)):
            assert torch.equal(outs[i], outs[0]), \
                f"K6 from {sources[i]} differs from {sources[0]} ({label})"
        F = 0 if x["frag_diag"] is None else x["frag_diag"].shape[-1]
        what = (f"K6 ({label}: N={x['mq'].shape[0]}, L={x['L']}, F={F})")
        for mode in ("device", "warm"):
            in_turns(card, what, sources, run, n, mode)


def bench_batch(gi, sims):
    """The bench workload's first batch in bucket 2048 as
    Mapper._run_bucket forms it: the arguments of its map_batch call and of
    the find_anchors call inside it, its anchors (K5), the chain arguments
    map_batch passes and the device index."""
    from blasr_tpu_torch.kernels.anchor import find_anchors
    from blasr_tpu_torch.params import MappingParams, ShapeConfig
    from blasr_tpu_torch.pipeline.map_read import Mapper, _revcomp_batch
    L = 2048
    cfg = ShapeConfig(buckets=(1024, 2048), batch_size=32, max_anchors=512)
    mapper = Mapper(gi, MappingParams().make_sane(), cfg, device="cuda")
    batch = mapper.batch_size_for(L)
    recs = [s.rec for s in sims if cfg.bucket_for(len(s.rec.seq)) == L]
    arr = np.full((batch, L), 4, np.int8)
    lens = np.zeros(batch, np.int32)
    for i, r in enumerate(recs[:batch]):
        n = min(len(r.seq), L)
        arr[i, :n] = r.seq[:n]
        lens[i] = n
    dev = torch.device("cuda")
    reads = torch.from_numpy(arr).to(dev)
    rl = torch.from_numpy(lens).to(dev)
    reads2 = torch.cat([reads, _revcomp_batch(reads, rl)])
    rlen2 = torch.cat([rl, rl])
    pos, kw = mapper._batch_call_args(L)
    ix = mapper.dev
    anchor_args = (ix.genome, ix.keys_sorted, ix.pos_sorted, reads2, rlen2)
    anchor_kw = dict(
        k=kw["cfg_k"], occ_per_pos=kw["O"], max_anchors=kw["A"],
        anchor_ext=kw["E"], min_match=kw["min_match"],
        max_anchors_per_pos=kw["max_anchors_per_pos"],
        max_lcp=kw["max_lcp"], advance_exact=kw["advance_exact"],
        bucket_starts=ix.bucket_starts, bucket_pairs=ix.bucket_pairs,
        gwords=ix.gwords, gnwords=ix.gnwords, pos_records=ix.pos_records)
    anchors = find_anchors(*anchor_args, **anchor_kw)
    torch.cuda.synchronize()
    pvt = kw["p_value_type"]
    chain_kw = dict(n_cand=max(2 * kw["C"], 16),
                    indel_rate=kw["indel_rate"],
                    rank_by_pvalue=pvt in (0, 1, 2), p_value_type=pvt,
                    lookback=kw["lookback"],
                    global_chain=kw["global_chain"],
                    drift_penalty=kw["cand_drift"])
    return dict(anchors=anchors, rlen2=rlen2, reads2=reads2,
                chain_kw=chain_kw, ix=ix, reads=reads, rl=rl, pos=pos, kw=kw,
                anchor_args=anchor_args, anchor_kw=anchor_kw)


def anchors_bound(anchors, rlen2, kw):
    """Bound of one find_anchors call (kernels/anchor.py) on the fused
    records path: the reads read once; one 32-byte sector per LUT pair
    gather (one per read position with a k-mer) and 1.5 sectors on average
    per 24-byte occurrence record gathered (counting only the hits that
    survive, so a lower bound); the anchors (q, t, l int64, valid, nlogp),
    the raw hits (int64 position and flag per [B, L, O] slot) and two
    int32 counts per row written once.  Its sorts and compares are under
    a microsecond of the float32 peak."""
    B, L, O = anchors.hits_t.shape
    A = anchors.q.shape[1]
    kmers = float((rlen2.to(torch.int64) - kw["cfg_k"] + 1).clamp(min=0)
                  .sum())
    hits = float(anchors.hits_valid.sum())
    nbytes = (B * L + SECTOR * kmers + 1.5 * SECTOR * hits
              + B * A * 29 + B * L * O * 9 + 8 * B)
    return bound(nbytes, 0.0)


def check_equal(out, ref, fields, name: str) -> float:
    for f, a, b in zip(fields, out, ref):
        assert a.dtype == b.dtype and torch.equal(a, b), \
            f"{name}: {f} differs from the plain version"
    return max_abs(list(out), list(ref))


def capture_calls(module, name: str, calls: list):
    """Wrap ``module.name`` so that each call appends (args, kwargs,
    result) to ``calls``; returns the function to restore."""
    inner = getattr(module, name)

    def wrapper(*a, **kw):
        out = inner(*a, **kw)
        calls.append((a, kw, out))
        return out

    setattr(module, name, wrapper)
    return inner


def k3_bound(anchors, n_cand: int, lookback: int):
    """Bound of one chain_anchors call: the anchors (q, t, l int64, valid,
    nlogp) and read lengths read once, the candidates (six int64, two
    float32, one bool field) and the int64 parent pointers written once;
    the predecessor tests this call's valid anchors need, and the
    selection rounds."""
    v = anchors.valid.cpu().numpy()
    B, A = v.shape
    D = A if lookback <= 0 or lookback > A else lookback
    c = np.concatenate([np.zeros((B, 1), np.int64),
                        np.cumsum(v, axis=1, dtype=np.int64)], axis=1)
    i = np.arange(A)
    pairs = float((v * (c[:, i] - c[:, np.maximum(i - D, 0)])).sum())
    nbytes = B * A * (24 + 1 + 4 + 8) + 4 * B + B * n_cand * 57
    ops = K3_OPS_PER_PAIR * pairs + K3_OPS_PER_SELECT * n_cand * B * A
    return bound(nbytes, ops), pairs


def sdp_bench_case(gi, reads2, rlen2, rng, N=192, L=2048, W=3072):
    """K4 inputs at the main path's shapes, as
    tests/test_torch_stages.py::test_window_fragment_diags_matches_jax
    builds them: bench-genome windows with read k-mers planted on
    diagonal 260, and a second copy of read positions 900-1200 on
    diagonal 450 (second hits), guide offsets along diagonal 260."""
    from blasr_tpu_torch.kernels.anchor import read_kmer_keys
    g = np.asarray(gi.genome)
    r2 = reads2.cpu().numpy()
    l2 = rlen2.cpu().numpy()
    rows = rng.integers(0, len(r2), N)
    starts = rng.integers(0, len(g) - W, N)
    windows = np.stack([g[s:s + W] for s in starts]).astype(np.int8)
    reads = r2[rows].copy()
    windows[:, 300:1300] = reads[:, 40:1040]
    windows[:, 1350:1650] = reads[:, 900:1200]
    offs = np.clip(np.arange(L)[None, :] + 260 - 64
                   + rng.integers(-30, 30, (N, 1)), 0, W - 128)
    offs = np.maximum.accumulate(offs, axis=1)
    dev = torch.device("cuda")
    rk, rv = read_kmer_keys(torch.from_numpy(reads).to(dev),
                            torch.from_numpy(l2[rows]).to(dev), 11)
    return (rk, rv, torch.from_numpy(windows).to(dev),
            torch.full((N,), W, dtype=torch.int64, device=dev),
            torch.from_numpy(offs).to(dev))


def k4_bound(args, diag, valid, occ: int, D: int, k: int):
    """Bound of one window_fragment_diags_banded call: the read keys
    (int64) and flags, the windows, window lengths and int64 offsets read
    once, the int64 diagonals and flags written once; the window k-mer
    keys (~4 ops per base of k per position) and the compares this call's
    data needs (each position walks its slab up to its occ-th hit, or all
    of it)."""
    from blasr_tpu_torch.kernels.sdp import _diag_lo
    rk, rv, windows, wlens, offs = args
    N, L = rk.shape
    W = windows.shape[1]
    dlo = _diag_lo(offs, L, W, D, 128)
    last = diag[:, :, occ - 1] - dlo[:, None]
    walked = torch.where(valid[:, :, occ - 1], last + 1, D)
    compares = float(walked.sum())
    nbytes = N * L * (8 + 1 + 8) + N * W + 8 * N + N * L * occ * 9
    return bound(nbytes, compares + 4 * k * N * W), compares


def k6_bound(mq, mt, ws, L, W, w_b, frag_diag=None, frag_valid=None,
             between_only=False):
    """Bound of one _band_offsets call: the members (two int64 [N, MC]),
    the window starts and the fragment flags (one byte a slot) read once,
    the int64 diagonal of each slot whose flag is set (the others' do not
    change the result: this run's data, not the most it could need), the
    int64 offsets written once; ~30 integer operations per row (three
    fills, the interpolation, two scans) and ~8 per fragment slot."""
    N, MC = mq.shape
    F = 0 if frag_diag is None else frag_diag.shape[-1]
    n_set = 0 if frag_valid is None else int(frag_valid.sum())
    nbytes = 16 * N * MC + 8 * N + N * L * F + 8 * n_set + 8 * N * L
    return bound(nbytes, N * L * (30 + 8 * F))


def unported_bounds(card, bb):
    """Bounds of the two device programs of the JAX package that the port
    runs as plain torch or not at all: chain_members on the bench batch
    (its [2B*C, max_chain] member walk, timed as it runs, plain), and
    sdp_align per pair at 2 kb reads (the sdpMatcher shapes: Lq = 2048,
    Lt = round_up(2048 + 129, 128), 1024 fragments, 256 members)."""
    from blasr_tpu_torch.kernels.chain import chain_anchors, chain_members
    kw = bb["kw"]
    cands = chain_anchors(bb["anchors"], bb["rlen2"],
                          **dict(bb["chain_kw"], n_cand=kw["C"]))
    B2, A = bb["anchors"].q.shape
    C, MC = kw["C"], kw["max_chain"]
    fn = lambda: chain_members(cands, bb["anchors"], max_chain=MC)  # noqa
    fn()
    pms = cuda_ms(fn, 5)
    # end_idx and parent pointers, anchors q/t/l (int64) in; mq/mt/ml int64
    # and the valid flags out
    cm = bound(8 * B2 * C + 8 * B2 * A + 24 * B2 * A + 25 * B2 * C * MC, 0.0)
    log(f"# not ported: chain_members at [{B2 * C}, {MC}] (A={A}): plain "
        f"{pms:.3f} ms, bound {cm[0]:.5f} ms ({cm[1]}) on {card}")
    Lq, Lt, F, M = 2048, 2304, 1024, 256
    # per pair: the sequences and lengths in, the chain (7 scalars, three
    # [M] member arrays) out; K3's 20 operations per fragment pair of the
    # chain scan over F fragments
    sa = bound(Lq + Lt + 8 + 28 + 12 * M, K3_OPS_PER_PAIR * F * (F - 1) / 2)
    log(f"# not ported: sdp_align per pair (Lq={Lq}, Lt={Lt}, {F} "
        f"fragments): bound {1e3 * sa[0]:.4f} us ({sa[1]})")


def band_calls(bb) -> list:
    """The two _band_offsets calls of the bench batch's map_batch, captured
    as it makes them: [(args, kwargs, K6's offsets)]."""
    from blasr_tpu_torch.pipeline import map_read
    calls = []
    inner = capture_calls(map_read, "_band_offsets", calls)
    try:
        map_read.map_batch(bb["ix"], bb["reads"], bb["rl"], *bb["pos"],
                           **bb["kw"])
        torch.cuda.synchronize()
    finally:
        map_read._band_offsets = inner
    assert len(calls) == 2, f"map_batch made {len(calls)} band-offset calls"
    return calls


# the kernels of each wrapper as torch.profiler names them (short_name):
# (those of which a call launches exactly one, the call's other kernels)
PROFILE_KERNELS = {
    "banded_dp": (("banded_dp_kernel<false>",), ()),
    "banded_dp_qv": (("banded_dp_kernel<true>",), ()),
    "banded_traceback": (("banded_traceback_kernel",), ()),
    "chain_scan": (("chain_scan_kernel<false>", "chain_scan_kernel<true>"),
                   ()),
    "sdp_window": (("sdp_window_kernel",), ()),
    "anchor_search": (("anchor_candidates",), ("anchor_select",)),
    "band_offsets": (("band_offsets_kernel", "band_offsets_rows"), ()),
}
DEVICE_TIMES_REPS = 20


def k5k6_device_times(card) -> int:
    """The ``--device-times`` mode: phase 2's K5 call (the bench batch's
    find_anchors) and K6 calls (its map_batch's two _band_offsets calls),
    20 times each after a warm call, under one torch.profiler session of
    this process's own; prints each kernel's device ms per call as one
    JSON line (``# device-times {...}``).  0 if every launch was
    recorded."""
    from torch.profiler import ProfilerActivity, profile
    from blasr_tpu_torch.kernels import cuda_ops
    from blasr_tpu_torch.kernels.anchor import find_anchors
    from blasr_tpu_torch.pipeline import map_read
    cuda_ops.build()
    gi, sims = bench_world()
    bb = bench_batch(gi, sims)
    fns = [lambda: find_anchors(*bb["anchor_args"], **bb["anchor_kw"])]
    fns += [lambda a=a, kw=kw: map_read._band_offsets(*a, **kw)
            for a, kw, _ in band_calls(bb)]
    reps = DEVICE_TIMES_REPS
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for fn in fns:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
    evs = sorted((e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    k5, k6 = {}, []
    for e in evs:
        name, ms = short_name(e.name), e.time_range.elapsed_us() / 1e3
        if is_kernel(name, sum(PROFILE_KERNELS["anchor_search"], ())):
            k5[name] = k5.get(name, 0.0) + ms / reps
        elif is_kernel(name, PROFILE_KERNELS["band_offsets"][0]):
            k6.append(ms)
    n_k5 = sum(is_kernel(short_name(e.name),
                         PROFILE_KERNELS["anchor_search"][0]) for e in evs)
    if n_k5 != reps or len(k6) != 2 * reps:
        log(f"# device-times: torch.profiler recorded {n_k5} K5 and "
            f"{len(k6)} K6 launches of {reps} and {2 * reps} on {card}")
        return 1
    log("# device-times " + json.dumps({
        "anchor_search": k5,
        "band_offsets": [sum(k6[:reps]) / reps, sum(k6[reps:]) / reps]}))
    return 0


def run_child(flag: str):
    """This script in a child process with ``flag`` (a profiler session of
    its own, unslowed and unaffected by this process's): (exit code, its
    standard output)."""
    r = subprocess.run([sys.executable, os.path.abspath(__file__), flag],
                       capture_output=True, text=True, timeout=600, cwd=HERE)
    if r.returncode != 0:
        log(f"# child {flag} exited {r.returncode}:\n{r.stdout[-2000:]}"
            f"{r.stderr[-2000:]}")
    return r.returncode, r.stdout


def phase_anchor_band(card, bb):
    """K5 and K6 against their plain versions on the same CUDA tensors: K5
    on the bench batch's find_anchors call, K6 on the two _band_offsets
    calls of that batch's map_batch (captured as it makes them), both on
    the edge inputs."""
    from blasr_tpu_torch.index.genome import build_genome_index
    from blasr_tpu_torch.io.fasta import FastaRecord
    from blasr_tpu_torch.kernels.anchor import (Anchors, find_anchors,
                                                find_anchors_plain)
    from blasr_tpu_torch.pipeline import map_read
    from torch_edge_cases import (ANCHOR_CASES, BAND_CASES, anchor_case,
                                  anchor_world, band_case)
    dev = torch.device("cuda")
    fields = Anchors._fields
    args, akw = bb["anchor_args"], bb["anchor_kw"]
    ref = find_anchors_plain(*args, **akw)
    torch.cuda.synchronize()
    k5_err = check_equal(bb["anchors"], ref, fields, "K5 bench batch")
    k5_ms = cuda_ms(lambda: find_anchors(*args, **akw), 20)
    k5_spin = device_ms(lambda: find_anchors(*args, **akw), 20)
    k5_plain = cuda_ms(lambda: find_anchors_plain(*args, **akw), 3)
    k5_bound = anchors_bound(bb["anchors"], bb["rlen2"], bb["kw"])
    calls = band_calls(bb)
    k6_err = 0.0
    k6 = []
    for i, (a, kw, out) in enumerate(calls):
        ref = map_read._band_offsets_plain(*a, **kw)
        torch.cuda.synchronize()
        k6_err = max(k6_err, check_equal([out], [ref], ("offsets",),
                                         f"K6 call {i + 1}"))
        kms = cuda_ms(lambda: map_read._band_offsets(*a, **kw), 20)
        spin = device_ms(lambda: map_read._band_offsets(*a, **kw), 20)
        pms = cuda_ms(lambda: map_read._band_offsets_plain(*a, **kw), 3)
        k6.append((kms, pms, k6_bound(*a, **kw), spin))

    # each kernel's own device time on the same calls, by torch.profiler
    # in a child process
    rc, out = run_child("--device-times")
    dt = None
    for line in out.splitlines():
        if line.startswith("# device-times "):
            dt = json.loads(line[len("# device-times "):])
    assert rc == 0 and dt is not None, "--device-times recorded nothing"
    k5_dev = sum(dt["anchor_search"].values())
    B, L, O = bb["anchors"].hits_t.shape
    log(f"# K5 == plain on the bench batch (B={B}, L={L}, O={O}, "
        f"A={bb['anchors'].q.shape[1]}): every field exact, "
        f"{int(bb['anchors'].valid.sum())} valid anchors; call "
        f"{k5_ms:.4f} ms (events around 20 back to back), device "
        + " + ".join(f"{k} {v:.4f}" for k, v in dt["anchor_search"].items())
        + f" = {k5_dev:.4f} ms (torch.profiler), {k5_spin:.4f} ms behind a "
        f"spin (events), host share of the call "
        f"{max(0.0, 1 - k5_dev / k5_ms):.2f}; plain {k5_plain:.3f} ms, "
        f"bound {k5_bound[0]:.4f} ms ({k5_bound[1]}) on {card}")
    for i, ((a, kw, _), (kms, pms, kb, spin)) in enumerate(zip(calls, k6)):
        dev_ms = dt["band_offsets"][i]
        k6[i] = (kms, pms, kb, dev_ms)
        log(f"# K6 == plain on map_batch's call {i + 1} (N={a[0].shape[0]}, "
            f"MC={a[0].shape[1]}, L={a[3]}, F={a[6].shape[-1]}): exact; "
            f"call {kms:.4f} ms (events around 20 back to back), device "
            f"{dev_ms:.4f} ms (torch.profiler), {spin:.4f} ms behind a spin "
            f"(events), host share {max(0.0, 1 - dev_ms / kms):.2f}; plain "
            f"{pms:.3f} ms, bound {kb[0]:.4f} ms ({kb[1]}) on {card}")

    gi = build_genome_index([FastaRecord("edge", anchor_world()[0])], k=12)
    eix = map_read.DeviceIndex.from_host(gi, dev)
    for name in ANCHOR_CASES:
        _, reads, rlen, kw, drop = anchor_case(name)
        ix = eix._replace(**{f: None for f in drop})
        a = (ix.genome, ix.keys_sorted, ix.pos_sorted,
             torch.from_numpy(reads).to(dev), torch.from_numpy(rlen).to(dev))
        kw = dict(kw, bucket_starts=ix.bucket_starts,
                  bucket_pairs=ix.bucket_pairs, gwords=ix.gwords,
                  gnwords=ix.gnwords, pos_records=ix.pos_records)
        k5_err = max(k5_err, check_equal(find_anchors(*a, **kw),
                                         find_anchors_plain(*a, **kw),
                                         fields, f"K5 {name}"))
    log(f"# K5 == plain on the {len(ANCHOR_CASES)} edge inputs: exact")
    for name in BAND_CASES:
        c = band_case(name)
        a = [None if c[f] is None else torch.from_numpy(c[f]).to(dev)
             for f in ("mq", "mt", "ws", "frag_diag", "frag_valid")]
        a = (*a[:3], c["L"], c["W"], c["w_b"], *a[3:], c["between_only"])
        k6_err = max(k6_err, check_equal(
            [map_read._band_offsets(*a)], [map_read._band_offsets_plain(*a)],
            ("offsets",), f"K6 {name}"))
    log(f"# K6 == plain on the {len(BAND_CASES)} edge inputs: exact")
    unported_bounds(card, bb)
    kms, pms, kb, dev_ms = k6[0]
    return {
        "anchor_search": dict(err=k5_err, ms=k5_ms, plain_ms=k5_plain,
                              bound=k5_bound, device_ms=k5_dev),
        "band_offsets": dict(err=k6_err, ms=kms, plain_ms=pms, bound=kb,
                             device_ms=dev_ms),
    }


def phase_chain_sdp(card, gi, bb):
    """K3 and K4 against their plain versions on the same CUDA tensors."""
    from blasr_tpu_torch.kernels import chain, sdp
    from blasr_tpu_torch.kernels.anchor import Anchors
    from torch_edge_cases import (CHAIN_CASES, K_SDP, SDP_CASES,
                                  chain_case, chain_rows, long_sdp_case,
                                  sdp_case)
    from blasr_tpu_torch.kernels.anchor import read_kmer_keys
    dev = torch.device("cuda")
    anchors, rlen2, reads2, ckw = (bb[k] for k in ("anchors", "rlen2",
                                                   "reads2", "chain_kw"))
    B, A = anchors.q.shape
    log(f"# phase 2 K3: bench batch B={B} A={A}, "
        f"{int(anchors.valid.sum())} valid anchors")
    fields = chain.Candidates._fields
    res = {}
    k3_err = 0.0
    for label, kw in (("candidate", ckw),
                      ("guide", dict(ckw, n_cand=1, drift_penalty=1.0)),
                      ("lookback64-global",
                       dict(ckw, lookback=64, global_chain=True))):
        out = chain.chain_anchors(anchors, rlen2, **kw)
        torch.cuda.synchronize()
        ref = chain.chain_anchors_plain(anchors, rlen2, **kw)
        torch.cuda.synchronize()
        k3_err = max(k3_err, check_equal(out, ref, fields, f"K3 {label}"))
        kms = cuda_ms(lambda: chain.chain_anchors(anchors, rlen2, **kw), 20)
        pms = cuda_ms(lambda: chain.chain_anchors_plain(anchors, rlen2,
                                                        **kw), 1)
        kb, pairs = k3_bound(anchors, kw["n_cand"], kw["lookback"])
        res[label] = (kms, pms, kb)
        log(f"# K3 == plain ({label}: n_cand={kw['n_cand']}, "
            f"lookback={kw['lookback']}, global={kw['global_chain']}, "
            f"drift_penalty={kw['drift_penalty']}): exact, "
            f"{int(out.valid.sum())} valid candidates; kernel {kms:.3f} ms "
            f"({1e3 * kms / (A + kw['n_cand']):.3f} us per dependent step), "
            f"plain {pms:.1f} ms, bound {kb[0]:.4f} ms ({kb[1]}; "
            f"{pairs:.0f} predecessor tests) on {card}")
    for name in CHAIN_CASES:
        c, kw = chain_case(name)
        an = Anchors(**{f: torch.from_numpy(c[f]).to(dev)
                        for f in ("q", "t", "l", "valid", "nlogp")},
                     n_total=torch.from_numpy(
                         c["valid"].sum(1).astype(np.int32)).to(dev))
        rl = torch.from_numpy(c["read_len"]).to(dev)
        out = chain.chain_anchors(an, rl, **kw)
        ref = chain.chain_anchors_plain(an, rl, **kw)
        k3_err = max(k3_err, check_equal(out, ref, fields, f"K3 {name}"))
    log(f"# K3 == plain on the {len(CHAIN_CASES)} edge inputs: exact")

    rng = np.random.default_rng(31)
    args = sdp_bench_case(gi, reads2, rlen2, rng)
    N, L = args[0].shape
    k4 = {}
    k4_err = 0.0
    for occ in (2, 1):
        kw = dict(k=K_SDP, occ=occ)
        out = sdp.window_fragment_diags_banded(*args, **kw)
        torch.cuda.synchronize()
        ref = sdp.window_fragment_diags_banded_plain(*args, **kw)
        torch.cuda.synchronize()
        k4_err = max(k4_err, check_equal(out, ref, ("diag", "valid"),
                                         f"K4 occ={occ}"))
        assert out[1][..., 0].sum() > N * 500, "too few planted hits"
        if occ == 2:
            assert out[1][..., 1].any(), "no second hits"
        kms = cuda_ms(lambda: sdp.window_fragment_diags_banded(*args, **kw),
                      20)
        pms = cuda_ms(lambda: sdp.window_fragment_diags_banded_plain(
            *args, **kw), 1)
        kb, compares = k4_bound(args, *out, occ, 512, K_SDP)
        k4[occ] = (kms, pms, kb)
        log(f"# K4 == plain (N={N}, L={L}, W={args[2].shape[1]}, D=512, "
            f"occ={occ}): exact, {int(out[1].sum())} hits; "
            f"window_fragment_diags_banded (one launch) {kms:.4f} ms, plain "
            f"{pms:.1f} ms, bound {kb[0]:.4f} ms ({kb[1]}; {compares:.0f} "
            f"compares) on {card}")
    for name in SDP_CASES:
        reads, rlen, windows, wlens, offs, occ, k = sdp_case(name)
        rk, rv = read_kmer_keys(torch.from_numpy(reads).to(dev),
                                torch.from_numpy(rlen).to(dev), k)
        a = (rk, rv, *(torch.from_numpy(x).to(dev)
                       for x in (windows, wlens, offs)))
        out = sdp.window_fragment_diags_banded(*a, k=k, occ=occ)
        ref = sdp.window_fragment_diags_banded_plain(*a, k=k, occ=occ)
        k4_err = max(k4_err, check_equal(out, ref, ("diag", "valid"),
                                         f"K4 {name}"))
    log(f"# K4 == plain on the {len(SDP_CASES)} edge inputs: exact")

    # the repaired shapes: K3 past one block's shared memory (the rows'
    # arrays in global scratch), K4 at bucket 65536 (the slab tiled)
    c = chain_rows(np.random.default_rng(8192), 2, 8192, (8192, 6000),
                   read_len=(20_000, 40_000))
    an = Anchors(**{f: torch.from_numpy(c[f]).to(dev)
                    for f in ("q", "t", "l", "valid", "nlogp")},
                 n_total=torch.from_numpy(
                     c["valid"].sum(1).astype(np.int32)).to(dev))
    rl = torch.from_numpy(c["read_len"]).to(dev)
    kw = dict(n_cand=20, rank_by_pvalue=True, p_value_type=0)
    out, kms = timed(lambda: chain.chain_anchors(an, rl, **kw))
    ref, pms = timed(lambda: chain.chain_anchors_plain(an, rl, **kw))
    k3_err = max(k3_err, check_equal(out, ref, fields, "K3 A=8192"))
    log(f"# K3 == plain at B=2, A=8192 (global scratch rows): exact; kernel "
        f"{kms:.3f} ms, plain {pms:.1f} ms on {card}")
    reads, rlen, windows, wlens, offs = long_sdp_case(
        np.random.default_rng(65536))
    rk, rv = read_kmer_keys(torch.from_numpy(reads).to(dev),
                            torch.from_numpy(rlen).to(dev), K_SDP)
    a = (rk, rv, *(torch.from_numpy(x).to(dev)
                   for x in (windows, wlens, offs)))
    for occ in (2, 1):
        out = sdp.window_fragment_diags_banded(*a, k=K_SDP, occ=occ)
        torch.cuda.synchronize()
        ref, pms = timed(lambda: sdp.window_fragment_diags_banded_plain(
            *a, k=K_SDP, occ=occ))
        k4_err = max(k4_err, check_equal(out, ref, ("diag", "valid"),
                                         f"K4 L=65536 occ={occ}"))
        kms = cuda_ms(lambda: sdp.window_fragment_diags_banded(
            *a, k=K_SDP, occ=occ), 10)
        kb, compares = k4_bound(a, *out, occ, 512, K_SDP)
        log(f"# K4 == plain at N=4, L=65536, W={windows.shape[1]}, D=512, "
            f"occ={occ} (a row over {-(-65536 // 1024)} CTAs): exact, "
            f"{int(out[1].sum())} hits; function (one launch) {kms:.4f} ms, "
            f"plain {pms:.1f} ms, bound {kb[0]:.4f} ms ({kb[1]}) on {card}")
    kms, pms, kb = res["candidate"]
    return {
        "chain_scan": dict(err=k3_err, ms=kms, plain_ms=pms, bound=kb),
        "sdp_window": dict(err=k4_err, ms=k4[2][0], plain_ms=k4[2][1],
                           bound=k4[2][2]),
    }


def count_k4_kernels(card) -> int:
    """The ``--k4-kernels`` mode: torch.profiler over one call of K4's
    function at the bench shape (N=192, L=2048, W=3072; sdp_bench_case's
    windows and planted read k-mers on a random genome); 0 if it issued
    exactly one CUDA kernel, K4."""
    from types import SimpleNamespace
    from blasr_tpu_torch.kernels import sdp
    rng = np.random.default_rng(31)
    genome = rng.integers(0, 4, 1_000_000).astype(np.int8)
    reads2 = torch.from_numpy(
        rng.integers(0, 4, (64, 2048)).astype(np.int8)).cuda()
    rlen2 = torch.full((64,), 2048, dtype=torch.int32, device="cuda")
    args = sdp_bench_case(SimpleNamespace(genome=genome), reads2, rlen2, rng)
    kernels = profiled_kernels(
        lambda: sdp.window_fragment_diags_banded(*args, k=11, occ=2))
    N, L = args[0].shape
    log(f"# K4: torch.profiler counts {len(kernels)} CUDA kernel(s) in one "
        f"window_fragment_diags_banded call at N={N}, L={L}: {kernels} on "
        f"{card}")
    return 0 if len(kernels) == 1 and "sdp_window" in kernels[0] else 1


def check_k4_one_kernel() -> None:
    """K4's function must issue exactly one CUDA kernel: counted by
    ``count_k4_kernels`` in a child process (here a process's third
    profiler session recorded no device events in one run)."""
    rc, out = run_child("--k4-kernels")
    for line in out.splitlines():
        if line.startswith("# K4:"):
            log(line)
    assert rc == 0, "K4's function did not issue one K4 launch"


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
    return os.path.join(d, "reads.fa"), os.path.join(d, "genome.fa"), []


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
            os.path.join(d, "genome_big.fa"), [])


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
    return path, os.path.join(d, "genome_fq.fa"), []


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
    return path, os.path.join(d, "genome_hp.fa"), []


def make_small_bwt(d, small):
    """tests/test_golden.py::make_small_bwt's --bwt input, built with the
    port's own BWT code (the JAX test makes it with sawriter and sa2bwt;
    either BWT inverts to the same genome)."""
    from blasr_tpu_torch.index.bwt import build_bwt, save_bwt
    from blasr_tpu_torch.index.genome import concat_contigs
    from blasr_tpu_torch.io.fasta import read_fasta
    reads, genome, _ = small
    codes, seqdb = concat_contigs(read_fasta(genome))
    bwt, counts = build_bwt(codes)
    save_bwt(os.path.join(d, "genome.bwt"), bwt, counts, seqdb.names,
             seqdb.lengths)
    return reads, genome, ["--bwt", os.path.join(d, "genome.bwt.npz")]


def make_zmw(d):
    """tests/test_golden.py::make_zmw (copied): one ZMW of four subreads
    over a 600 b insert, alternating strands, and a one-subread ZMW."""
    from blasr_tpu_torch.io.fasta import FastaRecord, revcomp, write_fasta
    from blasr_tpu_torch.sim import mutate, random_genome
    rng = np.random.default_rng(901)
    contigs = random_genome(80_000, seed=900)
    g = contigs[0].seq
    insert = g[30_000:30_600]
    recs = []
    pos = 0
    for p in range(4):
        frag = insert if p % 2 == 0 else revcomp(insert)
        sub = mutate(frag, rng, 0.03, 0.07, 0.04)
        recs.append(FastaRecord(f"mov/7/{pos}_{pos + len(sub)}", sub))
        pos += len(sub) + 40
    sub2 = mutate(g[60_000:60_500], rng, 0.03, 0.07, 0.04)
    recs.append(FastaRecord(f"mov/9/0_{len(sub2)}", sub2))
    write_fasta(os.path.join(d, "genome_zmw.fa"), contigs)
    write_fasta(os.path.join(d, "reads_zmw.fa"), recs)
    return (os.path.join(d, "reads_zmw.fa"),
            os.path.join(d, "genome_zmw.fa"), [])


def make_dataset(d):
    """tests/test_golden.py::make_dataset (copied): a subreadset XML over
    FASTA reads with a length >= 300 filter."""
    from blasr_tpu_torch.io.fasta import FastaRecord, write_fasta
    from blasr_tpu_torch.sim import random_genome, simulate_reads
    contigs = random_genome(40_000, seed=6661)
    sims = simulate_reads(contigs, 8, read_len=(150, 700), accuracy=0.88,
                          seed=6662)
    recs = [FastaRecord(f"movie/{i}/0_{len(s.rec.seq)}", s.rec.seq)
            for i, s in enumerate(sims)]
    write_fasta(os.path.join(d, "ds_reads.fa"), recs)
    write_fasta(os.path.join(d, "genome_ds.fa"), contigs)
    xml = os.path.join(d, "ds.subreadset.xml")
    with open(xml, "w") as f:
        f.write("""<?xml version="1.0" encoding="utf-8"?>
<pbds:SubreadSet xmlns:pbbase="http://pacificbiosciences.com/PacBioBaseDataModel.xsd"
  xmlns:pbds="http://pacificbiosciences.com/PacBioDatasets.xsd">
  <pbbase:ExternalResources>
    <pbbase:ExternalResource ResourceId="ds_reads.fa"/>
  </pbbase:ExternalResources>
  <pbds:Filters>
    <pbds:Filter>
      <pbbase:Properties>
        <pbbase:Property Name="length" Value="300" Operator="&gt;="/>
      </pbbase:Properties>
    </pbds:Filter>
  </pbds:Filters>
</pbds:SubreadSet>
""")
    return xml, os.path.join(d, "genome_ds.fa"), []


def make_fofn(d, small):
    """tests/test_golden.py::make_fofn (copied): a FOFN naming two FASTA
    parts of the small world's reads."""
    from blasr_tpu_torch.io.fasta import read_fasta, write_fasta
    reads, genome, _ = small
    recs = read_fasta(reads)
    p1 = os.path.join(d, "fofn_part1.fa")
    p2 = os.path.join(d, "fofn_part2.fa")
    write_fasta(p1, recs[:7])
    write_fasta(p2, recs[7:])
    fofn = os.path.join(d, "reads.fofn")
    with open(fofn, "w") as f:
        f.write(p1 + "\n" + p2 + "\n")
    return fofn, genome, []


def make_bamin(d, small):
    """tests/test_golden.py::make_bamin (copied): the small world's reads as
    an unaligned BAM."""
    from blasr_tpu_torch.io.bam import BamRecord, BamWriter
    from blasr_tpu_torch.io.fasta import read_fasta
    reads, genome, _ = small
    bam = os.path.join(d, "reads_in.bam")
    with open(bam, "wb") as f:
        w = BamWriter(f, "@HD\tVN:1.5\tSO:unknown\n", [], [])
        for r in read_fasta(reads):
            w.write_record(BamRecord(r.name, 4, -1, -1, 255, [],
                                     r.seq, None))
        w.close()
    return bam, genome, []


def make_unal(d):
    """tests/test_golden.py::make_unal (copied): six reads and two
    unmappable junk reads."""
    from blasr_tpu_torch.io.fasta import FastaRecord, write_fasta
    from blasr_tpu_torch.sim import random_genome, simulate_reads
    contigs = random_genome(60_000, seed=881, n_contigs=2)
    sims = simulate_reads(contigs, 6, read_len=(300, 800), accuracy=0.87,
                          seed=882)
    recs = [FastaRecord(f"movie/{i}/0_{len(s.rec.seq)}", s.rec.seq)
            for i, s in enumerate(sims)]
    rng = np.random.default_rng(883)
    for j in range(2):
        junk = rng.integers(0, 4, 450).astype(np.int8)
        recs.append(FastaRecord(f"movie/{90 + j}/0_450", junk))
    write_fasta(os.path.join(d, "genome_un.fa"), contigs)
    write_fasta(os.path.join(d, "reads_un.fa"), recs)
    return (os.path.join(d, "reads_un.fa"),
            os.path.join(d, "genome_un.fa"), [])


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
        reads, genome, extra = worlds[world]
        out = os.path.join(d, f"out.{name}")
        flags = [f.replace("@D@", d) for f in flags]
        t0 = time.time()
        rc = run([reads, genome, "--out", out, "--device", "cuda"] + extra
                 + flags)
        assert rc == 0, f"CLI exit {rc} for {name}"
        text = open(out).read()
        if "--unaligned" in flags:
            unal = flags[flags.index("--unaligned") + 1]
            text += "== unaligned ==\n" + open(unal).read()
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


# the kernels both DP modes' paths launch
PATH_KERNELS = ("banded_traceback", "chain_scan", "sdp_window",
                "anchor_search", "band_offsets")


def phase_goldens(d, cuda_ops):
    small = make_small(d)
    worlds = {"small": small, "big": make_big(d), "fastq": make_fastq(d),
              "hpstr": make_hpstr(d), "small_bwt": make_small_bwt(d, small),
              "fofn": make_fofn(d, small), "bamin": make_bamin(d, small),
              "dataset": make_dataset(d), "unal": make_unal(d),
              "zmw": make_zmw(d)}
    dist = PATH_KERNELS + ("banded_dp",)
    # (label, cases, kernels it must launch, kernel it must not launch);
    # the flags are tests/test_golden.py's
    for label, cases, needed, unused in (
            ("main path", [("m4", "small", ["-m", "4"]),
                           ("sam", "small", ["--sam", "--clipping", "soft"]),
                           ("m4.big", "big", ["-m", "4"]),
                           ("sam.big", "big",
                            ["--sam", "--clipping", "soft"]),
                           # the chain scan with a finite lookback (64) and
                           # the aggressive interval cut
                           ("m4.fastmax", "big", ["-m", "4",
                                                  "--fastMaxInterval"]),
                           ("m4.aggressive", "big",
                            ["-m", "4", "--aggressiveIntervalCut"])],
             dist, "banded_dp_qv"),
            ("--useQuality", [("m4.fastq", "fastq",
                               ["-m", "4", "--useQuality"]),
                              ("sam.fastq", "fastq",
                               ["--sam", "--clipping", "soft",
                                "--useQuality"]),
                              ("sam.hpstr.qv", "hpstr",
                               ["--sam", "--clipping", "soft",
                                "--useQuality"])],
             PATH_KERNELS + ("banded_dp_qv",), "banded_dp"),
            # the small world's other output formats and mapping flags
            # (m4.scores: gap costs 6 / 7, K1 off its default costs)
            ("small world: formats and flags",
             [("m0", "small", ["-m", "0"]), ("m1", "small", ["-m", "1"]),
              ("m2", "small", ["-m", "2"]), ("m3", "small", ["-m", "3"]),
              ("m5", "small", ["-m", "5"]),
              ("sam.hard", "small", ["--sam", "--clipping", "hard"]),
              ("sam.subread", "small", ["--sam", "--clipping", "subread"]),
              ("m4.rb", "small", ["-m", "4", "--hitPolicy", "randombest",
                                  "--randomSeed", "1"]),
              ("m4.scores", "small", ["-m", "4", "--match", "-2",
                                      "--mismatch", "3", "--insertion", "6",
                                      "--deletion", "7"]),
              ("m4.filter", "small", ["-m", "4", "--minPctSimilarity", "82",
                                      "--minAlnLength", "500"])],
             dist, "banded_dp_qv"),
            ("other inputs",
             [("m4.bwt", "small_bwt", ["-m", "4"]),
              ("m4.fofn", "fofn", ["-m", "4"]),
              ("m4.bamin", "bamin", ["-m", "4"]),
              ("m4.xml", "dataset", ["-m", "4"]),
              ("m4.unal", "unal", ["-m", "4", "--unaligned",
                                   "@D@/unal.txt"]),
              ("m4.unal.names", "unal", ["-m", "4", "--unaligned",
                                         "@D@/unal2.txt",
                                         "--noPrintUnalignedSeqs"])],
             dist, "banded_dp_qv"),
            ("concordant", [("m4.concordant", "zmw",
                             ["-m", "4", "--concordant", "--bestn", "1"])],
             dist, "banded_dp_qv")):
        cuda_ops.reset_launch_counts()
        if label == "concordant":
            with mini_index_clocks() as clocks:
                n_ok = run_goldens(d, cases, worlds)
            report_mini_index(clocks)
        else:
            n_ok = run_goldens(d, cases, worlds)
        launches = dict(cuda_ops.LAUNCHES)
        log(f"# goldens ({label}) identical: {n_ok}/{len(cases)}; "
            f"launches {launches}")
        assert n_ok == len(cases), f"golden outputs differ ({label})"
        assert all(launches[k] > 0 for k in needed), \
            f"kernels not launched ({label}): {launches}"
        assert launches[unused] == 0, f"the {label} path launched {unused}"


@contextlib.contextmanager
def mini_index_clocks():
    """Times each DeviceIndex.from_host call (upload and derive, the card
    synchronised around it) and each host build of a concordant mini index
    (zmw's build_genome_index and _pad_mini_index) while the block runs:
    {"upload": [(genome bases, index slots, s)], "host": [s]}."""
    from blasr_tpu_torch.pipeline import map_read, zmw
    clocks = {"upload": [], "host": []}
    upload, build = map_read.DeviceIndex.from_host, zmw.build_genome_index

    def timed_upload(gi, device):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = upload(gi, device)
        torch.cuda.synchronize()
        clocks["upload"].append((len(gi.genome), len(gi.pos_sorted),
                                 time.perf_counter() - t0))
        return out

    def timed_build(*a, **kw):
        t0 = time.perf_counter()
        out = build(*a, **kw)
        clocks["host"].append(time.perf_counter() - t0)
        return out

    map_read.DeviceIndex.from_host = staticmethod(timed_upload)
    zmw.build_genome_index = timed_build
    try:
        yield clocks
    finally:
        map_read.DeviceIndex.from_host = staticmethod(upload)
        zmw.build_genome_index = build


def report_mini_index(clocks):
    """Logs the concordant run's index set-up: the genome's upload, then
    the mini index's host build and upload (k = 12: the 4^12 + 1 LUT and
    its pair table)."""
    assert len(clocks["upload"]) == 2 and len(clocks["host"]) == 1, clocks
    (g0, m0, s0), (g1, m1, s1) = clocks["upload"]
    host = clocks["host"][0]
    log(f"# concordant set-up: genome index upload {g0} b, {m0} slots "
        f"{s0 * 1e3:.3f} ms; mini index: host build {host * 1e3:.3f} ms, "
        f"upload {g1} b (padded), {m1} slots {s1 * 1e3:.3f} ms")


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


def modes_world(d):
    """tests/test_onegap.py::test_cli_onegap_spliced_read's world (copied:
    a 600 b read of 300 b + 300 b from loci 4 kb apart) with
    tests/test_torch_modes.py::noisy_end_reads's six reads (copied: ~700 b
    with noisy heads and tails, two of which align from past their start
    until --extend grows them)."""
    from blasr_tpu_torch.io.fasta import FastaRecord, write_fasta
    from blasr_tpu_torch.sim import mutate, random_genome
    contigs = random_genome(60_000, seed=201)
    g = contigs[0].seq
    recs = [FastaRecord("spliced/1/0_600", np.concatenate(
        [g[10_000:10_300], g[14_300:14_600]]))]
    rng = np.random.default_rng(53)
    for i, (head, tail) in enumerate(((0.3, 0.3), (0.25, 0.25),
                                      (0.35, 0.2), (0.2, 0.35), (0.3, 0.0),
                                      (0.4, 0.4))):
        s = 5000 + 7000 * i
        parts = [mutate(g[s:s + 150], rng, 0.4 * head, 0.3 * head,
                        0.3 * head),
                 mutate(g[s + 150:s + 550], rng, 0.02, 0.02, 0.02),
                 mutate(g[s + 550:s + 700], rng, 0.4 * tail, 0.3 * tail,
                        0.3 * tail)]
        recs.append(FastaRecord(f"noisy/{i}/0_700",
                                np.concatenate(parts).astype(np.int8)))
    write_fasta(os.path.join(d, "g_modes.fa"), contigs)
    write_fasta(os.path.join(d, "r_modes.fa"), recs)
    return os.path.join(d, "r_modes.fa"), os.path.join(d, "g_modes.fa")


def cli_output(d, world, flags, device, tag):
    """The port's CLI on ``world`` with ``flags`` on ``device``: the text
    (SAM without @PG), or the decoded records of a BAM."""
    from blasr_tpu_torch.cli.blasr import run
    from blasr_tpu_torch.io.bam import read_bam
    out = os.path.join(d, f"mode.{tag}.{device}")
    assert run(list(world) + ["--out", out, "--device", device]
               + flags) == 0, f"CLI exit for {tag} on {device}"
    if "--bam" in flags:
        text, names, lengths, recs = read_bam(out)
        head = [l for l in text.splitlines() if not l.startswith("@PG")]
        return head, names, lengths, [
            (r.qname, r.flag, r.ref_id, r.pos, r.mapq, r.cigar,
             r.seq.tolist(), None if r.qual is None else r.qual.tolist(),
             r.tags, r.next_ref_id, r.next_pos) for r in recs]
    return "".join(l for l in open(out) if not l.startswith("@PG"))


def phase_modes(d, cuda_ops):
    """--onegap with --bam, and --extend, through the port's CLI on the
    card, each held to the same run with ``--device cpu`` (decoded BAM
    records, m4 text): the spliced read joined over its 4 kb gap, the BAM
    records equal to the card's --sam output of the same flags, the noisy
    reads' alignments grown by the extension (against the card's run
    without it); then the --anchors and --clusters dumps of the small
    world, card == cpu."""
    world = modes_world(d)
    onegap = ["--onegap", "--bestn", "2", "--hitPolicy", "all"]
    cuda_ops.reset_launch_counts()
    card = {}
    for tag, flags in (("onegap", ["--bam", "--clipping", "soft"] + onegap),
                       ("extend", ["-m", "4", "--extend"])):
        t0 = time.time()
        card[tag] = cli_output(d, world, flags, "cuda", tag)
        t1 = time.time()
        on_cpu = cli_output(d, world, flags, "cpu", tag)
        log(f"# {' '.join(flags)}: cuda == cpu: {card[tag] == on_cpu} "
            f"(cuda {t1 - t0:.1f}s, cpu {time.time() - t1:.1f}s)")
        assert card[tag] == on_cpu, f"--{tag} output differs, cuda vs cpu"
    names, recs = card["onegap"][1::2]
    assert any(("N", 4000) in r[5] for r in recs), \
        "--onegap joined no spliced pair"
    sam = [l.split("\t") for l in cli_output(
        d, world, ["--sam", "--clipping", "soft"] + onegap, "cuda",
        "sam").splitlines() if not l.startswith("@")]
    assert len(recs) == len(sam) > 0
    for r, f in zip(recs, sam):
        assert (r[0], r[1], names[r[2]], r[3] + 1, r[4]) == (
            f[0], int(f[1]), f[2], int(f[3]), int(f[4]))
        assert "".join(f"{n}{op}" for op, n in r[5]) == f[5]
    grown = set(card["extend"].splitlines()) - set(cli_output(
        d, world, ["-m", "4"], "cuda", "noext").splitlines())
    assert grown, "--extend grew no alignment"
    log(f"# --onegap --bam: {len(recs)} records with a 4000N join, equal "
        f"to the --sam output; --extend changed {len(grown)} m4 line(s)")
    launches = dict(cuda_ops.LAUNCHES)
    log(f"# modes: launches {launches}")
    assert all(launches[k] > 0 for k in PATH_KERNELS + ("banded_dp",)), \
        f"kernels not launched (modes): {launches}"
    # the dumps run on every read before the mapping; --minReadLength
    # leaves nothing to map, so the run is the dumps alone
    reads, genome, _ = make_small(d)
    dumps = {}
    for device in ("cuda", "cpu"):
        cuda_ops.reset_launch_counts()
        t0 = time.time()
        files = [os.path.join(d, f"{n}.{device}.txt")
                 for n in ("anchors", "clusters")]
        cli_output(d, (reads, genome), [
            "--anchors", files[0], "--clusters", files[1],
            "--minReadLength", "1000000"], device, "dumps")
        dumps[device] = [open(f).read() for f in files]
        launches = dict(cuda_ops.LAUNCHES)
        log(f"# --anchors/--clusters on {device}: "
            f"{[x.count(chr(10)) for x in dumps[device]]} lines, "
            f"{time.time() - t0:.1f}s; launches {launches}")
        assert (launches["anchor_search"] > 0) == (device == "cuda") \
            and (launches["chain_scan"] > 0) == (device == "cuda") \
            and launches["banded_dp"] == 0, launches
    assert dumps["cuda"] == dumps["cpu"], "the dumps differ, cuda vs cpu"
    assert all(x.count("\n") > 1 for x in dumps["cuda"])


def long_read_world():
    """Two simulated reads of ~40 kb at 85% accuracy on a 1 Mbp genome
    (seeds 40, 41) and the CLI's Mapper for them on the card (the default
    ShapeConfig: bucket 65536)."""
    from blasr_tpu_torch.index.genome import build_genome_index
    from blasr_tpu_torch.params import MappingParams, ShapeConfig
    from blasr_tpu_torch.pipeline.map_read import Mapper
    from blasr_tpu_torch.sim import random_genome, simulate_reads
    contigs = random_genome(1_000_000, seed=40)
    gi = build_genome_index(contigs, k=12)
    sims = simulate_reads(contigs, 2, read_len=(38_000, 42_000),
                          accuracy=0.85, seed=41)
    cfg = ShapeConfig()
    assert all(cfg.bucket_for(len(s.rec.seq)) == 65536 for s in sims)
    return sims, Mapper(gi, MappingParams().make_sane(), cfg, device="cuda")


def hundred_kb_read():
    """One simulated read of ~100 kb at 85% accuracy on the long-read
    world's 1 Mbp genome (seed 42): two segments at bucket 65536."""
    from blasr_tpu_torch.sim import random_genome, simulate_reads
    contigs = random_genome(1_000_000, seed=40)
    return simulate_reads(contigs, 1, read_len=(100_000, 100_000),
                          accuracy=0.85, seed=42)[0]


def check_placed(s, alns, what: str):
    """The best alignment of simulated read ``s`` lies on its interval and
    strand; returns it."""
    assert alns, f"{what} did not map"
    best = min(alns, key=lambda a: a.score)
    span = best.qend - best.qstart
    log(f"# {what}: {len(s.rec.seq)} b, simulated strand {s.strand} "
        f"[{s.tstart}, {s.tend}): mapped strand {best.strand} "
        f"[{best.tstart}, {best.tend}), q [{best.qstart}, {best.qend}), "
        f"span {span / len(s.rec.seq):.4f} of the read, score {best.score}")
    assert (best.strand == s.strand and best.tstart < s.tend
            and best.tend > s.tstart), f"{what} is misplaced"
    return best


def long_read_calls(name: str) -> list:
    """The calls of ``map_read.<name>`` that mapping the long-read world's
    first read makes: [(args, kwargs)]."""
    from blasr_tpu_torch.pipeline import map_read
    sims, mapper = long_read_world()
    calls = []
    inner = capture_calls(map_read, name, calls)
    try:
        mapper.map_reads([sims[0].rec])
        torch.cuda.synchronize()
    finally:
        setattr(map_read, name, inner)
    return [(a, kw) for a, kw, _ in calls]


def phase_long_reads(card, cuda_ops):
    """Two simulated reads of ~40 kb on a 1 Mbp genome mapped on the card
    through the CLI's Mapper (bucket 65536: K4's tiled slab, K5 and K6 at
    L = 65536), then a ~100 kb read, longer than the largest bucket, which
    takes map_long_reads (two segments at bucket 65536, stitched): each
    read's best alignment lies on its simulated interval and strand.
    Every banded_traceback, window_fragment_diags_banded, find_anchors and
    _band_offsets call of the run is captured, and its kernel's result
    held to the plain version on the same CUDA tensors (K6's rows in its
    global scratch there)."""
    from blasr_tpu_torch.kernels.anchor import Anchors, find_anchors_plain
    from blasr_tpu_torch.pipeline import map_read
    t0 = time.time()
    sims, mapper = long_read_world()
    long_sim = hundred_kb_read()
    assert len(long_sim.rec.seq) > mapper.cfg.buckets[-1]
    log(f"# long reads: 1 Mbp genome + index, reads of "
        f"{[len(s.rec.seq) for s in sims]} and {len(long_sim.rec.seq)} "
        f"bases ({time.time() - t0:.1f}s)")
    from blasr_tpu_torch.kernels import sdp
    k2_calls, k4_calls, k5_calls, k6_calls = [], [], [], []
    k2_inner = capture_calls(map_read, "banded_traceback", k2_calls)
    k4_inner = capture_calls(sdp, "window_fragment_diags_banded", k4_calls)
    k5_inner = capture_calls(map_read, "find_anchors", k5_calls)
    k6_inner = capture_calls(map_read, "_band_offsets", k6_calls)
    try:
        cuda_ops.reset_launch_counts()
        t0 = time.time()
        per_read = mapper.map_reads([s.rec for s in sims])
        torch.cuda.synchronize()
        wall = time.time() - t0
        t0 = time.time()
        long_alns = mapper.map_reads([long_sim.rec])[0]
        torch.cuda.synchronize()
        long_wall = time.time() - t0
        launches = dict(cuda_ops.LAUNCHES)
    finally:
        map_read.banded_traceback = k2_inner
        sdp.window_fragment_diags_banded = k4_inner
        map_read.find_anchors = k5_inner
        map_read._band_offsets = k6_inner
    assert k2_calls and k4_calls and k5_calls and k6_calls, \
        "the long reads made no K2/K4/K5/K6 call"
    assert launches["banded_traceback"] == sum(
        a[0].tbbits.shape[0] > 0 for a, _, _ in k2_calls), launches
    assert launches["sdp_window"] == sum(a[0].shape[0] > 0
                                         for a, _, _ in k4_calls), launches
    # every launch of the run is one of the calls held to the plain version
    assert launches["anchor_search"] == len(k5_calls), launches
    assert launches["band_offsets"] == sum(a[0].shape[0] > 0
                                           for a, _, _ in k6_calls), launches
    secs = {}
    t0 = time.time()
    for i, (a, kw, out) in enumerate(k5_calls):
        assert a[3].is_cuda and a[3].shape[1] == 65536, \
            f"long-read K5 call {i + 1} is not at L = 65536"
        check_equal(out, find_anchors_plain(*a, **kw), Anchors._fields,
                    f"K5 long-read call {i + 1}")
    secs["K5"], t0 = time.time() - t0, time.time()
    for i, (a, kw, out) in enumerate(k6_calls):
        assert a[0].is_cuda and a[3] == 65536, \
            f"long-read K6 call {i + 1} is not at L = 65536"
        check_equal([out], [map_read._band_offsets_plain(*a, **kw)],
                    ("offsets",), f"K6 long-read call {i + 1}")
    from blasr_tpu_torch.kernels.banded import (BandedResult,
                                                banded_traceback_plain)
    secs["K6"], t0 = time.time() - t0, time.time()
    # the plain walk is row-wise, so the calls of one shape and t_max walk
    # as one batch: the time of the longest walk, not the sum of them
    groups = {}
    for i, (a, kw, out) in enumerate(k2_calls):
        assert a[0].tbbits.is_cuda and a[0].tbbits.shape[1] == 65536, \
            f"long-read K2 call {i + 1} is not at L = 65536"
        key = (tuple(a[0].tbbits.shape[1:]), tuple(sorted(kw.items())))
        groups.setdefault(key, []).append(i)
    for idx in groups.values():
        args = [a for a, _, _ in (k2_calls[i] for i in idx)]
        res = BandedResult(*(torch.cat([getattr(a[0], f) for a in args])
                             for f in BandedResult._fields))
        ref = banded_traceback_plain(
            res, *(torch.cat([a[j] for a in args]) for j in range(1, 6)),
            **k2_calls[idx[0]][1])
        start = 0
        for i in idx:
            a, _, out = k2_calls[i]
            n = a[0].tbbits.shape[0]
            for f in out._fields:
                assert torch.equal(getattr(out, f),
                                   getattr(ref, f)[start:start + n]), \
                    f"K2 long-read call {i + 1}: {f} differs from the plain"
            start += n
    log(f"# K2 == plain on the long reads' {len(k2_calls)} banded_traceback "
        f"call(s) (N={[a[0].tbbits.shape[0] for a, _, _ in k2_calls]}, "
        f"L=65536, t_max={[kw['t_max'] for _, kw, _ in k2_calls]}, "
        f"{[int(o.n_pairs.max()) for _, _, o in k2_calls]} steps in the "
        f"longest walk): exact")
    secs["K2"], t0 = time.time() - t0, time.time()
    for i, (a, kw, out) in enumerate(k4_calls):
        assert a[0].is_cuda and a[0].shape[1] == 65536, \
            f"long-read K4 call {i + 1} is not at L = 65536"
        check_equal(out, sdp.window_fragment_diags_banded_plain(*a, **kw),
                    ("diag", "valid"), f"K4 long-read call {i + 1}")
    torch.cuda.synchronize()
    secs["K4"] = time.time() - t0
    log(f"# K4 == plain on the long reads' {len(k4_calls)} "
        f"window_fragment_diags_banded call(s) (N="
        f"{[a[0].shape[0] for a, _, _ in k4_calls]}, L=65536): exact")
    log(f"# K5 == plain on the long reads' {len(k5_calls)} find_anchors "
        f"call(s) (B={k5_calls[0][0][3].shape[0]}, L=65536, "
        f"O={sorted({kw['occ_per_pos'] for _, kw, _ in k5_calls})}, "
        f"A={k5_calls[0][2].q.shape[1]}) and K6 == "
        f"plain on their {len(k6_calls)} _band_offsets call(s) (L=65536): "
        f"every field exact; seconds of the plain checks "
        f"{ {k: round(v, 1) for k, v in secs.items()} }")
    for s, alns in zip(sims, per_read):
        check_placed(s, alns, "long read")
    check_placed(long_sim, long_alns, "~100 kb read (map_long_reads)")
    log(f"# long reads placed 2/2 in {wall:.1f}s and the ~100 kb read in "
        f"{long_wall:.1f}s on {card}; launches {launches}")
    assert all(launches[k] > 0 for k in PATH_KERNELS + ("banded_dp",)), \
        f"kernels not launched (long reads): {launches}"


def phase_clr_read(cuda_ops):
    """tests/test_longread.py's ~20 kb CLR read at 85% accuracy (copied,
    forward strand) with buckets (1024, 2048): segment + stitch on the
    card, held to test_longread's bounds (span >= 0.97 of the read, the
    simulated strand, projection within 300 b of the simulated start) and
    to the same read mapped with ``--device cpu``."""
    from blasr_tpu_torch.index.genome import build_genome_index
    from blasr_tpu_torch.io.fasta import FastaRecord
    from blasr_tpu_torch.params import MappingParams, ShapeConfig
    from blasr_tpu_torch.pipeline.map_read import Mapper
    from blasr_tpu_torch.sim import mutate, random_genome
    contigs = random_genome(300_000, seed=181)
    gi = build_genome_index(contigs, k=12)
    rng = np.random.default_rng(182)
    ts, tl, err = 40_000, 20_000, 0.15
    read = mutate(contigs[0].seq[ts:ts + tl], rng, 0.2 * err, 0.5 * err,
                  0.3 * err)
    rec = FastaRecord(f"clr/0/0_{len(read)}", read)
    params = MappingParams(min_read_length=50).make_sane()
    cfg = ShapeConfig(buckets=(1024, 2048), batch_size=8)
    out, secs = {}, {}
    for device in ("cuda", "cpu"):
        cuda_ops.reset_launch_counts()
        t0 = time.time()
        alns = Mapper(gi, params, cfg, device=device).map_reads([rec])[0]
        secs[device] = time.time() - t0
        out[device] = [(a.strand, a.tindex, a.tstart, a.tend, a.qstart,
                        a.qend, list(a.cigar), a.score) for a in alns]
        if device == "cuda":
            launches = dict(cuda_ops.LAUNCHES)
            best = min(alns, key=lambda a: a.score)
    L = len(read)
    span = best.qend - best.qstart
    proj = best.tstart - (best.qstart if best.strand == 0 else L - best.qend)
    log(f"# CLR read {L} b at buckets (1024, 2048): strand {best.strand}, "
        f"span {span / L:.4f} of the read, projected start {proj} "
        f"(simulated {ts}); cuda == cpu: {out['cuda'] == out['cpu']} (cuda "
        f"{secs['cuda']:.1f}s, cpu {secs['cpu']:.1f}s); launches {launches}")
    assert best.strand == 0 and span >= 0.97 * L and abs(proj - ts) < 300
    assert out["cuda"] == out["cpu"], "the CLR read differs, cuda vs cpu"
    assert all(launches[k] > 0 for k in PATH_KERNELS + ("banded_dp",)), \
        f"kernels not launched (CLR read): {launches}"


# ---------------------------------------------------------------- phase 4

def bench_world():
    from blasr_tpu_torch.index.genome import build_genome_index
    from blasr_tpu_torch.sim import random_genome, simulate_reads
    contigs = random_genome(4_600_000, seed=11)
    gi = build_genome_index(contigs, k=12)
    sims = simulate_reads(contigs, 512, read_len=(500, 1980),
                          accuracy=0.85, seed=12)
    return gi, sims


def bench_inputs(sims, use_qv: bool):
    """The bench pass's reads and parameters: as simulated, or under
    ``--useQuality`` with per-base qualities 8-39, drawn as make_fastq
    draws them."""
    from blasr_tpu_torch.io.fasta import FastaRecord
    from blasr_tpu_torch.params import MappingParams
    recs = [s.rec for s in sims]
    if not use_qv:
        return recs, MappingParams().make_sane()
    rng = np.random.default_rng(13)
    recs = [FastaRecord(r.title, r.seq, rng.integers(8, 40, len(r.seq)))
            for r in recs]
    return recs, MappingParams(ignore_qualities=False).make_sane()


def phase_bench(card, cuda_ops, gi, sims, use_qv: bool, dev=None):
    """One bench pass (warm, then timed with launch counts zeroed just
    before and read just after) on the device index ``dev``; returns the
    launch counts."""
    from blasr_tpu_torch.params import ShapeConfig
    from blasr_tpu_torch.pipeline import map_read
    from blasr_tpu_torch.pipeline.map_read import Mapper, StageTimer
    from blasr_tpu_torch.pipeline.metrics import MappingMetrics

    label = "--useQuality" if use_qv else "distance"
    recs, params = bench_inputs(sims, use_qv)
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
    dispatches = calls["batches"] + calls["dense_reruns"]
    assert launches["chain_scan"] == 2 * dispatches, \
        f"K3 launches {launches['chain_scan']} != 2 x {dispatches} dispatches"
    assert launches["sdp_window"] == dispatches, \
        f"K4 launches {launches['sdp_window']} != {dispatches} dispatches"
    assert launches["anchor_search"] == dispatches, \
        f"K5 launches {launches['anchor_search']} != {dispatches} dispatches"
    assert launches["band_offsets"] == 2 * dispatches, \
        f"K6 launches {launches['band_offsets']} != 2 x {dispatches} " \
        "dispatches"
    return launches


def phase_profile(card, gi, sims, dev, use_qv: bool = False):
    """torch.profiler over one more bench pass (after a short warm pass):
    kernel launches per read, device time against the traced wall (the
    device's busy share) and the kernels that take the most device time.
    Measurement only: no check depends on it."""
    from torch.profiler import ProfilerActivity, profile
    from blasr_tpu_torch.params import ShapeConfig
    from blasr_tpu_torch.pipeline.map_read import Mapper
    label = "--useQuality" if use_qv else "distance"
    cfg = ShapeConfig(buckets=(1024, 2048), batch_size=32, max_anchors=512)
    recs, params = bench_inputs(sims, use_qv)
    mapper = Mapper(gi, params, cfg, device="cuda", dev=dev)
    mapper.map_reads(recs[:64])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        mapper.map_reads(recs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev_events:
        log(f"# profile ({label}): torch.profiler recorded no device "
            "events; device busy share not measured")
        return {}
    by_name = {}
    for e in dev_events:
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    total_ms = sum(us for _, us in by_name.values()) / 1e3
    launches = sum(n for name, (n, _) in by_name.items()
                   if not name.startswith(("Memcpy", "Memset")))
    log(f"# profile ({label}, {len(recs)} reads, traced): {launches} kernel "
        f"launches ({launches / len(recs):.1f} per read), {total_ms:.3f} ms "
        f"of device time in a {1e3 * wall:.3f} ms pass: busy share "
        f"{total_ms / (1e3 * wall):.4f} on {card}")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    for name, (n, us) in top:
        log(f"#   {us / 1e3:9.3f} ms {n:7d} x  {name[:90]}")
    # the port's kernels: device ms per wrapper call (all its kernels)
    short = {}
    for name, (n, us) in by_name.items():
        c, t = short.get(short_name(name), (0, 0.0))
        short[short_name(name)] = (c + n, t + us / 1e3)
    per_call = {}
    for key, (once, others) in PROFILE_KERNELS.items():
        calls = sum(c for n, (c, _) in short.items() if is_kernel(n, once))
        if calls:
            per_call[key] = sum(ms for n, (_, ms) in short.items()
                                if is_kernel(n, once + others)) / calls
    log(f"# device ms per call ({label}, torch.profiler): "
        + ", ".join(f"{k} {v:.4f}" for k, v in per_call.items())
        + "; by kernel: " + ", ".join(
            f"{n} {ms / c:.4f} ({c} x)" for n, (c, ms) in short.items()
            if is_kernel(n, sum(PROFILE_KERNELS["anchor_search"], ()))
            or is_kernel(n, PROFILE_KERNELS["band_offsets"][0]))
        + f" on {card}")
    return per_call


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

    if sys.argv[1:2] == ["--compare"]:
        sys.path.insert(0, os.path.join(HERE, "tests"))
        {"K1": compare_k1, "K2": compare_k2, "K3": compare_k3,
         "K5": compare_k5, "K6": compare_k6}[sys.argv[2]](card,
                                                          sys.argv[3:])
        return 0
    if sys.argv[1:] == ["--k4-kernels"]:
        return count_k4_kernels(card)
    if sys.argv[1:] == ["--device-times"]:
        sys.path.insert(0, os.path.join(HERE, "tests"))
        return k5k6_device_times(card)
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
    gi, sims = bench_world()
    log(f"# bench world: genome + index {time.time() - t0:.1f}s")
    sys.path.insert(0, os.path.join(HERE, "tests"))
    t0 = time.time()
    kres = phase_kernels(card)
    bb = bench_batch(gi, sims)
    dev = bb["ix"]
    kres.update(phase_chain_sdp(card, gi, bb))
    kres.update(phase_anchor_band(card, bb))
    log(f"# phase 2 done in {time.time() - t0:.1f}s")
    with tempfile.TemporaryDirectory() as d:
        t0 = time.time()
        phase_goldens(d, cuda_ops)
        phase_ids(cuda_ops)
        log(f"# phase 3 goldens done in {time.time() - t0:.1f}s")
        t0 = time.time()
        phase_modes(d, cuda_ops)
        log(f"# phase 3 modes done in {time.time() - t0:.1f}s")
    t0 = time.time()
    phase_long_reads(card, cuda_ops)
    phase_clr_read(cuda_ops)
    log(f"# long-read phase done in {time.time() - t0:.1f}s")
    t0 = time.time()
    dist = phase_bench(card, cuda_ops, gi, sims, use_qv=False, dev=dev)
    qvl = phase_bench(card, cuda_ops, gi, sims, use_qv=True, dev=dev)
    log(f"# phase 4 done in {time.time() - t0:.1f}s")
    t0 = time.time()
    prof = {"distance": phase_profile(card, gi, sims, dev),
            "qv": phase_profile(card, gi, sims, dev, use_qv=True)}
    check_k4_one_kernel()
    log(f"# phase 5 done in {time.time() - t0:.1f}s")
    assert "jax" not in sys.modules or sys.modules["jax"] is None
    loaded = [m for m in sys.modules if m.startswith("blasr_tpu.")]
    assert not loaded, f"JAX-package modules were loaded: {loaded}"

    launches = {"banded_dp": dist["banded_dp"],
                "banded_dp_qv": qvl["banded_dp_qv"]}
    for k in PATH_KERNELS:
        launches[k] = dist[k] + qvl[k]
    rows = [("banded_dp", DP_SRC, "blasr_tpu/kernels/pallas_banded.py:388"),
            ("banded_dp_qv", DP_SRC,
             "blasr_tpu/kernels/pallas_banded.py:388"),
            ("banded_traceback", TB_SRC, "blasr_tpu/kernels/banded.py:424"),
            ("chain_scan", CHAIN_SRC, "blasr_tpu/kernels/chain.py:54"),
            ("sdp_window", SDP_SRC, "blasr_tpu/kernels/sdp.py:142"),
            ("anchor_search", ANCHOR_SRC, "blasr_tpu/kernels/anchor.py:74"),
            ("band_offsets", BAND_SRC,
             "blasr_tpu/pipeline/map_read.py:320")]
    # rule 2's measure: launches per pass pair x (kernel ms - bound ms),
    # the kernel's ms as phase 2's events time the call and as its device
    # time alone (K5, K6: phase 2's calls by torch.profiler; the others:
    # the profiled passes of phase 5, per launch)
    for name, _, _ in rows:
        if "device_ms" not in kres[name]:
            kres[name]["device_ms"] = prof[
                "qv" if name == "banded_dp_qv" else "distance"].get(name)
    loss = {name: launches[name] * (kres[name]["ms"] - kres[name]["bound"][0])
            for name, _, _ in rows}
    dloss = {name: (None if kres[name]["device_ms"] is None else
                    launches[name]
                    * (kres[name]["device_ms"] - kres[name]["bound"][0]))
             for name, _, _ in rows}
    log("# rule 2, launches per pass pair x (kernel ms - bound ms), call "
        "time | device time: " + ", ".join(
            f"{name} {loss[name]:.3f} | " + (
                "not measured" if dloss[name] is None
                else f"{dloss[name]:.3f}")
            for name in sorted(loss, key=lambda k: -loss[k]))
        + f" on {card}")
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

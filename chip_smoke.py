#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (blasr_tpu_torch) on one GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py
    python3 chip_smoke.py --compare K1|K2|K3|K5|K6|K7|K1W|K2W A/kernel.cu B/kernel.cu

The second form only builds the named kernel from each given source (K1
banded_dp.cu, K2 banded_traceback.cu, K3 chain_scan.cu, K5
anchor_search.cu, K6 band_offsets.cu, K7 chain_members.cu, K1W
banded_dp_wide.cu, K2W banded_traceback_wide.cu; e.g. a parent
commit's unpacked beside this one's), holds their outputs equal on phase
2's inputs (K1:
K1 and K1-QV, then K1-HP and the GEN forms of the sources that have them,
K1-HP and K1-HP-GEN also on an hp-heavy case and the hp-runs world, three
rounds each; K3:
the bench batch and A = 8192; K5: the bench batch's find_anchors call and
a long read's at L = 65536; K6: the bench batch's two _band_offsets calls
and a long read's; K7: the bench batch's chain_members call,
sdp_align's on the 64-pair world and one at the --maxExpand 4 retry's
A = 8192, a source with the lifting table also with a row's chains over
two CTAs, three rounds; K1W and K2W: phase 2's band-width cases in every
mode and the bench's DP shape, N = 640, L = 2048, at w_b 64 and 256) and
times them in turns, A B B A (see ``compare_k1`` .. ``compare_k7``,
``compare_k1w``, ``compare_k2w``): K5, K6 and K7
by their device time alone (``device_ms``), K5 and K6 also by the call's,
K7 also by torch.profiler.  ``--device-times`` (run by phase 2 as a
child), ``--k4-kernels`` (phase 5's) and ``--sharded-rank`` (phase 6's)
are the script's own child modes.

Phases (any failed check exits nonzero):
  1. header: torch / CUDA / nvcc versions, the card's name and power limit;
     build the hand-written kernels K1 (banded DP: distance, QV, hp band,
     each with a two-valued or a general matrix; K1-W the same at any
     other band width),
     K2 (traceback walk; K2-W at any other band width), K3 (chain scan), K4 (SDP window pass), K5 (anchor
     search), K6 (band offsets) and K7 (chain members) from
     ``blasr_tpu_torch/csrc``, one nvcc per source, all at once;
  2. each kernel against its plain PyTorch version at the main path's
     shapes, exact equality, timed with CUDA events: K1, K1-QV (random QV
     words in the three flavours: IDS tracks, plain base qualities, none)
     and K2 at N=640 items, L=2048 rows, W=3072 window (K2 warm, and cold
     with the L2 flushed before each call), K1 and K1-QV also on the edge
     shapes of their 16-row tiles, K2 on their cell words and on planted
     walks at the edges of its own 16-row tiles; K1-HP (the affine path's
     homopolymer-insertion band) and K1's GEN forms (a general matrix in
     the distance, hp and QV forms) on the same N=640 inputs, timed back
     to back and behind a spin kernel (K1-HP's lines with the share of
     rows on each of its four row cases), and on the tile-edge shapes,
     the homopolymer world and the hp row cases of
     tests/torch_edge_cases.py, K2 on their hp cell words; K3 on the
     anchors of the bench workload's first batch (2B=64 strand-rows,
     A=512) in its candidate and guide passes, a lookback-64 global chain and the edge
     inputs of tests/torch_edge_cases.py; K4 (the whole
     window_fragment_diags_banded, one launch) at N=192, L=2048,
     W=3072, D=512, occ 2 and 1, on bench-genome windows with planted
     read k-mers, and on the edge inputs (at band widths 128, 64 and
     256, as K6's); K3 at A=8192 (past one
     block's shared memory) and K4 at L=65536 (a row over 64 CTAs); K5
     on the bench batch (the
     find_anchors call of its map_batch, and the same call in K5's block
     mode, occ_block_sample) and K6 on the two _band_offsets
     calls of that batch's map_batch, captured, both also on the edge
     inputs (K5's block-* ones in its block mode); K5's and K6's calls timed three ways: the call (events around
     20 back to back), the device behind a spin kernel (``device_ms``)
     and each kernel by torch.profiler in a child process
     (``--device-times``: one profiler session of its own); K7 on the
     bench batch's chain_members call (its guide pass's K3 parents,
     captured from the batch's map_batch; the lifting path, counted in
     MEMBER_PATHS), on sdp_align's call on the 64-pair world (B=64, C=1,
     M=256, A=1024) and on the edge inputs, anchors int64 and int32, its
     call timed as K3's; K1-W (the banded DP at band widths other than
     128, csrc/banded_dp_wide.cu) in its six modes (distance, QV, hp,
     and the GEN form of each) and K2-W (the walk at those widths) on
     their cell words at t_max = 3T/8 and T, against the plain versions at
     w_b 48, 64, 256 (N=64, L=256) and 1100 (L=1024), exact, timed with CUDA
     events, then timed at the bench's DP shape (N=640, L=2048) at w_b 64
     and 256 beside K1, K1-QV and K2 at 128, ms a call and ps a cell;
  3. the golden worlds of tests/test_golden.py through the port's CLI with
     ``--device cuda``, byte for byte against tests/golden/, each group
     launching K1 (or K1-QV, K1-HP) and K2-K6 and every batch a replay of
     its key's CUDA graph (pipeline/graphs.py) but the eager warm-up pass
     before each capture: the main path (small: 60 kb, 12
     reads; big: 4.6 Mbp, 11 reads; golden.{m4,sam,m4.big,sam.big}, and
     on the big world --fastMaxInterval, the chain scan with lookback 64,
     and --aggressiveIntervalCut: golden.{m4.fastmax,m4.aggressive}); the
     ``--useQuality`` path (FASTQ and hp-biased STR worlds;
     golden.{m4.fastq,sam.fastq,sam.hpstr.qv}); the small world's other
     formats and mapping flags (golden.{m0,m1,m2,m3,m5,sam.hard,
     sam.subread,m4.rb,m4.scores,m4.filter}; m4.scores with gap costs 6 and
     7); the other inputs (golden.{m4.bwt,m4.fofn,m4.bamin,m4.xml,m4.unal,
     m4.unal.names}); concordant mapping (golden.m4.concordant, with the
     padded mini index's host build and upload timed); the affine path
     (golden.{m4.affine,m4.hpstr.affine}: K1-HP and never K1); then the
     IDS world
     of make_qvsteer, built in memory (its bax.h5 needs h5py), mapped with
     the port's Mapper on ``cuda`` and on ``cpu``: identical positions,
     CIGARs, scores and mapQV; then --onegap with --bam, and --extend, on
     a world of a spliced read and reads with noisy ends, each equal to
     the same run with ``--device cpu`` (decoded BAM records, m4 text; the
     BAM also decodes to the --sam output), and the --anchors and
     --clusters dumps of the small world, cuda == cpu; the Mapper options
     of this slice, each on cuda (its kernel launched) == cpu:
     --affineAlign --useQuality (K1-QV), --scoreMatrix alone, with
     --affineAlign and with --useQuality (K1-GEN, K1-HP-GEN, K1-QV-GEN), a
     rescue Mapper and occ_block_sample (K5's block mode); the Mapper at
     ShapeConfig(band_width=64) and (band_width=256) on the small world,
     and at band 64 in K1-W's other five modes, each on cuda after a
     warmup (its K1-W mode, K2-W and K3-K7 launched, never K1 or K2, every
     batch a graph replay) == cpu in every Alignment field; the port's
     samtom4 and samFilter on the golden.sam the card wrote; then two
     simulated
     reads of ~40 kb on a 1 Mbp genome (bucket 65536) and one of ~100 kb
     (map_long_reads: two segments at bucket 65536, stitched) mapped on
     the card, each on its simulated interval and strand, dispatched
     eagerly (graphs.eager_dispatch()) with every K2, K4, K5 and K6
     launch of that run captured and held to the plain version
     (L = 65536), then through graphs with the same alignments; and
     tests/test_longread.py's ~20 kb CLR read at buckets (1024, 2048),
     held to its bounds and to the same read mapped on ``cpu``; then the
     pairwise tools: sdpMatcher on the card and with --device cpu, stdout
     byte for byte, on tests/test_sdp_sw.py's worlds under each of
     -printSimilarity, -local, -noRefine, -showalign, -fixedtarget and
     -printsw and all six, and on 64 pairs of 1-2 kb reads at 85%
     accuracy (Lq 2048, Lt 2304), each card run launching K3 and K7 (K6,
     K1 and K2 when it refines) and never the plain chain_members;
     swMatcher on tests/test_sdp_sw.py's worlds; sdp_align's ms per pair
     beside its
     bound;
  4. the bench.py workload (4.6 Mbp genome, k=12, 512 CLR reads of
     0.5-2 kb at 85% accuracy), once in distance mode, once under
     ``--useQuality`` with per-base qualities 8-39 and once with
     ``--affineAlign`` (K1-HP), each after a warm pass that captures its
     graphs (each capture's ms and pool bytes printed): reads/s, launches
     per read, per-stage device times (one more pass, the stage marks
     event nodes of the graphs), and the share of reads placed on their
     simulated interval (>= 95%).  Launch and dispatch counts
     (graphs.DISPATCHES) are zeroed just before each of the three runs
     and read just after it: every dispatch a replay, K3 and K6 launch
     twice per batch dispatch (candidate and guide passes; band offsets
     before and after the SDP pass), K4, K5 and K7 once, and
     chain_members never runs as plain torch; then reads/s of the
     distance pass under the serial _run_bucket (run_bucket_serial) and
     the lookahead of four, both dispatched eagerly, in turns (A B B A), and of eager
     dispatch against graph replays, both with the lookahead, in five
     rounds of A B B A (every pass, medians and spreads);
  5. torch.profiler over one more pass in each mode through graphs, and
     over a distance pass dispatched eagerly, then over one pass (after a
     warm pass that captures its graphs) under --scoreMatrix alone, with
     --useQuality and with --affineAlign (K1-GEN, K1-QV-GEN, K1-HP-GEN)
     and under occ_block_sample (K5's block mode): the host waits (stream and
     device synchronisations, blocking copies, tensors read as Python
     values) inside each dispatch, which must be none; the host's launch
     calls (kernel and graph launches, copies, fills) per read and per
     dispatch, kernels per read, the device's busy share, the kernels
     with the most device time, each hand-written kernel's device ms per
     call; over one
     bench-shape call of K4's function, which must be one kernel (in a
     child process, ``--k4-kernels``, with a profiler session of its
     own); then
     rule 2's measure for K1-K7 and the modes: launches per pass pair x
     (kernel ms - bound ms), with the kernel's ms as phase 2 times the
     call and as its device time inside the graphs of phase 5's passes,
     per launch (a mode's from its own traced pass).
  6. ``sharded``, multi-device mapping (``blasr_tpu_torch/dist``) on the
     bench workload: the port's CLI (-m 4, --device cuda) in this process,
     then ``run_sharded`` on two hosts of this card (two ``python -c``
     processes started together under BLASR_TPU_NUM_HOSTS=2): host 0's
     merged file byte-identical to the same two shards mapped one after
     another in this process, parts and sentinels removed, every run
     launching K1-K7; the lines where it differs from the one process's
     run printed (map_batch's SDP pass fills its last third of rows by
     batch position, in the JAX package too), and with --sdpTupleSize 0
     one host and two hosts byte-identical; then two ranks of a gloo group on
     cuda:0 (``--sharded-rank``, the script's own child mode) on the
     bench's first batch of bucket 2048: map_batch_ref_sharded (R = 2) on
     the card equal to the same call on the CPU (plain versions) field for
     field and >= 95% of the batch placed after globalize_sharded, and
     map_batch_data_parallel (blocks of half the batch, the batch-level
     choices made over the whole batch) equal on every rank to
     single-rank map_batch over the whole batch on the card, array for
     array; each step's wall time
     and the runs' collectAlignments clocks printed.
The second-to-last lines are a JSON kernel table and the card's name and
power limit; the last line is ``{"ok": true, "device": {...}}``.
Exits nonzero without a result when no CUDA device is present or when
the blasr_tpu_torch package is not beside this file.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

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
MEMBERS_SRC = "blasr_tpu_torch/csrc/chain_members.cu"
DP_WIDE_SRC = "blasr_tpu_torch/csrc/banded_dp_wide.cu"
TB_WIDE_SRC = "blasr_tpu_torch/csrc/banded_traceback_wide.cu"
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

def random_case(rng, N, L, W, w_b=128, steep_every=8, hp_share=None):
    """Banded-DP inputs as tests/test_pallas_banded.py::_random_case makes
    them (numpy only): each read's span planted into its window on a noisy
    diagonal, offsets slope-limited to {0,1,2}.  Every ``steep_every``-th
    item instead spans twice as many window columns as rows, on a slope-2
    band: its global alignment needs a deletion per row, about two pairs
    per row, so its traceback overflows t_max = 3T/8 (and fits T).  With
    ``hp_share`` that share of the rows repeats the base before it (the hp
    band's hp_ok rows: the share and a quarter of the rest)."""
    reads = rng.integers(0, 4, (N, L)).astype(np.int8)
    if hp_share is not None:
        repeat = rng.random((N, L)) < hp_share
        for r in range(1, L):
            reads[:, r] = np.where(repeat[:, r], reads[:, r - 1],
                                   reads[:, r])
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


def hp_row_cases(reads, qa, qb) -> dict:
    """The active rows' share that is hp_ok (read[r] == read[r-1] < 4) and
    the shares of K1-HP's four row cases (csrc/banded_dp.cu::recurrence):
    1 neither the previous active row nor this one hp_ok, 2 only this one,
    3 only the previous one, 4 both."""
    reads = torch.as_tensor(reads).long()
    qa, qb = (torch.as_tensor(x).long()[:, None] for x in (qa, qb))
    r = torch.arange(reads.shape[1], device=reads.device)
    active = (r >= qa) & (r < qb)
    ok = torch.zeros_like(active)
    ok[:, 1:] = (reads[:, 1:] == reads[:, :-1]) & (reads[:, :-1] < 4)
    live = torch.zeros_like(active)
    live[:, 1:] = ok[:, :-1]
    live &= r > qa
    n = float(active.sum())
    return {"hp_ok": float((ok & active).sum()) / n,
            "cases": [float((active & (live == hl) & (ok == ho)).sum()) / n
                      for hl, ho in ((False, False), (False, True),
                                     (True, False), (True, True))]}


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
    type, namespace and parameter list:
    'banded_dp_kernel<false, false, false>'."""
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


def scrambled_rows(n: int, seed: int = 0):
    """An index of DP rows to walk: about half of ``n`` rows in a scrambled
    order and the first of them again (int64, on the card)."""
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(seed))
    return torch.cat([perm[:(n + 1) // 2], perm[:1]]).to("cuda")


def check_indexed(res, rest, t_max: int, name: str, w_b: int, k2,
                  rows=None):
    """K2 (K2-W) through an index of DP rows (``rows``, by default
    :func:`scrambled_rows`) against K2 on the result and arguments
    gathered by it and against ``k2``, the walk of every row, at those
    rows: every output exactly, one indexed launch."""
    from blasr_tpu_torch.kernels import cuda_ops
    from blasr_tpu_torch.kernels.banded import BandedResult, banded_traceback
    if rows is None:
        rows = scrambled_rows(res.tbbits.shape[0])
    before = cuda_ops.INDEXED_WALKS
    got = banded_traceback(res, *rest, t_max=t_max, w_b=w_b, rows=rows)
    torch.cuda.synchronize()
    assert cuda_ops.INDEXED_WALKS == before + 1, f"{name}: not indexed"
    copy = banded_traceback(BandedResult(*(x[rows] for x in res)),
                            *(a[rows] for a in rest), t_max=t_max, w_b=w_b)
    for f in got._fields:
        a, b, c = getattr(got, f), getattr(copy, f), getattr(k2, f)[rows]
        assert torch.equal(a, b) and torch.equal(a, c), \
            f"{name}: {f} through rows differs from the gathered copy's"
    return got


def check_walk(res, rest, t_max: int, name: str, w_b: int = 128):
    """K2 (banded_traceback on CUDA tensors; K2-W at a band width other
    than 128) against the plain walk, every output exactly; its pair
    buffer is handed out dirty first, so the zeros after each stop are the
    kernel's own; then through an index of the rows
    (:func:`check_indexed`).  Returns (K2's result, max |diff|)."""
    from blasr_tpu_torch.kernels.banded import (banded_traceback,
                                                banded_traceback_plain,
                                                pair_capacity)
    N = res.tbbits.shape[0]
    torch.full((N, pair_capacity(t_max) // 2), -1, dtype=torch.int32,
               device="cuda")
    k2 = banded_traceback(res, *rest, t_max=t_max, w_b=w_b)
    torch.cuda.synchronize()
    pl = banded_traceback_plain(res, *rest, t_max=t_max, w_b=w_b)
    torch.cuda.synchronize()
    for f in k2._fields:
        a, b = getattr(k2, f), getattr(pl, f)
        assert a.dtype == b.dtype and torch.equal(a, b), \
            f"{name}: {f} differs from the plain walk"
    check_indexed(res, rest, t_max, name, w_b, k2)
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

    modes = k1_modes(card, args, qv, k1_bytes, cells)

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
    tb_err = max(tb_err, k1_mode_edges(modes))
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
    return {
        **modes,
        "banded_dp": dict(err=dp_err, ms=dp_ms, plain_ms=dp_plain_ms,
                          bound=dp_bound),
        "banded_dp_qv": dict(err=qv_err, ms=qv_ms, plain_ms=qv_plain_ms,
                             bound=qv_bound),
        "banded_traceback": dict(err=tb_err, ms=kms, plain_ms=pms, bound=kb),
    }


# K1's modes beyond distance and QV (tests/torch_edge_cases.py::K1_MODES)
# that phase 2 times, with their float32 operations per active cell (the
# hp band's ~10 more; a matrix entry is a shared-memory read)
K1_MODE_OPS = {"hp": HP_OPS_PER_CELL, "gen": K1_OPS_PER_CELL,
               "hp-gen": HP_OPS_PER_CELL, "qv-gen": K1QV_OPS_PER_CELL}


def k1_mode_launch_kw(mode, qv):
    """(banded_align arguments after the gap costs, banded_dp_launch's
    keyword arguments, the matrix, the gap costs, the launch key) of a
    K1 mode."""
    from blasr_tpu_torch.kernels.cuda_ops import dp_launch_key
    from blasr_tpu_torch.kernels.pallas_banded import two_valued
    from torch_edge_cases import K1_MODES, k1_mode_kwargs
    sub, gaps, kw = k1_mode_kwargs(mode)
    if K1_MODES[mode][3]:
        kw = dict(kw, **qv)
    gen = not two_valued(sub)
    lkw = dict(match=float(sub[0]), mismatch=float(sub[1]),
               ins_open=gaps[0], ins_ext=gaps[1], del_open=gaps[2],
               del_ext=gaps[3], submat=sub if gen else None, **kw)
    key = dp_launch_key(K1_MODES[mode][3], "use_hp" in kw, gen)
    return kw, lkw, sub, gaps, key


def k1_modes(card, args, qv, k1_bytes, cells):
    """K1-HP and the GEN forms (distance, hp, QV) on phase 2's inputs
    (N=640, L=2048): each exact against the plain DP, one launch of its
    own count; the launch timed back to back and behind a spin kernel,
    the plain DP timed on its one call."""
    from blasr_tpu_torch.kernels import cuda_ops
    from blasr_tpu_torch.kernels.banded import ST_H, banded_align
    from blasr_tpu_torch.kernels.pallas_banded import banded_align_cuda
    out = {}
    launch = args[:7]
    for mode, ops in K1_MODE_OPS.items():
        kw, lkw, sub, gaps, key = k1_mode_launch_kw(mode, qv)
        margs = (*launch, sub, *gaps)
        before = cuda_ops.LAUNCHES[key]
        k1 = banded_align_cuda(*margs, **kw)
        torch.cuda.synchronize()
        assert cuda_ops.LAUNCHES[key] == before + 1, f"{key} not launched"
        ref, pms = timed(lambda: banded_align(*margs, **kw))
        err = check_dp(k1, ref, key)
        fn = lambda: cuda_ops.banded_dp_launch(*launch, **lkw)  # noqa
        kms = cuda_ms(fn, 5)
        dms = device_ms(fn, 5)
        qv_bytes = 8 * launch[0].numel() if "qv" in mode else 0
        kb = bound(k1_bytes + qv_bytes, cells * ops)
        n_h = int(((k1.tbbits & 3) == ST_H).sum())
        out[key] = dict(err=err, ms=kms, plain_ms=pms, bound=kb,
                        device_ms=dms)
        rows = ""
        if "use_hp" in kw:
            c = hp_row_cases(launch[0], launch[3], launch[4])
            rows = (f"; rows hp_ok {c['hp_ok']:.4f}, in row cases 1-4 "
                    + "/".join(f"{x:.4f}" for x in c["cases"]))
        log(f"# {key} ({mode}) == plain: score/valid/final_state/tbbits "
            f"exact ({int(k1.valid.sum())}/{k1.valid.numel()} valid, {n_h} "
            f"cells with H as their diagonal source{rows}); kernel "
            f"{kms:.4f} ms back to back, {dms:.4f} ms behind a spin, plain "
            f"{pms:.1f} ms, bound {kb[0]:.4f} ms ({kb[1]}) per call on "
            f"{card}")
    return out


def k1_mode_edges(modes) -> float:
    """K1's modes on the tile-edge shapes and the homopolymer world
    (tests/torch_edge_cases.py::K1_MODE_CASES), exact; K2 on the hp
    cell words of each shape at t_max = 3T/8 and T.  Folds each mode's
    error into ``modes``; returns K2's."""
    from blasr_tpu_torch.kernels.banded import banded_align
    from blasr_tpu_torch.kernels.pallas_banded import banded_align_cuda
    from torch_edge_cases import (BANDED_QV_SEED, K1_MODE_CASES, K1_MODES,
                                  banded_case)
    from blasr_tpu_torch.params import MappingParams
    dev = torch.device("cuda")
    params = MappingParams().make_sane()
    tb_err = 0.0
    for name in K1_MODE_CASES:
        e = [torch.from_numpy(x).to(dev) for x in banded_case(name)]
        n_e, l_e = e[0].shape
        w_e = e[1].shape[1]
        q1, q2 = qv_words(np.random.default_rng(BANDED_QV_SEED), n_e, l_e,
                          params, 6)
        qv = dict(qv1=torch.from_numpy(q1).to(dev),
                  qv2=torch.from_numpy(q2).to(dev))
        for mode in K1_MODES:
            kw, _, sub, gaps, key = k1_mode_launch_kw(mode, qv)
            k1 = banded_align_cuda(*e, sub, *gaps, **kw)
            modes[key]["err"] = max(modes[key]["err"], check_dp(
                k1, banded_align(*e, sub, *gaps, **kw), f"{key} {name}"))
            if mode == "hp" or (name in ("hp-runs", "hp-tile-edges")
                                and K1_MODES[mode][2]):
                for t_e in ((3 * (l_e + w_e)) // 8, l_e + w_e):
                    tb_err = max(tb_err, check_walk(
                        k1, e[2:], t_e,
                        f"K2 on {key} {name} t_max={t_e}")[1])
    log(f"# K1-HP and the GEN forms == plain in the {len(K1_MODES)} modes "
        f"of tests/torch_edge_cases.py on the {len(K1_MODE_CASES)} shapes "
        f"(the tile edges and the homopolymer world): exact; K2 == plain on "
        f"their hp cell words at t_max = 3T/8 and T: exact")
    return tb_err


# the band widths K4 and K6 take their edge inputs at in phase 2 (the
# Mapper runs them at any width since K1-W)
EDGE_WIDTHS = (128, 64, 256)
# K1-W's six modes (csrc/banded_dp_wide.cu) with their float32 operations
# per active cell (K1's counts: the recurrence is the same per cell)
WIDE_MODE_OPS = {"distance": K1_OPS_PER_CELL, "qv": K1QV_OPS_PER_CELL,
                 "hp": HP_OPS_PER_CELL, "gen": K1_OPS_PER_CELL,
                 "hp-gen": HP_OPS_PER_CELL, "qv-gen": K1QV_OPS_PER_CELL}
# the band widths phase 2 holds K1-W and K2-W at; the kernel line reports
# K1-W's and K2-W's times at WIDE_LINE_WIDTH
# with the rows L of each case: 256 rows at the narrow widths keep the 24
# plain DP calls (~3 ms a row each) short, 1024 at 1100 (288 MB of cells)
WIDE_SMOKE_WIDTHS = {48: 256, 64: 256, 256: 256, 1100: 1024}
WIDE_LINE_WIDTH = 256


def wide_mode_kw(mode, qv, w_b):
    """(banded_align arguments after the gap costs, banded_dp_launch's
    keyword arguments, the matrix, the gap costs, the launch key) of a
    K1-W mode at band width ``w_b``."""
    from blasr_tpu_torch.kernels.cuda_ops import dp_launch_key
    from blasr_tpu_torch.kernels.pallas_banded import two_valued
    from torch_edge_cases import DEFAULT_SUBMAT, K1_MODES, k1_mode_kwargs
    if mode in ("distance", "qv"):
        sub, gaps, kw = DEFAULT_SUBMAT, (4.0, 4.0, 5.0, 5.0), {}
        use_qv = mode == "qv"
    else:
        sub, gaps, kw = k1_mode_kwargs(mode)
        use_qv = K1_MODES[mode][3]
    if use_qv:
        kw = dict(kw, **qv)
    gen = not two_valued(sub)
    lkw = dict(match=float(sub[0]), mismatch=float(sub[1]),
               ins_open=gaps[0], ins_ext=gaps[1], del_open=gaps[2],
               del_ext=gaps[3], submat=sub if gen else None, w_b=w_b, **kw)
    return kw, lkw, sub, gaps, dp_launch_key(use_qv, "use_hp" in kw, gen,
                                             w_b)


def phase_wide(card):
    """K1-W in its six modes and K2-W on their cell words against the
    plain versions at band widths 48, 64, 256 and 1100 (N = 64 items, L =
    WIDE_SMOKE_WIDTHS[w_b] rows, the window of
    ShapeConfig(band_width=w_b)), exactly; each
    launch once of its own count; K1-W's launch and K2-W's call timed with
    CUDA events (3 back to back), the plain versions on their one call;
    then ``wide_bench_times``.  Returns the kernel line's entries, their
    times at WIDE_LINE_WIDTH."""
    from blasr_tpu_torch.kernels import cuda_ops
    from blasr_tpu_torch.kernels.banded import (BandedResult, banded_align,
                                                banded_traceback,
                                                banded_traceback_plain,
                                                pair_capacity)
    from blasr_tpu_torch.kernels.pallas_banded import banded_align_cuda
    from blasr_tpu_torch.params import MappingParams, ShapeConfig
    dev = torch.device("cuda")
    params = MappingParams().make_sane()
    N = 64
    out = {}
    for w_b, L in WIDE_SMOKE_WIDTHS.items():
        W = ShapeConfig(band_width=w_b).window_len(L)
        T = L + W
        rng = np.random.default_rng(w_b)
        arrs = random_case(rng, N, L, W, w_b=w_b)
        args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for a in arrs]
        q1, q2 = qv_words(rng, N, L, params, 6)
        qv = dict(qv1=torch.from_numpy(q1).to(dev),
                  qv2=torch.from_numpy(q2).to(dev))
        qa, qb = args[3], args[4]
        cells = float((qb - qa).sum()) * w_b
        k1_bytes = (N * L + N * W + 4 * N * L + 16 * N
                    + 4 * w_b * N * L + 9 * N)
        words = []
        for mode, ops in WIDE_MODE_OPS.items():
            kw, lkw, sub, gaps, key = wide_mode_kw(mode, qv, w_b)
            before = cuda_ops.LAUNCHES[key]
            k1 = banded_align_cuda(*args, sub, *gaps, w_b=w_b, **kw)
            torch.cuda.synchronize()
            assert cuda_ops.LAUNCHES[key] == before + 1, \
                f"{key} not launched at w_b={w_b}"
            ref, pms = timed(lambda: banded_align(*args, sub, *gaps,
                                                  w_b=w_b, **kw))
            err = check_dp(k1, ref, f"{key} w_b={w_b}")
            kms = cuda_ms(lambda: cuda_ops.banded_dp_launch(*args, **lkw),
                          3)
            kb = bound(k1_bytes + (8 * N * L if "qv" in mode else 0),
                       cells * ops)
            rec = out.setdefault(key, dict(err=0.0, widths={}))
            rec["err"] = max(rec["err"], err)
            rec["widths"][w_b] = dict(ms=kms, plain_ms=pms, bound=kb)
            log(f"# {key} ({mode}) w_b={w_b} == plain: exact "
                f"({int(k1.valid.sum())}/{N} valid); kernel {kms:.4f} ms, "
                f"plain {pms:.1f} ms, bound {kb[0]:.4f} ms ({kb[1]}) per "
                f"call (N={N}, L={L}, W={W}) on {card}")
            words.append(k1)
        res = BandedResult(*(torch.cat(x) for x in zip(*words)))
        del words
        rest = [torch.cat([a] * len(WIDE_MODE_OPS)) for a in args[2:]]
        n6 = N * len(WIDE_MODE_OPS)
        for t_max in ((3 * T) // 8, T):
            # the pair buffer handed out dirty first, as in check_walk
            torch.full((n6, pair_capacity(t_max) // 2), -1,
                       dtype=torch.int32, device=dev)
            before = cuda_ops.LAUNCHES["banded_traceback_w"]
            k2 = banded_traceback(res, *rest, t_max=t_max, w_b=w_b)
            torch.cuda.synchronize()
            assert cuda_ops.LAUNCHES["banded_traceback_w"] == before + 1
            pl, pms = timed(lambda: banded_traceback_plain(  # noqa: B023
                res, *rest, t_max=t_max, w_b=w_b))
            for f in k2._fields:
                a, b = getattr(k2, f), getattr(pl, f)
                assert a.dtype == b.dtype and torch.equal(a, b), \
                    f"K2-W w_b={w_b} t_max={t_max}: {f} differs"
            check_indexed(res, rest, t_max, f"K2-W w_b={w_b} t_max={t_max}",
                          w_b, k2)
            err = max_abs(list(k2), list(pl))
            kms = cuda_ms(lambda: banded_traceback(  # noqa: B023
                res, *rest, t_max=t_max, w_b=w_b), 3)
            steps = float(k2.n_pairs.sum())
            kb = bound(SECTOR * steps + 42 * n6 + 4 * k2.pairs.numel(),
                       30 * steps)
            rec = out.setdefault("banded_traceback_w",
                                 dict(err=0.0, widths={}))
            rec["err"] = max(rec["err"], err)
            if t_max == (3 * T) // 8:
                rec["widths"][w_b] = dict(ms=kms, plain_ms=pms, bound=kb)
            log(f"# banded_traceback_w w_b={w_b} t_max={t_max} == plain on "
                f"the six modes' words: exact, {int(k2.overflow.sum())} "
                f"rows overflow, {steps:.0f} steps; kernel {kms:.4f} ms, "
                f"plain {pms:.1f} ms, bound {kb[0]:.4f} ms ({kb[1]}) per "
                f"call ({n6} items) on {card}")
        del res, rest
        torch.cuda.empty_cache()
    for rec in out.values():
        rec.update(rec["widths"][WIDE_LINE_WIDTH])
    wide_bench_times(card)
    return out


# the bench's DP shape (phase 2's K1 case: N items, L rows, W window),
# at which K1-W and K2-W are timed beside K1 and K2 at 128 on inputs
# planted the same way (random_case, seed 7), at these widths
BENCH_DP = (640, 2048, 3072)
BENCH_WIDE_WIDTHS = (64, 256)


def bench_dp_case(w_b: int):
    """(random_case's inputs at BENCH_DP and band width ``w_b`` on the
    card, the QV words of K1-QV's case, the active cells (qb - qa) * w_b)."""
    from blasr_tpu_torch.params import MappingParams
    N, L, W = BENCH_DP
    rng = np.random.default_rng(7)
    args = [torch.from_numpy(np.ascontiguousarray(a)).to("cuda")
            for a in random_case(rng, N, L, W, w_b=w_b)]
    q1, q2 = qv_words(rng, N, L, MappingParams().make_sane(), 6)
    qv = dict(qv1=torch.from_numpy(q1).to("cuda"),
              qv2=torch.from_numpy(q2).to("cuda"))
    return args, qv, float((args[4] - args[3]).sum()) * w_b


def wide_bench_times(card, reps: int = 5) -> dict:
    """K1-W (distance, QV) and K2-W (t_max = 3T/8) at the bench's DP shape
    at BENCH_WIDE_WIDTHS, beside K1, K1-QV and K2 at 128 on inputs planted
    the same way: ms a call (CUDA events around ``reps`` back to back
    calls, the DP's launch alone, K2 warm) and ps an active cell, one line
    each.  Returns {(kernel, w_b): (ms, ps a cell)}."""
    from blasr_tpu_torch.kernels import cuda_ops
    from blasr_tpu_torch.kernels.banded import banded_traceback
    out = {}
    for w_b in (128,) + BENCH_WIDE_WIDTHS:
        args, qv, cells = bench_dp_case(w_b)
        N, L, W = BENCH_DP
        res = None
        for mode in ("distance", "qv"):
            _, lkw, _, _, key = wide_mode_kw(mode, qv, w_b)
            r = cuda_ops.banded_dp_launch(*args, **lkw)
            ms = cuda_ms(lambda: cuda_ops.banded_dp_launch(  # noqa: B023
                *args, **lkw), reps)
            out[(key, w_b)] = (ms, 1e9 * ms / cells)
            res = r if res is None else res
        t_max = (3 * (L + W)) // 8
        key = "banded_traceback" + ("_w" if w_b != 128 else "")
        ms = cuda_ms(lambda: banded_traceback(  # noqa: B023
            res, *args[2:], t_max=t_max, w_b=w_b), reps)
        out[(key, w_b)] = (ms, 1e9 * ms / cells)
        del res, args
        torch.cuda.empty_cache()
    for (key, w_b), (ms, ps) in out.items():
        log(f"# bench DP shape (N={BENCH_DP[0]}, L={BENCH_DP[1]}, "
            f"W={BENCH_DP[2]}): {key} w_b={w_b} {ms:.4f} ms a call, "
            f"{ps:.3f} ps an active cell on {card}")
    return out


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
    lib = ctypes.CDLL(str(so))
    # its kernels' attributes, by its blasr_<source>_setup (an older
    # source sets them at its launches)
    cuda_ops.set_up(lib)
    return lib, data


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


def compare_k1(card, sources, reps: int = 5, rounds: int = 3) -> None:
    """K1 and K1-QV from each given banded_dp.cu on phase 2's inputs
    (N=640, L=2048), every output held to the first source's; then K1-HP
    and the GEN forms from each source that has them (its
    ``blasr_banded_dp_mode``), held to the first such source's, and K1-HP
    and K1-HP-GEN again on an hp-heavy case of the same shape
    (``hp_share=0.7``) and on the homopolymer world of
    tests/torch_edge_cases.py (``hp-runs``).  Each input and mode is
    timed in ``rounds`` rounds of A B B A."""
    import ctypes
    from blasr_tpu_torch.params import MappingParams
    from torch_edge_cases import banded_case
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

    def on_dev(arrs):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for a in arrs]

    ins = on_dev(random_case(rng, N, L, W))
    params = MappingParams().make_sane()
    sm = np.asarray(params.score_matrix, np.float32).reshape(25)
    q1, q2 = (torch.from_numpy(q).to(dev)
              for q in qv_words(rng, N, L, params, int(sm[1])))

    def outputs(x):
        n, l = x[0].shape
        return (torch.empty(n, dtype=torch.float32, device=dev),
                torch.empty((n, l, 128), dtype=torch.int32, device=dev),
                torch.empty(n, dtype=torch.int32, device=dev),
                torch.empty(n, dtype=torch.bool, device=dev))

    def run(lib, use_qv):
        outs = outputs(ins)
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
        for _ in range(rounds):
            in_turns(card, f"K1{'-QV' if use_qv else ''} (N={N}, L={L})",
                     sources, lambda i: run(libs[i], use_qv), reps)

    with_modes = [i for i, lib in enumerate(libs)
                  if hasattr(lib, "blasr_banded_dp_mode")]
    for i in with_modes:
        libs[i].blasr_banded_dp_mode.argtypes = ([P] * 9 + [I] * 5 + [P]
                                                 + [F] * 8 + [P] * 5)

    def run_mode(lib, mode, x):
        from blasr_tpu_torch.kernels.pallas_banded import two_valued
        from torch_edge_cases import K1_MODES, k1_mode_kwargs
        sub, gaps, kw = k1_mode_kwargs(mode)
        m = np.ascontiguousarray(sub, np.float32)
        use_qv = K1_MODES[mode][3]
        outs = outputs(x)
        n, l = x[0].shape
        rc = lib.blasr_banded_dp_mode(
            *[y.data_ptr() for y in x],
            q1.data_ptr() if use_qv else None,
            q2.data_ptr() if use_qv else None, n, l, x[1].shape[1],
            int(kw.get("use_hp", False)), int(not two_valued(m)),
            m.ctypes.data, float(m[0]), float(m[1]), *gaps,
            kw.get("hp_open", 0.0), kw.get("hp_ext", 0.0),
            *[y.data_ptr() for y in outs],
            torch.cuda.current_stream().cuda_stream)
        assert rc == 0, f"launch failed: {rc}"
        return outs

    if not with_modes:
        return
    srcs = [sources[i] for i in with_modes]
    cases = [("random_case", ins, K1_MODE_OPS),
             ("hp-heavy", on_dev(random_case(np.random.default_rng(7), N, L,
                                             W, hp_share=0.7)),
              ("hp", "hp-gen")),
             ("hp-runs", on_dev(banded_case("hp-runs")), ("hp", "hp-gen"))]
    for label, x, modes in cases:
        c = hp_row_cases(x[0], x[3], x[4])
        n, l = x[0].shape
        log(f"# {label} (N={n}, L={l}): rows hp_ok {c['hp_ok']:.4f}, in "
            f"K1-HP's row cases 1-4 "
            + "/".join(f"{v:.4f}" for v in c["cases"]))
        for mode in modes:
            key = k1_mode_launch_kw(mode, {})[4]
            ref = run_mode(libs[with_modes[0]], mode, x)
            for i in with_modes[1:]:
                for a, b in zip(run_mode(libs[i], mode, x), ref):
                    assert torch.equal(a, b), f"{sources[i]} differs " \
                        f"from {srcs[0]} ({key} on {label})"
            for _ in range(rounds):
                in_turns(card, f"{key} on {label} (N={n}, L={l})", srcs,
                         lambda j: run_mode(libs[with_modes[j]], mode, x),
                         reps)


def compare_k1w(card, sources, reps: int = 5) -> None:
    """K1-W from each given banded_dp_wide.cu (one C interface) through
    the package's wrapper: at phase 2's shapes (WIDE_SMOKE_WIDTHS, N = 64)
    in its six modes and at the bench's DP shape (BENCH_DP) at
    BENCH_WIDE_WIDTHS in distance and QV mode, every output held to the
    first source's, then timed in turns, A B B A."""
    from blasr_tpu_torch.kernels import cuda_ops
    from blasr_tpu_torch.params import MappingParams, ShapeConfig
    names = ("blasr_banded_dp_wide", "blasr_banded_dp_wide_ws_bytes",
             "blasr_banded_dp_wide_max_smem")
    libs = [cuda_ops.bind(build_source("K1W", src)[0], names)
            for src in sources]
    params = MappingParams().make_sane()
    cases = []
    for w_b, L in WIDE_SMOKE_WIDTHS.items():
        N, W = 64, ShapeConfig(band_width=w_b).window_len(L)
        rng = np.random.default_rng(w_b)
        args = [torch.from_numpy(np.ascontiguousarray(a)).to("cuda")
                for a in random_case(rng, N, L, W, w_b=w_b)]
        q1, q2 = qv_words(rng, N, L, params, 6)
        qv = dict(qv1=torch.from_numpy(q1).to("cuda"),
                  qv2=torch.from_numpy(q2).to("cuda"))
        for mode in WIDE_MODE_OPS:
            cases.append((f"{mode} (N={N}, L={L}, w_b={w_b})", args,
                          wide_mode_kw(mode, qv, w_b)[1]))
    for w_b in BENCH_WIDE_WIDTHS:
        args, qv, _ = bench_dp_case(w_b)
        for mode in ("distance", "qv"):
            cases.append((f"{mode} (N={BENCH_DP[0]}, L={BENCH_DP[1]}, "
                           f"w_b={w_b})", args,
                           wide_mode_kw(mode, qv, w_b)[1]))
    for label, args, lkw in cases:
        def run(i):
            return cuda_ops.banded_dp_launch(  # noqa: B023
                *args, **lkw, lib=libs[i])

        outs = [run(i) for i in range(len(libs))]
        torch.cuda.synchronize()
        for i in range(1, len(libs)):
            for a, b in zip(outs[i], outs[0]):
                assert torch.equal(a, b), \
                    f"K1-W from {sources[i]} differs from {sources[0]} " \
                    f"({label})"
        del outs
        in_turns(card, f"K1-W {label}", sources, run, reps)


def compare_k2w(card, sources, reps: int = 5) -> None:
    """K2-W from each given banded_traceback_wide.cu through the package's
    wrapper, on the package's K1-W cell words: the six modes' words at
    phase 2's shapes (WIDE_SMOKE_WIDTHS, N = 64 each) and the distance
    words at the bench's DP shape (BENCH_DP) at BENCH_WIDE_WIDTHS, at
    t_max = 3T/8 and T, about half the rows walked in a scrambled order
    (:func:`scrambled_rows`): a source that takes an index walks them in
    place, an older one (no ``rows``) a copy gathered inside its call.
    Every output held to the first source's, then timed in turns warm and
    with the L2 flushed."""
    import ctypes
    from blasr_tpu_torch.kernels import cuda_ops
    from blasr_tpu_torch.kernels.banded import (BandedResult,
                                                TracebackResult,
                                                pair_capacity)
    from blasr_tpu_torch.params import MappingParams, ShapeConfig
    libs = []
    for src in sources:
        lib, data = build_source("K2W", src)
        if b"int64_t* rows" in data:
            libs.append((cuda_ops.bind(lib, ("blasr_banded_traceback_wide",)),
                         True))
            continue
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.blasr_banded_traceback_wide.restype = I
        lib.blasr_banded_traceback_wide.argtypes = \
            [P] * 8 + [I] * 4 + [P] * 7 + [P]
        libs.append((lib, False))

    def older_walk(lib, res, rest, t_max, w_b, rows):
        """An older K2-W (no index) on the rows gathered beforehand."""
        res = BandedResult(*(x[rows] for x in res))
        rest = [a[rows] for a in rest]
        N, L, _ = res.tbbits.shape
        Pc = pair_capacity(t_max)
        pairs = torch.empty((N, Pc // 2), dtype=torch.int32, device="cuda")
        counts = torch.empty((5, N), dtype=torch.int32, device="cuda")
        ovf = torch.empty(N, dtype=torch.bool, device="cuda")
        rc = lib.blasr_banded_traceback_wide(
            res.tbbits.data_ptr(), *(x.data_ptr() for x in rest),
            res.final_state.data_ptr(), res.valid.data_ptr(), N, L, w_b,
            Pc, pairs.data_ptr(), *(c.data_ptr() for c in counts),
            ovf.data_ptr(), torch.cuda.current_stream().cuda_stream)
        assert rc == 0, f"launch failed: {rc}"
        return TracebackResult(pairs, *counts, ovf)
    params = MappingParams().make_sane()
    cases = []
    for w_b, L in WIDE_SMOKE_WIDTHS.items():
        N, W = 64, ShapeConfig(band_width=w_b).window_len(L)
        rng = np.random.default_rng(w_b)
        args = [torch.from_numpy(np.ascontiguousarray(a)).to("cuda")
                for a in random_case(rng, N, L, W, w_b=w_b)]
        q1, q2 = qv_words(rng, N, L, params, 6)
        qv = dict(qv1=torch.from_numpy(q1).to("cuda"),
                  qv2=torch.from_numpy(q2).to("cuda"))
        words = [cuda_ops.banded_dp_launch(*args, **wide_mode_kw(
            mode, qv, w_b)[1]) for mode in WIDE_MODE_OPS]
        res = BandedResult(*(torch.cat(x) for x in zip(*words)))
        rest = [torch.cat([a] * len(WIDE_MODE_OPS)) for a in args[2:]]
        cases.append((f"N={res.tbbits.shape[0]}, L={L}, w_b={w_b}", res,
                      rest, L + W, w_b))
    for w_b in BENCH_WIDE_WIDTHS:
        args, qv, _ = bench_dp_case(w_b)
        res = cuda_ops.banded_dp_launch(*args, **wide_mode_kw(
            "distance", qv, w_b)[1])
        cases.append((f"N={BENCH_DP[0]}, L={BENCH_DP[1]}, w_b={w_b}", res,
                      args[2:], BENCH_DP[1] + BENCH_DP[2], w_b))
    for label, res, rest, T, w_b in cases:
        rows = scrambled_rows(res.tbbits.shape[0])
        for t_max in ((3 * T) // 8, T):
            def run(i):
                lib, indexed = libs[i]
                if not indexed:
                    return older_walk(lib, res, rest,  # noqa: B023
                                      t_max, w_b, rows)  # noqa: B023
                return cuda_ops.banded_traceback_cuda(  # noqa: B023
                    res, *rest, t_max=t_max, w_b=w_b, rows=rows,  # noqa
                    lib=lib)

            outs = [run(i) for i in range(len(libs))]
            torch.cuda.synchronize()
            for i in range(1, len(libs)):
                for a, b in zip(outs[i], outs[0]):
                    assert torch.equal(a, b), \
                        f"K2-W from {sources[i]} differs from " \
                        f"{sources[0]} ({label}, t_max={t_max})"
            del outs
            for mode in ("warm", "cold"):
                in_turns(card, f"K2-W ({label}, t_max={t_max})", sources,
                         run, reps, mode)


def compare_k2(card, sources, reps: int = 5) -> None:
    """K2 from each given banded_traceback.cu on phase 2's inputs (K1's
    cell words at N=640, L=2048) at t_max = 3T/8 and T, walking N / 2 of
    the rows in a scrambled order as map_batch's traced rows: a source
    that takes an index of the rows (``rows``) walks them in place, an
    older one walks a gathered copy of them (made outside its timing).
    Every output held to the first source's, then timed warm and cold;
    the older sources also with their gather inside the timing (the
    traceback's gather and walk of map_batch before the index).  Each
    source's walk writes into one pre-zeroed pair buffer (an older walk
    stores only up to its stop), so the times are its launches alone."""
    import ctypes
    from blasr_tpu_torch.kernels.banded import BandedResult, pair_capacity
    from blasr_tpu_torch.kernels.pallas_banded import banded_align_cuda
    from blasr_tpu_torch.params import MappingParams
    libs = []
    for src in sources:
        lib, data = build_source("K2", src)
        P, I = ctypes.c_void_p, ctypes.c_int
        indexed = b"int64_t* rows" in data
        lib.blasr_banded_traceback.argtypes = \
            [P] * (9 if indexed else 8) + [I] * 3 + [P] * 8
        libs.append((lib, indexed))
    N, L, W = 640, 2048, 3072
    dev = torch.device("cuda")
    ins = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
           for a in random_case(np.random.default_rng(7), N, L, W)]
    sm = np.asarray(MappingParams().make_sane().score_matrix,
                    np.float32).reshape(25)
    res = banded_align_cuda(*ins, sm, 4.0, 4.0, 5.0, 5.0)
    n_tb = N // 2
    rows = torch.randperm(N, generator=torch.Generator().manual_seed(22))[
        :n_tb].to(dev)

    def gathered():
        return (BandedResult(*(x[rows] for x in res)),
                [a[rows] for a in ins[2:7]])

    copy = gathered()
    T = L + W
    for t_max in ((3 * T) // 8, T):
        Pc = pair_capacity(t_max)
        bufs = [(torch.zeros((n_tb, Pc // 2), dtype=torch.int32, device=dev),
                 torch.empty((5, n_tb), dtype=torch.int32, device=dev),
                 torch.empty(n_tb, dtype=torch.bool, device=dev))
                for _ in libs]

        def run(i, gather=False):
            lib, indexed = libs[i]
            pairs, counts, ovf = bufs[i]
            if indexed:
                r, args, idx = res, ins[2:7], (rows.data_ptr(),)
            else:
                (r, args), idx = (gathered() if gather else copy), ()
            rc = lib.blasr_banded_traceback(
                r.tbbits.data_ptr(), *(x.data_ptr() for x in args),
                r.final_state.data_ptr(), r.valid.data_ptr(), *idx, n_tb,
                L, Pc, pairs.data_ptr(),
                *(counts[k].data_ptr() for k in range(5)), ovf.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
            assert rc == 0, f"launch failed: {rc}"
            return bufs[i]

        for i in range(len(libs)):
            run(i)
        torch.cuda.synchronize()
        for i in range(1, len(libs)):
            for a, b in zip(bufs[i], bufs[0]):
                assert torch.equal(a, b), \
                    f"{sources[i]} differs from {sources[0]} (t_max={t_max})"
        log(f"# K2 (N={N}, L={L}, {n_tb} rows walked, t_max={t_max}): "
            + ", ".join(f"{src} {'through rows' if ix else 'on the copy'}"
                        for src, (_, ix) in zip(sources, libs)))
        for mode in ("warm", "cold"):
            in_turns(card, f"K2 (N={N}, L={L}, t_max={t_max})", sources, run,
                     reps, mode)
        if not all(ix for _, ix in libs):
            in_turns(card, f"K2 with the copy's gather (N={N}, L={L}, "
                     f"t_max={t_max})", sources,
                     lambda i: run(i, gather=True), reps, "warm")


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


def member_plan(lib, C: int, A: int, M: int):
    """(warps, stage) of one K7 source's launch: the library's own plan
    where it has one (``blasr_chain_members_plan``), else the first
    design's (up to four warps of one chain each, the row's parents staged
    in shared memory while they fit)."""
    from blasr_tpu_torch.kernels import cuda_ops
    if hasattr(lib, "blasr_chain_members_plan"):
        return cuda_ops.chain_members_plan(lib, C, A, M)
    limit = lib.blasr_chain_members_max_smem()
    warps = min(C, 4)
    while warps > 1 and lib.blasr_chain_members_smem(A, M, warps, 0) > limit:
        warps //= 2
    return warps, int(lib.blasr_chain_members_smem(A, M, warps, 1) <= limit)


# K7's kernels as torch.profiler names them, the first design's included
MEMBER_KERNELS = ("chain_members_lift", "chain_members_chase",
                  "chain_members_kernel")


def expand_member_call():
    """A chain_members call at the shape of the --maxExpand 4 retry
    (max_anchors 512 * 2^4 = 8192; B = 64 rows, C = 10, M = 96): K3's
    chains over synthetic anchor rows of 6,000-8,192 valid anchors
    (tests/torch_edge_cases.py::chain_rows), as (args, kwargs)."""
    from blasr_tpu_torch.kernels import chain
    from blasr_tpu_torch.kernels.anchor import Anchors
    from torch_edge_cases import chain_rows
    dev = torch.device("cuda")
    rng = np.random.default_rng(8192)
    c = chain_rows(rng, 64, 8192, rng.integers(6000, 8193, 64),
                   read_len=(20_000, 40_000))
    an = Anchors(**{f: torch.from_numpy(c[f]).to(dev)
                    for f in ("q", "t", "l", "valid", "nlogp")},
                 n_total=torch.from_numpy(
                     c["valid"].sum(1).astype(np.int32)).to(dev))
    cands = chain.chain_anchors(an, torch.from_numpy(c["read_len"]).to(dev),
                                n_cand=10, rank_by_pvalue=True,
                                p_value_type=0)
    return (cands, an), dict(max_chain=96)


def compare_k7(card, sources, reps: int = 20, rounds: int = 3) -> None:
    """K7 from each given chain_members.cu on the bench batch's
    chain_members call (B=64, C=10, M=96, A=512), on sdp_align's call on
    the 64-pair world (B=64, C=1, M=256, A=1024) and on a call at the
    --maxExpand 4 retry's shape (``expand_member_call``: B=64, C=10,
    M=96, A=8192), each source launched as it plans itself
    (``member_plan``); a source with the lifting table also with a row's
    chains over two CTAs (where that path holds C > 1 chains), and with
    the parents read from global memory where its plan stages them for
    the chase.  Every
    arm's output held to the plain version's, then timed in ``rounds``
    rounds of A B B A by device time (``device_ms``), and each arm's
    kernel by torch.profiler in one session."""
    from torch.profiler import ProfilerActivity, profile
    from blasr_tpu_torch.kernels import chain, cuda_ops
    libs = []
    for src in sources:
        lib, _ = build_source("K7", src)
        names = ("blasr_chain_members", "blasr_chain_members_smem",
                 "blasr_chain_members_max_smem")
        if hasattr(lib, "blasr_chain_members_plan"):
            names += ("blasr_chain_members_plan",)
        libs.append(cuda_ops.bind(lib, names))
    cuda_ops.build()
    gi, sims = bench_world()
    dev = torch.device("cuda")
    calls = [("bench batch", member_call(bench_batch(gi, sims))[:2]),
             ("sdp shape", sdp_member_call()[:2]),
             ("--maxExpand 4 shape", expand_member_call())]
    for label, ((cands, anchors), kw) in calls:
        M = kw["max_chain"]
        x = [anchors.q.contiguous(), anchors.t.contiguous(),
             anchors.l.contiguous(), cands.parent.contiguous(),
             cands.end_idx.contiguous()]
        B, A = x[0].shape
        C = x[4].shape[1]
        arms = []
        for src, lib in zip(sources, libs):
            warps, stage = member_plan(lib, C, A, M)
            arms.append((src, lib, warps, stage))
            if stage == 2 and C > 1:
                arms.append((f"{src}, two CTAs a row", lib, (C + 1) // 2,
                             stage))
            if stage == 1 and hasattr(lib, "blasr_chain_members_plan"):
                arms.append((f"{src}, parents in global memory", lib,
                             warps, 0))
        outs = [[torch.empty((B, C, M), dtype=dt, device=dev)
                 for dt in (torch.int64,) * 3 + (torch.bool,)]
                for _ in arms]

        def run(i):
            _, lib, warps, stage = arms[i]
            rc = lib.blasr_chain_members(
                *(y.data_ptr() for y in x[:3]),
                int(x[0].dtype == torch.int64), x[3].data_ptr(),
                x[4].data_ptr(), B, C, A, M, warps, stage,
                *(o.data_ptr() for o in outs[i]),
                torch.cuda.current_stream().cuda_stream)
            assert rc == 0, f"launch failed: {rc}"

        for i in range(len(arms)):
            run(i)
        ref = chain.chain_members_plain(cands, anchors, max_chain=M)
        torch.cuda.synchronize()
        for i, arm in enumerate(arms):
            check_equal(outs[i], ref, ("mq", "mt", "ml", "mvalid"),
                        f"K7 from {arm[0]} ({label})")
        names = [f"{n} (warps {w}, stage {st})" for n, _, w, st in arms]
        what = (f"K7 ({label}: B={B}, C={C}, M={M}, A={A}, "
                f"{int(ref[3].sum())} members)")
        times = {i: [] for i in range(len(arms))}
        for _ in range(rounds):
            for i, ts in in_turns(card, what, names, run, reps,
                                  "device").items():
                times[i] += ts
        # a session now and then records no device events: one more try
        for _ in range(2):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for i in range(len(arms)):
                    for _ in range(reps):
                        run(i)
                    torch.cuda.synchronize()
            evs = sorted((e for e in prof.events()
                          if e.device_type == torch.autograd.DeviceType.CUDA
                          and is_kernel(short_name(e.name), MEMBER_KERNELS)),
                         key=lambda e: e.time_range.start)
            if len(evs) == reps * len(arms):
                break
        if len(evs) != reps * len(arms):
            log(f"# {what}: torch.profiler recorded {len(evs)} of "
                f"{reps * len(arms)} launches; profiler times not measured")
            evs = []
        for i, name in enumerate(names):
            prof_ms = ("not measured" if not evs else "%.4f" % (sum(
                e.time_range.elapsed_us() for e in
                evs[i * reps:(i + 1) * reps]) / 1e3 / reps))
            log(f"# {what} from {name}: device {np.mean(times[i]):.4f} ms "
                f"(mean of {len(times[i])} in turns), torch.profiler "
                f"{prof_ms} ms a launch; equal to plain on {card}")


def first_batch(gi, sims, device):
    """The bench workload's first batch in bucket 2048 as
    Mapper._run_bucket forms it, on the host: (its Mapper on ``device``,
    the SimReads of its reads, reads int8 [B, L], lengths int32 [B], and
    the positional arguments and keywords of its map_batch call)."""
    from blasr_tpu_torch.params import MappingParams, ShapeConfig
    from blasr_tpu_torch.pipeline.map_read import Mapper
    L = 2048
    cfg = ShapeConfig(buckets=(1024, 2048), batch_size=32, max_anchors=512)
    mapper = Mapper(gi, MappingParams().make_sane(), cfg, device=device)
    batch = mapper.batch_size_for(L)
    chosen = [s for s in sims if cfg.bucket_for(len(s.rec.seq)) == L]
    chosen = chosen[:batch]
    arr = np.full((batch, L), 4, np.int8)
    lens = np.zeros(batch, np.int32)
    for i, s in enumerate(chosen):
        n = min(len(s.rec.seq), L)
        arr[i, :n] = s.rec.seq[:n]
        lens[i] = n
    pos, kw = mapper._batch_call_args(L)
    return mapper, chosen, arr, lens, pos, kw


def bench_batch(gi, sims):
    """The bench workload's first batch in bucket 2048 as
    Mapper._run_bucket forms it: the arguments of its map_batch call and of
    the find_anchors call inside it, its anchors (K5), the chain arguments
    map_batch passes, the device index and the batch's SimReads."""
    from blasr_tpu_torch.kernels.anchor import find_anchors
    from blasr_tpu_torch.pipeline.map_read import _revcomp_batch
    mapper, chosen, arr, lens, pos, kw = first_batch(gi, sims, "cuda")
    dev = torch.device("cuda")
    reads = torch.from_numpy(arr).to(dev)
    rl = torch.from_numpy(lens).to(dev)
    reads2 = torch.cat([reads, _revcomp_batch(reads, rl)])
    rlen2 = torch.cat([rl, rl])
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
                anchor_args=anchor_args, anchor_kw=anchor_kw, sims=chosen)


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
    result) to ``calls``; returns the function to restore.  A call made
    while a CUDA graph is captured is not recorded: its tensors are the
    graph's, which its replays overwrite."""
    inner = getattr(module, name)

    def wrapper(*a, **kw):
        out = inner(*a, **kw)
        if not torch.cuda.is_current_stream_capturing():
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


def members_bound(cands, anchors, out, M: int):
    """Bound of one chain_members call: the chain ends and the row's parent
    pointers (int64) read once, q, t and l (int64) of each present member
    once (this run's members, at most the whole rows), the [B, C, M]
    members (three int64 and a flag) written once; the rank sort's
    compares, n^2 a chain of n present members."""
    B, A = anchors.q.shape
    C = cands.end_idx.shape[1]
    n = out[3].sum(dim=2).to(torch.float64)
    present = float(n.sum())
    nbytes = (8 * B * C + 8 * B * A + 24 * min(present, B * A)
              + 25 * B * C * M)
    return bound(nbytes, float((n * n).sum()) + B * C * M)


def member_call(bb):
    """The chain_members call of the bench batch's map_batch, captured as
    it makes it (the guide pass's K3 parents): (args, kwargs, K7's
    result)."""
    from blasr_tpu_torch.pipeline import map_read
    calls = []
    inner = capture_calls(map_read, "chain_members", calls)
    try:
        map_read.map_batch(bb["ix"], bb["reads"], bb["rl"], *bb["pos"],
                           **bb["kw"])
        torch.cuda.synchronize()
    finally:
        map_read.chain_members = inner
    assert len(calls) == 1, f"map_batch made {len(calls)} member calls"
    return calls[0]


def phase_members(card, bb):
    """K7 against chain_members_plain on the same CUDA tensors: the bench
    batch's call (its guide pass's parents, captured from its map_batch),
    then the edge inputs in the anchors' int64 and int32."""
    from blasr_tpu_torch.kernels import chain, cuda_ops
    from blasr_tpu_torch.kernels.anchor import Anchors
    from torch_edge_cases import MEMBER_CASES, member_case
    dev = torch.device("cuda")
    fields = ("mq", "mt", "ml", "mvalid")
    (cands, anchors), kw, out = member_call(bb)
    M = kw["max_chain"]
    ref = chain.chain_members_plain(cands, anchors, max_chain=M)
    torch.cuda.synchronize()
    err = check_equal(out, ref, fields, "K7 bench batch")
    fn = lambda: chain.chain_members(cands, anchors, max_chain=M)  # noqa
    before = cuda_ops.LAUNCHES["chain_members"]
    lifts = cuda_ops.MEMBER_PATHS["lift"]
    kms = cuda_ms(fn, 20)
    assert cuda_ops.LAUNCHES["chain_members"] == before + 20
    assert cuda_ops.MEMBER_PATHS["lift"] == lifts + 20, \
        "K7 left its lifting path on the bench batch"
    spin = device_ms(fn, 20)
    pms = cuda_ms(lambda: chain.chain_members_plain(cands, anchors,
                                                    max_chain=M), 5)
    kb = members_bound(cands, anchors, out, M)
    B, A = anchors.q.shape
    C = cands.end_idx.shape[1]
    lib = cuda_ops._load()
    plan = cuda_ops.chain_members_plan(lib, C, A, M)
    log(f"# K7 == plain on the bench batch's guide members (B={B}, C={C}, "
        f"M={M}, A={A}): exact, {int(out[3].sum())} members; lifting path, "
        f"(warps, stage) {plan}; call {kms:.4f} ms (events around 20 back "
        f"to back), device {spin:.4f} ms behind a spin; plain {pms:.3f} ms, "
        f"bound {kb[0]:.5f} ms ({kb[1]}) on {card}")
    (scands, sanchors), skw, sout = sdp_member_call()
    sM = skw["max_chain"]
    err = max(err, check_equal(
        sout, chain.chain_members_plain(scands, sanchors, max_chain=sM),
        fields, "K7 sdp_align call"))
    sfn = lambda: chain.chain_members(scands, sanchors, max_chain=sM)  # noqa
    sb = members_bound(scands, sanchors, sout, sM)
    B, A = sanchors.q.shape
    log(f"# K7 == plain on sdp_align's members (B={B}, C=1, M={sM}, "
        f"A={A}): exact, {int(sout[3].sum())} members; "
        f"(warps, stage) {cuda_ops.chain_members_plan(lib, 1, A, sM)}; "
        f"call {cuda_ms(sfn, 20):.4f} ms, device {device_ms(sfn, 20):.4f} ms "
        f"behind a spin; bound {sb[0]:.5f} ms ({sb[1]}) on {card}")
    for name in MEMBER_CASES:
        c = member_case(name)
        z = torch.zeros(c["end_idx"].shape, dtype=torch.int64, device=dev)
        cd = chain.Candidates(
            z, z, z, z, z.float(), z, z.float(),
            torch.from_numpy(c["valid"]).to(dev),
            torch.from_numpy(c["end_idx"]).to(dev),
            torch.from_numpy(c["parent"]).to(dev))
        for dt in (torch.int64, torch.int32):
            an = Anchors(*(torch.from_numpy(c[f]).to(dev).to(dt)
                           for f in ("q", "t", "l")),
                         valid=torch.ones(c["q"].shape, dtype=torch.bool,
                                          device=dev),
                         n_total=None, nlogp=None)
            err = max(err, check_equal(
                chain.chain_members(cd, an, max_chain=c["M"]),
                chain.chain_members_plain(cd, an, max_chain=c["M"]),
                fields, f"K7 {name} {dt}"))
    log(f"# K7 == plain on the {len(MEMBER_CASES)} edge inputs, anchors in "
        f"int64 and int32: exact")
    return {"chain_members": dict(err=err, ms=kms, plain_ms=pms, bound=kb,
                                  spin_ms=spin)}


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
    "banded_dp": (("banded_dp_kernel<false, false, false>",), ()),
    "banded_dp_qv": (("banded_dp_kernel<true, false, false>",), ()),
    "banded_dp_hp": (("banded_dp_kernel<false, true, false>",), ()),
    "banded_traceback": (("banded_traceback_kernel",), ()),
    "chain_scan": (("chain_scan_kernel<false>", "chain_scan_kernel<true>"),
                   ()),
    "sdp_window": (("sdp_window_kernel",), ()),
    "anchor_search": (("anchor_candidates",), ("anchor_select",)),
    "band_offsets": (("band_offsets_kernel", "band_offsets_rows"), ()),
    "chain_members": (("chain_members_lift", "chain_members_chase"), ()),
    "banded_dp_gen": (("banded_dp_kernel<false, false, true>",), ()),
    "banded_dp_hp_gen": (("banded_dp_kernel<false, true, true>",), ()),
    "banded_dp_qv_gen": (("banded_dp_kernel<true, false, true>",), ()),
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
    # K5's block mode (occ_block_sample) on the same call
    from blasr_tpu_torch.kernels import cuda_ops
    bkw = dict(akw, occ_block_sample=True)
    before = cuda_ops.LAUNCHES["anchor_search_block"]
    blk = find_anchors(*args, **bkw)
    torch.cuda.synchronize()
    assert cuda_ops.LAUNCHES["anchor_search_block"] == before + 1
    kb_err = check_equal(blk, find_anchors_plain(*args, **bkw), fields,
                         "K5 block mode, bench batch")
    kb_ms = cuda_ms(lambda: find_anchors(*args, **bkw), 20)
    kb_spin = device_ms(lambda: find_anchors(*args, **bkw), 20)
    kb_plain = cuda_ms(lambda: find_anchors_plain(*args, **bkw), 3)
    kb_bound = anchors_bound(blk, bb["rlen2"], bb["kw"])
    moved = int((blk.hits_t != bb["anchors"].hits_t).sum())
    log(f"# K5 block mode == plain on the bench batch: every field exact, "
        f"{int(blk.valid.sum())} valid anchors, {moved} raw hits differ "
        f"from the strided mode's; call {kb_ms:.4f} ms (events around 20 "
        f"back to back), device {kb_spin:.4f} ms behind a spin; plain "
        f"{kb_plain:.3f} ms, bound {kb_bound[0]:.4f} ms ({kb_bound[1]}) on "
        f"{card}")
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
        err = check_equal(find_anchors(*a, **kw),
                          find_anchors_plain(*a, **kw), fields, f"K5 {name}")
        if kw.get("occ_block_sample"):
            kb_err = max(kb_err, err)
        else:
            k5_err = max(k5_err, err)
    log(f"# K5 == plain on the {len(ANCHOR_CASES)} edge inputs (the block-* "
        f"ones in its block mode): exact")
    for name in BAND_CASES:
        for w_b in EDGE_WIDTHS:
            c = band_case(name, w_b)
            a = [None if c[f] is None else torch.from_numpy(c[f]).to(dev)
                 for f in ("mq", "mt", "ws", "frag_diag", "frag_valid")]
            a = (*a[:3], c["L"], c["W"], w_b, *a[3:], c["between_only"])
            k6_err = max(k6_err, check_equal(
                [map_read._band_offsets(*a)],
                [map_read._band_offsets_plain(*a)], ("offsets",),
                f"K6 {name} w_b={w_b}"))
    log(f"# K6 == plain on the {len(BAND_CASES)} edge inputs at band widths "
        f"{EDGE_WIDTHS}: exact")
    kms, pms, kb, dev_ms = k6[0]
    return {
        "anchor_search": dict(err=k5_err, ms=k5_ms, plain_ms=k5_plain,
                              bound=k5_bound, device_ms=k5_dev),
        "anchor_search_block": dict(err=kb_err, ms=kb_ms, plain_ms=kb_plain,
                                    bound=kb_bound, device_ms=kb_spin),
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
        for w_b in EDGE_WIDTHS:
            reads, rlen, windows, wlens, offs, occ, k = sdp_case(name, w_b)
            rk, rv = read_kmer_keys(torch.from_numpy(reads).to(dev),
                                    torch.from_numpy(rlen).to(dev), k)
            a = (rk, rv, *(torch.from_numpy(x).to(dev)
                           for x in (windows, wlens, offs)))
            out = sdp.window_fragment_diags_banded(*a, k=k, occ=occ,
                                                   w_b=w_b)
            ref = sdp.window_fragment_diags_banded_plain(*a, k=k, occ=occ,
                                                         w_b=w_b)
            k4_err = max(k4_err, check_equal(out, ref, ("diag", "valid"),
                                             f"K4 {name} w_b={w_b}"))
    log(f"# K4 == plain on the {len(SDP_CASES)} edge inputs at band widths "
        f"{EDGE_WIDTHS}: exact")

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
    """tests/test_golden.py::make_small_bwt's --bwt input, built as that
    test builds it, with the port's sawriter and sa2bwt."""
    reads, genome, _ = small
    return reads, genome, ["--bwt", tools_index(d, genome, "--bwt")]


def tools_index(d, genome, kind: str) -> str:
    """The index the port's sawriter --fullSuffixArray (``--sa``), then its
    sa2bwt (``--bwt``), build from ``genome`` in folder ``d``."""
    from blasr_tpu_torch.cli.sa2bwt import run as sa2bwt_run
    from blasr_tpu_torch.cli.sawriter import run as sawriter_run
    os.makedirs(d, exist_ok=True)
    t0 = time.time()
    sa = os.path.join(d, "genome.sa.npz")
    if not os.path.exists(sa):
        assert sawriter_run([sa, genome, "--fullSuffixArray"]) == 0
    out = sa
    if kind == "--bwt":
        out = os.path.join(d, "genome.bwt.npz")
        assert sa2bwt_run([genome, sa, out]) == 0
    log(f"# {kind} index of {os.path.basename(genome)} built by the port's "
        f"sawriter{' and sa2bwt' if kind == '--bwt' else ''} in "
        f"{time.time() - t0:.1f}s")
    return out


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
                "anchor_search", "band_offsets", "chain_members")


def check_replays(calls: dict, what: str) -> None:
    """Every map_batch pass of a run (``graphs.DISPATCHES``) was a graph
    replay, but for the eager warm-up pass before each capture."""
    passes = calls["batches"] + calls["dense_reruns"]
    assert calls["replays"] > 0 and \
        passes == calls["replays"] + calls["captures"], \
        f"{what}: not every dispatch was a graph replay: {calls}"


def phase_goldens(d, cuda_ops):
    """Every golden whose world needs no h5py through the port's CLI on the
    card, in groups by path, each launching its kernels and every batch a
    graph replay (but each capture's warm-up pass); returns the
    worlds."""
    from blasr_tpu_torch.pipeline import graphs
    small = make_small(d)
    worlds = {"small": small, "big": make_big(d), "fastq": make_fastq(d),
              "hpstr": make_hpstr(d), "small_bwt": make_small_bwt(d, small),
              "fofn": make_fofn(d, small), "bamin": make_bamin(d, small),
              "dataset": make_dataset(d), "unal": make_unal(d),
              "zmw": make_zmw(d)}
    dist = PATH_KERNELS + ("banded_dp",)
    n_card = 0
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
             dist, "banded_dp_qv"),
            # the affine path: the hp band, K1-HP and never K1
            ("--affineAlign", [("m4.affine", "small",
                                ["-m", "4", "--affineAlign", "--affineOpen",
                                 "8", "--affineExtend", "1"]),
                               ("m4.hpstr.affine", "hpstr",
                                ["-m", "4", "--affineAlign"])],
             PATH_KERNELS + ("banded_dp_hp",), "banded_dp")):
        cuda_ops.reset_launch_counts()
        graphs.reset_counts()
        if label == "concordant":
            with mini_index_clocks() as clocks:
                n_ok = run_goldens(d, cases, worlds)
            report_mini_index(clocks)
        else:
            n_ok = run_goldens(d, cases, worlds)
        launches = dict(cuda_ops.LAUNCHES)
        calls = dict(graphs.DISPATCHES)
        log(f"# goldens ({label}) identical: {n_ok}/{len(cases)}; "
            f"launches {launches}; dispatches {calls}")
        assert n_ok == len(cases), f"golden outputs differ ({label})"
        check_replays(calls, f"goldens ({label})")
        assert all(launches[k] > 0 for k in needed), \
            f"kernels not launched ({label}): {launches}"
        assert launches[unused] == 0, f"the {label} path launched {unused}"
        n_card += n_ok
    log(f"# goldens identical on the card: {n_card} (every golden whose "
        f"world needs no h5py)")
    return worlds


# tests/test_cli_features.py's --scoreMatrix (uneven mismatches, N row and
# column of their own)
SCORE_MATRIX = [[-5 if i == j and i < 4 else 6 + (i + j) % 2
                 for j in range(5)] for i in range(5)]


def mapper_fields(per_read):
    return [[(a.strand, a.tindex, a.tstart, a.tend, a.qstart, a.qend,
              list(a.cigar), a.score, a.n_match, a.n_mismatch, a.n_ins,
              a.n_del, a.map_qv) for a in alns] for alns in per_read]


def rescue_world():
    """tests/test_torch_mapper_rescue.py's world (copied): a 40 kb genome,
    four reads at 90% and four at 70% accuracy."""
    from blasr_tpu_torch.io.fasta import FastaRecord
    from blasr_tpu_torch.sim import random_genome, simulate_reads
    contigs = random_genome(40_000, seed=71)
    sims = simulate_reads(contigs, 4, read_len=(400, 700), accuracy=0.9,
                          seed=72)
    sims += simulate_reads(contigs, 4, read_len=(400, 700), accuracy=0.7,
                           seed=73)
    return contigs, [FastaRecord(f"r/{i}/0_{len(s.rec.seq)}", s.rec.seq)
                     for i, s in enumerate(sims)]


def block_world():
    """tests/test_torch_mapper_block.py's world (copied):
    a 30 kb genome with an eight-copy 400 b repeat, five reads and the
    repeat unit."""
    from blasr_tpu_torch.io.fasta import FastaRecord
    from blasr_tpu_torch.sim import simulate_reads
    rng = np.random.default_rng(81)
    g = rng.integers(0, 4, 30_000).astype(np.int8)
    unit = rng.integers(0, 4, 400).astype(np.int8)
    for c in range(8):
        g[2_000 + 3_000 * c:2_400 + 3_000 * c] = unit
    contigs = [FastaRecord("rep", g)]
    sims = simulate_reads(contigs, 5, read_len=(400, 800), accuracy=0.88,
                          seed=82)
    recs = [FastaRecord(f"b/{i}/0_{len(s.rec.seq)}", s.rec.seq)
            for i, s in enumerate(sims)]
    return contigs, recs + [FastaRecord("b/5/0_400", unit.copy())]


def phase_mapper_modes(worlds, cuda_ops):
    """The Mapper options this slice brought to the card, each mapped on
    cuda (launch counts zeroed just before and read just after) and held
    to the same run on cpu, every alignment's fields: --affineAlign
    --useQuality (K1-QV, not K1-HP), a general --scoreMatrix in the
    distance, hp and QV forms (K1-GEN, K1-HP-GEN, K1-QV-GEN), a rescue
    Mapper and occ_block_sample (K5's block mode) on the worlds of
    tests/test_torch_mapper_*.py.  Returns each run's launches."""
    from blasr_tpu_torch.index.genome import build_genome_index
    from blasr_tpu_torch.io.fasta import read_sequences
    from blasr_tpu_torch.params import MappingParams, ShapeConfig
    from blasr_tpu_torch.pipeline.map_read import Mapper
    cfg = ShapeConfig(buckets=(1024,), batch_size=8)
    idx = {}

    def golden(name, sel):
        reads, genome, _ = worlds[name]
        if name not in idx:
            idx[name] = build_genome_index(list(read_sequences(genome)),
                                           k=12)
        return idx[name], list(read_sequences(reads))[sel]

    def mp(**kw):
        return MappingParams(**kw).make_sane()

    contigs, rrecs = rescue_world()
    gi14 = build_genome_index(contigs, k=14)
    gi12 = build_genome_index(contigs, k=12)
    bcontigs, brecs = block_world()
    # (label, world, params, ShapeConfig, rescue Mapper's index and
    #  params, kernel it must launch, kernel it must not launch); the
    # hpstr world's reads over its planted homopolymer runs
    cases = [
        ("--affineAlign --useQuality", golden("hpstr", slice(1, 3)),
         mp(affine_align=True, ignore_qualities=False), cfg, None,
         "banded_dp_qv", "banded_dp_hp"),
        ("--scoreMatrix", golden("small", slice(0, 4)),
         mp(score_matrix=SCORE_MATRIX), cfg, None, "banded_dp_gen",
         "banded_dp"),
        ("--scoreMatrix --affineAlign", golden("small", slice(0, 4)),
         mp(score_matrix=SCORE_MATRIX, affine_align=True), cfg, None,
         "banded_dp_hp_gen", "banded_dp_hp"),
        ("--scoreMatrix --useQuality", golden("hpstr", slice(1, 3)),
         mp(score_matrix=SCORE_MATRIX, ignore_qualities=False), cfg, None,
         "banded_dp_qv_gen", "banded_dp_qv"),
        ("rescue Mapper (k=14, minMatch 18; rescue k=12)", (gi14, rrecs),
         mp(min_match_length=18), cfg, (gi12, mp()), "banded_dp",
         "banded_dp_hp"),
        # a read inside the repeat (eight alignments) and one outside it;
        # the unit read alone takes the ambiguity rescue's deep pass,
        # ~25 s on the cpu
        ("occ_block_sample", (build_genome_index(bcontigs, k=12),
                              [brecs[0], brecs[3]]),
         mp(), ShapeConfig(buckets=(1024,), batch_size=8, occ_per_pos=3,
                           occ_block_sample=True), None,
         "anchor_search_block", "anchor_search"),
    ]
    out = {}
    for label, (gi, recs), p, c, rescue, needed, unused in cases:
        def run(device):
            kw = {}
            if rescue is not None:
                kw["rescue"] = Mapper(rescue[0], rescue[1], c, device=device)
            return mapper_fields(Mapper(gi, p, c, device=device,
                                        **kw).map_reads(recs))
        cuda_ops.reset_launch_counts()
        t0 = time.time()
        on_card = run("cuda")
        torch.cuda.synchronize()
        launches = dict(cuda_ops.LAUNCHES)
        t1 = time.time()
        on_cpu = run("cpu")
        log(f"# {label}: {sum(map(len, on_card))} alignments of "
            f"{len(recs)} reads; cuda == cpu: {on_card == on_cpu} (cuda "
            f"{t1 - t0:.1f}s, cpu {time.time() - t1:.1f}s); launches "
            f"{launches}")
        assert on_card == on_cpu, f"{label}: cuda and cpu differ"
        assert sum(map(bool, on_card)) >= len(recs) - 1, label
        assert launches[needed] > 0, f"{label} did not launch {needed}"
        assert launches[unused] == 0, f"{label} launched {unused}"
        assert all(launches[k] > 0 for k in PATH_KERNELS if k != unused), \
            launches
        if rescue is not None:
            alone = mapper_fields(Mapper(gi, p, c, device="cuda")
                                  .map_reads(recs))
            assert alone != on_card, "the rescue Mapper changed nothing"
        out[needed] = launches
    return out


def alignment_record(a) -> tuple:
    """Every field of an Alignment, arrays as (dtype, bytes)."""
    def value(x):
        if isinstance(x, np.ndarray):
            return (x.dtype.str, x.shape, x.tobytes())
        if isinstance(x, dict):
            return tuple(sorted((k, value(v)) for k, v in x.items()))
        return x
    return tuple((f.name, value(list(getattr(a, f.name))
                                if f.name == "cigar" and a.cigar is not None
                                else getattr(a, f.name)))
                 for f in dataclasses.fields(a))


# (label, band width, world, its reads, MappingParams options, the K1-W
# mode it launches): the Mapper at band widths other than 128
WIDTH_CASES = [
    ("band 64", 64, "small", slice(0, 8), {}, "banded_dp_w"),
    ("band 256", 256, "small", slice(0, 4), {}, "banded_dp_w"),
    ("band 64 --useQuality", 64, "hpstr", slice(1, 3),
     dict(ignore_qualities=False), "banded_dp_w_qv"),
    ("band 64 --affineAlign", 64, "small", slice(0, 2),
     dict(affine_align=True), "banded_dp_w_hp"),
    ("band 64 --scoreMatrix", 64, "small", slice(0, 2),
     dict(score_matrix=SCORE_MATRIX), "banded_dp_w_gen"),
    ("band 64 --scoreMatrix --affineAlign", 64, "small", slice(0, 2),
     dict(score_matrix=SCORE_MATRIX, affine_align=True),
     "banded_dp_w_hp_gen"),
    ("band 64 --scoreMatrix --useQuality", 64, "hpstr", slice(1, 3),
     dict(score_matrix=SCORE_MATRIX, ignore_qualities=False),
     "banded_dp_w_qv_gen"),
]
# the kernels every run at a band width other than 128 launches beside its
# K1-W mode
WIDE_PATH_KERNELS = ("banded_traceback_w", "chain_scan", "sdp_window",
                     "anchor_search", "band_offsets", "chain_members")


def phase_widths(worlds, cuda_ops):
    """Mapper.map_reads at ShapeConfig(band_width=64) and (band_width=256)
    on the small golden world, and at band 64 in the other five modes of
    K1-W (the QV ones on the hpstr world's reads over its homopolymer
    runs), each on cuda after a warmup that captures its graphs (launch
    and dispatch counts zeroed just before the run and read just after:
    its K1-W mode, K2-W and K3-K7 launched, no K1 or K2, every batch a
    graph replay) and held to the same run on cpu in every Alignment
    field.  Returns the launches by key: each K1-W mode's from its run,
    K1-W (distance) and K2-W summed over the band 64 and 256 runs."""
    from blasr_tpu_torch.index.genome import build_genome_index
    from blasr_tpu_torch.io.fasta import read_sequences
    from blasr_tpu_torch.params import MappingParams, ShapeConfig
    from blasr_tpu_torch.pipeline import graphs
    from blasr_tpu_torch.pipeline.map_read import Mapper
    idx = {}
    launches = {}
    for label, w_b, world, sel, opts, key in WIDTH_CASES:
        reads, genome, _ = worlds[world]
        if world not in idx:
            idx[world] = build_genome_index(list(read_sequences(genome)),
                                            k=12)
        gi, recs = idx[world], list(read_sequences(reads))[sel]
        p = MappingParams(**opts).make_sane()
        cfg = ShapeConfig(buckets=(1024,), batch_size=8, band_width=w_b)
        t0 = time.time()
        m = Mapper(gi, p, cfg, device="cuda")
        m.warmup()
        torch.cuda.synchronize()
        cuda_ops.reset_launch_counts()
        graphs.reset_counts()
        on_card = m.map_reads(recs)
        torch.cuda.synchronize()
        got = dict(cuda_ops.LAUNCHES)
        calls = dict(graphs.DISPATCHES)
        t1 = time.time()
        on_cpu = Mapper(gi, p, cfg, device="cpu").map_reads(recs)
        same = ([[alignment_record(a) for a in x] for x in on_card]
                == [[alignment_record(a) for a in x] for x in on_cpu])
        log(f"# {label}: {sum(map(len, on_card))} alignments of "
            f"{len(recs)} reads; cuda == cpu in every field: {same} (cuda "
            f"{t1 - t0:.1f}s with the warmup, cpu {time.time() - t1:.1f}s); "
            f"launches { {k: v for k, v in got.items() if v} }; dispatches "
            f"{calls}")
        assert same, f"{label}: cuda and cpu differ"
        assert sum(map(bool, on_card)) >= len(recs) - 1, label
        assert all(a.band_width == w_b for x in on_card for a in x)
        check_replays(calls, label)
        assert got[key] > 0 and all(got[k] > 0 for k in WIDE_PATH_KERNELS), \
            f"{label}: kernels not launched: {got}"
        k1_keys = [k for k in got if k.startswith("banded_dp")
                   and not k.startswith("banded_dp_w")]
        assert not any(got[k] for k in k1_keys + ["banded_traceback"]), \
            f"{label} launched K1 or K2: {got}"
        assert sum(got[k] for k in got if k.startswith("banded_dp_w")) \
            == got[key], f"{label} launched another K1-W mode: {got}"
        for k in (key, "banded_traceback_w"):
            launches[k] = launches.get(k, 0) + got[k]
    return launches


def phase_sam_tools(d):
    """The port's samtom4 and samFilter on the SAM the card wrote for
    golden.sam (out.sam, the small world): the m4 has one 13-field line a
    record, equal to samtom4 of the checked-in golden.sam; samFilter keeps
    every record by default and the hole numbers asked for, each an
    original line.  Runs without JAX and without h5py."""
    from blasr_tpu_torch.cli.sam_filter import run as sam_filter
    from blasr_tpu_torch.cli.sam_to_m4 import run as sam_to_m4
    sam, genome = os.path.join(d, "out.sam"), os.path.join(d, "genome.fa")
    recs = [ln for ln in open(sam).read().splitlines()
            if not ln.startswith("@")]
    m4s = []
    for src, out in ((sam, "card.m4"), (os.path.join(GOLDEN, "golden.sam"),
                                        "golden.m4.from_sam")):
        assert sam_to_m4([src, genome, os.path.join(d, out)]) == 0
        m4s.append(open(os.path.join(d, out)).read())
    lines = m4s[0].splitlines()
    assert m4s[0] == m4s[1] and len(lines) == len(recs) > 0
    assert all(len(ln.split()) == 13 for ln in lines)
    kept = {}
    for name, flags in (("all", []), ("allbest", ["--hitPolicy", "allbest"]),
                        ("holes", ["-holeNumbers", "0-5"])):
        out = os.path.join(d, f"filtered.{name}.sam")
        assert sam_filter([sam, out] + flags) == 0
        kept[name] = [ln for ln in open(out).read().splitlines()
                      if not ln.startswith("@")]
        assert set(kept[name]) <= set(recs), name
    assert kept["all"] == recs and kept["allbest"] == recs
    holes = [ln for ln in recs if int(ln.split("/")[1]) <= 5]
    assert kept["holes"] == holes and holes
    assert "h5py" not in sys.modules
    log(f"# samtom4 on the card's golden.sam: {len(lines)} lines, equal to "
        f"samtom4 of the checked-in golden.sam; samFilter kept "
        f"{len(kept['all'])}/{len(recs)} (all), {len(kept['allbest'])} "
        f"(allbest), {len(kept['holes'])} (-holeNumbers 0-5)")


# the static arguments of map_batch that the options of phase_options set
OPTION_KWARGS = ("O", "A", "C", "k_sdp", "sdp_occ", "p_value_type",
                 "lookback", "global_chain", "advance_exact", "full_widen")


def option_worlds(worlds):
    """The worlds of tests/test_torch_options_*.py (copied: those modules
    import JAX), each as (index, reads, ShapeConfig)."""
    from blasr_tpu_torch.index.genome import build_genome_index
    from blasr_tpu_torch.io.fasta import FastaRecord, read_sequences
    from blasr_tpu_torch.params import ShapeConfig
    from blasr_tpu_torch.sim import random_genome, simulate_reads
    reads, genome, _ = worlds["small"]
    out = {"small": (build_genome_index(list(read_sequences(genome)), k=12),
                     list(read_sequences(reads))[:5],
                     ShapeConfig(buckets=(1024,), batch_size=5))}
    # test_flags.py::repeat_genome_world and its read
    g = random_genome(40_000, seed=31)[0].seq.copy()
    seg = g[5000:6500].copy()
    for pos in (15000, 25000, 35000):
        g[pos:pos + 1500] = seg
    out["repeat"] = (build_genome_index([FastaRecord("contig0", g)], k=12),
                     [FastaRecord("rep/9/0_1300", seg[100:1400].copy())],
                     ShapeConfig(buckets=(2048,), batch_size=1,
                                 occ_per_pos=1))
    # test_repetitive.py:139's tandem unit, a read inside the repeat
    rng = np.random.default_rng(4)
    unit = rng.integers(0, 4, 600).astype(np.int8)
    g = np.concatenate([np.tile(unit, 10),
                        rng.integers(0, 4, 5000).astype(np.int8)])
    out["tandem"] = (build_genome_index([FastaRecord("c", g)], k=12),
                     [FastaRecord("r", unit[:400])],
                     ShapeConfig(buckets=(512,), batch_size=1))
    # test_sdp_guide.py::desert_world
    contigs = random_genome(20_000, seed=77)
    g = contigs[0].seq
    desert = g[3000:3600].copy()
    desert[::10] = (desert[::10] + 1) % 4
    rs = np.concatenate([g[2000:3000], desert, g[3750:5000]])
    out["desert"] = (build_genome_index(contigs, k=12),
                     [FastaRecord("desert/1/0_%d" % len(rs), rs)],
                     ShapeConfig(buckets=(4096,), batch_size=1))
    # tests/conftest.py's genome and test_torch_options_weak.py's read
    contigs = random_genome(200_000, seed=42, n_contigs=2)
    frag = contigs[0].seq[3000:4000].copy()
    frag[::16] = (frag[::16] + 1) % 4
    rng = np.random.default_rng(1)
    m = rng.random(len(frag)) < 0.15
    frag[m] = (frag[m] + rng.integers(1, 4, int(m.sum()))) % 4
    out["weak"] = (build_genome_index(contigs, k=12),
                   [FastaRecord("weak/1/0_1000", frag)],
                   ShapeConfig(buckets=(1024,), batch_size=1, occ_per_pos=1,
                               max_anchors=64))
    # test_pipeline.py's world
    contigs = random_genome(120_000, seed=5, n_contigs=2)
    out["batch"] = (build_genome_index(contigs, k=12),
                    [s.rec for s in simulate_reads(
                        contigs, 20, read_len=(300, 900), accuracy=0.87,
                        seed=7)],
                    ShapeConfig(buckets=(1024,), batch_size=8,
                                max_anchors=256))
    return out


# (option, world, MappingParams fields, what the run's map_batch calls
# must show): the device-changing options of tests/test_torch_options_*.py
POLICY = dict(hit_policy="all", n_best=10)
OPTION_CASES = [
    ("--advanceExactMatches 5", "small", dict(advance_exact_matches=5),
     lambda a: a[0]["advance_exact"] == 5),
    ("--globalChainType 1", "small", dict(global_chain_type=1),
     lambda a: a[0]["global_chain"]),
    ("--nowarp", "small", dict(warp=False),
     lambda a: not a[0]["global_chain"]),
    ("--pvaltype 1", "small", dict(p_value_type=1),
     lambda a: a[0]["p_value_type"] == 1),
    ("--pvaltype 2", "small", dict(p_value_type=2),
     lambda a: a[0]["p_value_type"] == 2),
    ("--advanceHalf", "small", dict(advance_half=True),
     lambda a: a[0]["lookback"] == 256),
    ("--minExpand 2", "repeat", dict(min_expand=2, max_expand=2, **POLICY),
     lambda a: a[0]["O"] > 1),
    ("--maxAnchorsPerPosition 64 (emit-all)", "repeat",
     dict(max_anchors_per_position=64, **POLICY),
     lambda a: a[0]["O"] == 64),
    ("the ambiguity rescue's deep pass", "tandem", {},
     lambda a: a[-1]["full_widen"] and a[-1]["C"] >= 32
     and a[-1]["A"] >= 2048),
    ("--fastSDP --sdpTupleSize 8", "desert",
     dict(sdp_tuple_size=8, fast_sdp=True),
     lambda a: a == [dict(a[0], k_sdp=8, sdp_occ=1)]),
    ("--useSensitiveSearch", "weak", dict(do_sensitive_search=True),
     lambda a: [(x["O"], x["A"], x["advance_exact"]) for x in a]
     == [(1, 64, 0), (2, 128, 0)]),
]


@contextlib.contextmanager
def batch_call_args():
    """The map_batch kwargs Mapper._batch_call_args builds while the block
    runs: [the OPTION_KWARGS of each distinct call, in call order]."""
    from blasr_tpu_torch.pipeline.map_read import Mapper
    seen, orig = [], Mapper._batch_call_args

    def rec(self, L, tb_cap=0):
        pos, kw = orig(self, L, tb_cap)
        args = {k: kw[k] for k in OPTION_KWARGS}
        if args not in seen:
            seen.append(args)
        return pos, kw
    Mapper._batch_call_args = rec
    try:
        yield seen
    finally:
        Mapper._batch_call_args = orig


def phase_options(d, worlds, cuda_ops):
    """C15 on the card: each device-changing option of
    tests/test_torch_options_*.py mapped on cuda (launch counts zeroed
    just before and read just after: K1 and every PATH_KERNELS kernel)
    and held to the same run on cpu, every alignment's fields and the
    option's map_batch arguments; batch-size invariance (batch 3 against
    batch 8) on cuda; then the small world through the CLI on the port
    sawriter's ``--sa`` index, cuda against cpu."""
    from blasr_tpu_torch.cli.blasr import run as cli
    from blasr_tpu_torch.params import MappingParams
    from blasr_tpu_torch.pipeline.map_read import Mapper
    ow = option_worlds(worlds)
    kernels = ("banded_dp",) + PATH_KERNELS

    def mapped(world, p, device, cfg=None):
        gi, recs, c = ow[world]
        with batch_call_args() as args:
            out = mapper_fields(Mapper(gi, p, cfg or c, device=device)
                                .map_reads(recs))
        return out, args

    for label, world, kw, shows in OPTION_CASES:
        p = MappingParams(**kw).make_sane()
        cuda_ops.reset_launch_counts()
        t0 = time.time()
        on_card, card_args = mapped(world, p, "cuda")
        torch.cuda.synchronize()
        launches = {k: cuda_ops.LAUNCHES[k] for k in kernels}
        t1 = time.time()
        on_cpu, cpu_args = mapped(world, p, "cpu")
        log(f"# {label} ({world} world): {sum(map(len, on_card))} "
            f"alignments of {len(on_card)} reads; cuda == cpu: "
            f"{on_card == on_cpu} (cuda {t1 - t0:.1f}s, cpu "
            f"{time.time() - t1:.1f}s); map_batch calls {card_args}; "
            f"launches {launches}")
        assert on_card == on_cpu, f"{label}: cuda and cpu differ"
        assert card_args == cpu_args and shows(card_args), \
            f"{label}: map_batch arguments {card_args}"
        assert all(on_card), f"{label}: a read did not map"
        assert all(launches.values()), f"{label}: launches {launches}"
    c = ow["batch"][2]
    p = MappingParams().make_sane()
    cuda_ops.reset_launch_counts()
    t0 = time.time()
    by8, _ = mapped("batch", p, "cuda")
    by3, _ = mapped("batch", p, "cuda", dataclasses.replace(c, batch_size=3))
    launches = {k: cuda_ops.LAUNCHES[k] for k in kernels}
    log(f"# batch-size invariance on cuda (20 reads, batch 8 and 3): "
        f"identical {by8 == by3} ({time.time() - t0:.1f}s); launches "
        f"{launches}")
    assert by8 == by3 and all(launches.values())
    # the port's own sawriter index through --sa
    reads, genome, _ = worlds["small"]
    sa = tools_index(os.path.join(d, "tools"), genome, "--sa")
    text = {}
    for device in ("cuda", "cpu"):
        cuda_ops.reset_launch_counts()
        t0 = time.time()
        out = os.path.join(d, f"out.sa.{device}.m4")
        assert cli([reads, genome, "-m", "4", "--sa", sa, "--out", out,
                    "--device", device]) == 0
        text[device] = open(out).read()
        launches = {k: cuda_ops.LAUNCHES[k] for k in kernels}
        log(f"# --sa (the port's sawriter index), small world on {device}: "
            f"{len(text[device].splitlines())} lines "
            f"({time.time() - t0:.1f}s); launches {launches}")
        if device == "cuda":
            assert all(launches.values()), launches
    assert text["cuda"] and text["cuda"] == text["cpu"], \
        "--sa: cuda and cpu differ"
    log("# --sa on cuda == cpu: True")


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


# ---------------------------------------------------------------- pairwise

SDP_FLAGS = ["-printSimilarity", "-local", "-noRefine", "-showalign",
             "-fixedtarget", "-printsw"]
SW_FLAGS = ["-local", "-showalign", "-fixedtarget"]


def mutate_seq(rng, seq, sub=0.05, ins=0.03, dele=0.03):
    """tests/test_sdp_sw.py::mutate (copied: that file imports JAX)."""
    out = []
    for b in seq:
        u = rng.random()
        if u < dele:
            continue
        if u < dele + ins:
            out.append(rng.integers(0, 4))
        if rng.random() < sub:
            out.append((b + 1 + rng.integers(0, 3)) % 4)
        else:
            out.append(b)
    return np.asarray(out, dtype=np.int8)


def pairwise_worlds(d):
    """{name: (queries.fa, targets.fa)}: tests/test_sdp_sw.py's worlds
    (test_tools_cli's, with tests/test_torch_pairwise_cli.py's unrelated
    second pair; the eight planted spans of test_sdp_recovers_planted_span;
    the planted block of test_sdp_local_vs_global_spans and of
    test_sw_local_finds_planted_block) and 64 pairs of 1-2 kb reads at
    85% accuracy against 2,170 b targets (Lq 2048, Lt 2304)."""
    from blasr_tpu_torch.io.fasta import FastaRecord, write_fasta
    worlds = {}

    def put(name, qs, ts):
        paths = (os.path.join(d, f"pw_{name}_q.fa"),
                 os.path.join(d, f"pw_{name}_t.fa"))
        write_fasta(paths[0], [FastaRecord(f"q{i}", q)
                               for i, q in enumerate(qs)])
        write_fasta(paths[1], [FastaRecord(f"t{i}", t)
                               for i, t in enumerate(ts)])
        worlds[name] = paths

    rng = np.random.default_rng(23)
    t = rng.integers(0, 4, 400).astype(np.int8)
    q = mutate_seq(rng, t[50:350])
    other = np.random.default_rng(29)
    put("tools", [q, other.integers(0, 4, 250).astype(np.int8)],
        [t, other.integers(0, 4, 380).astype(np.int8)])
    rng = np.random.default_rng(5)
    qs, ts = [], []
    for _ in range(8):
        target = rng.integers(0, 4, 511).astype(np.int8)
        pos = int(rng.integers(0, 511 - 220))
        qs.append(mutate_seq(rng, target[pos:pos + 200])[:256])
        ts.append(target)
    put("planted", qs, ts)
    rng = np.random.default_rng(9)
    target = rng.integers(0, 4, 383).astype(np.int8)
    put("local-global", [np.concatenate([
        rng.integers(0, 4, 30).astype(np.int8), target[100:180],
        rng.integers(0, 4, 18).astype(np.int8)])], [target])
    rng = np.random.default_rng(17)
    t = rng.integers(0, 4, 300).astype(np.int8)
    put("sw-local", [np.concatenate([
        rng.integers(0, 4, 20).astype(np.int8), t[100:160],
        rng.integers(0, 4, 20).astype(np.int8)])], [t])
    rng = np.random.default_rng(64)
    qs, ts = [], []
    for n in range(64):
        tlen, qlen = 2170, (2040 if n == 0 else int(rng.integers(1000,
                                                                 2000)))
        t = rng.integers(0, 4, tlen).astype(np.int8)
        pos = 0 if n == 0 else int(rng.integers(0, tlen - qlen))
        # 85% accuracy: 5% each of substitutions, insertions, deletions
        qs.append(mutate_seq(rng, t[pos:], 0.05, 0.05, 0.05)[:qlen])
        ts.append(t)
    put("pairs64", qs, ts)
    return worlds


def tool_output(run, argv) -> str:
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert run(argv) == 0, f"exit of {argv}"
    return buf.getvalue()


@contextlib.contextmanager
def no_plain_members():
    """Fail if chain_members_plain meets a CUDA tensor in the block (the
    card's paths launch K7)."""
    from blasr_tpu_torch.kernels import chain
    inner = chain.chain_members_plain

    def guard(cands, *a, **kw):
        assert cands.end_idx.device.type != "cuda", \
            "chain_members ran as plain torch on CUDA tensors"
        return inner(cands, *a, **kw)

    chain.chain_members_plain = guard
    try:
        yield
    finally:
        chain.chain_members_plain = inner


def sdp_arrays(world) -> list:
    """sdp_align's host arguments for a pairwise world's pairs as
    sdpMatcher forms them: queries, their lengths, targets shifted by one
    base, their lengths."""
    from blasr_tpu_torch.io.fasta import read_fasta
    from blasr_tpu_torch.params import round_up
    qs, ts = (read_fasta(p) for p in world)
    N = len(qs)
    Lq = round_up(max(len(q.seq) for q in qs), 64)
    Lt = round_up(max(len(t.seq) for t in ts) + 129, 128)
    qarr = np.full((N, Lq), 4, np.int8)
    tarr = np.full((N, Lt), 4, np.int8)
    for n, (q, t) in enumerate(zip(qs, ts)):
        qarr[n, :len(q.seq)] = q.seq
        tarr[n, 1:1 + len(t.seq)] = t.seq
    ql = np.array([len(q.seq) for q in qs], np.int32)
    tl = np.array([len(t.seq) + 1 for t in ts], np.int32)
    return [torch.from_numpy(a) for a in (qarr, ql, tarr, tl)]


def sdp_member_call():
    """The chain_members call of sdp_align on the 64-pair world (B = 64
    pairs, C = 1, M = 256, A = max_frags = 1024), captured as it makes it:
    (args, kwargs, K7's result)."""
    from blasr_tpu_torch.kernels import sdp
    with tempfile.TemporaryDirectory() as d:
        args = [a.cuda() for a in sdp_arrays(pairwise_worlds(d)["pairs64"])]
    calls = []
    inner = capture_calls(sdp, "chain_members", calls)
    try:
        sdp.sdp_align(*args)
        torch.cuda.synchronize()
    finally:
        sdp.chain_members = inner
    assert len(calls) == 1, f"sdp_align made {len(calls)} member calls"
    return calls[0]


def sdp_align_timing(card, world):
    """sdp_align on the 64-pair world's pairs as sdpMatcher forms them, on
    the card (ms per pair, events around five calls) and on the CPU (one
    call), beside its bound per pair: the sequences and lengths read
    once, the SDPResult written once, and K3's operations on this run's
    predecessor tests (the fragment match's sort and searches are under
    a microsecond of the float32 peak)."""
    from blasr_tpu_torch.kernels import sdp
    host = sdp_arrays(world)
    N, Lq = host[0].shape
    Lt = host[2].shape[1]
    args = [a.cuda() for a in host]
    calls = []
    inner = capture_calls(sdp, "chain_anchors", calls)
    try:
        res = sdp.sdp_align(*args)
        torch.cuda.synchronize()
    finally:
        sdp.chain_anchors = inner
    anchors = calls[0][0][0]
    kb, pairs = k3_bound(anchors, 1, 0)
    M = res.mq.shape[1]
    sb = bound(N * (Lq + Lt + 8) + N * (7 * 8 + 1 + 25 * M),
               K3_OPS_PER_PAIR * pairs)
    ms = cuda_ms(lambda: sdp.sdp_align(*args), 5)
    t0 = time.perf_counter()
    cpu = sdp.sdp_align(*host)
    cpu_ms = 1e3 * (time.perf_counter() - t0)
    for f, a, b in zip(sdp.SDPResult._fields, res, cpu):
        assert torch.equal(a.cpu(), b), f"sdp_align {f}: card != cpu"
    log(f"# sdp_align (N={N}, Lq={Lq}, Lt={Lt}, "
        f"{int(anchors.valid.sum())} fragments, {pairs:.0f} predecessor "
        f"tests): card == cpu, every field; {ms / N:.5f} ms a pair on the "
        f"card ({ms:.3f} ms a call), {cpu_ms / N:.3f} ms a pair on the "
        f"CPU; bound {sb[0] / N:.6f} ms a pair ({sb[1]}; at 1024 "
        f"fragments a pair {1e3 * K3_OPS_PER_PAIR * 1024 * 1023 / 2 / F32_OPS:.6f}) on {card}")


def phase_pairwise(d, cuda_ops):
    """sdpMatcher and swMatcher through the port's CLIs: sdpMatcher on the
    card and with --device cpu, stdout byte for byte, on
    tests/test_sdp_sw.py's worlds under each of its six flags and all of
    them, and on the 64-pair world (Lq 2048, Lt 2304) refining and not;
    each card run launches K3 and K7 (and, refining, K6, K1 and K2)
    and never the plain chain_members.  swMatcher, host NumPy with no
    device path, runs on the same worlds.  Then sdp_align's ms per pair
    on the card."""
    from blasr_tpu_torch.cli import sdp_matcher, sw_matcher
    worlds = pairwise_worlds(d)
    runs = [(w, [f]) for w in ("tools", "planted", "local-global",
                               "sw-local") for f in SDP_FLAGS]
    runs += [(w, SDP_FLAGS) for w in ("tools", "planted", "local-global",
                                      "sw-local")]
    runs += [("pairs64", ["-printSimilarity", "-showalign"]),
             ("pairs64", ["-noRefine", "-fixedtarget", "-printSimilarity"])]
    t_card = t_cpu = 0.0
    with no_plain_members():
        for world, flags in runs:
            argv = [*worlds[world], "11", *flags]
            cuda_ops.reset_launch_counts()
            t0 = time.time()
            card_out = tool_output(sdp_matcher.run,
                                   argv + ["--device", "cuda"])
            t1 = time.time()
            n = dict(cuda_ops.LAUNCHES)
            cpu_out = tool_output(sdp_matcher.run, argv + ["--device",
                                                           "cpu"])
            t_card, t_cpu = t_card + t1 - t0, t_cpu + time.time() - t1
            assert card_out == cpu_out, \
                f"sdpMatcher {world} {flags}: card != cpu"
            assert card_out.count("\n") > 1
            want = (("chain_scan", "chain_members")
                    + (() if "-noRefine" in flags else
                       ("band_offsets", "banded_dp", "banded_traceback")))
            assert all(n[k] == 1 for k in want) and sum(n.values()) == \
                len(want), f"sdpMatcher {world} {flags} launched {n}"
            if world == "pairs64":
                log(f"# sdpMatcher pairs64 {' '.join(flags)}: card == cpu "
                    f"({card_out.count(chr(10))} lines; card "
                    f"{t1 - t0:.1f}s, cpu {time.time() - t1:.1f}s); "
                    f"launches {n}")
    log(f"# sdpMatcher: {len(runs)} runs card == cpu byte for byte "
        f"(card {t_card:.1f}s, cpu {t_cpu:.1f}s in all); K3, K7 and, "
        f"refining, K6, K1, K2 launched once a run, chain_members never "
        f"plain on the card")
    n_sw, t0 = 0, time.time()
    for world in ("tools", "planted", "local-global", "sw-local"):
        for flags in [[f] for f in SW_FLAGS] + [SW_FLAGS]:
            out = tool_output(sw_matcher.run, [*worlds[world], *flags])
            assert out.startswith("qlen tlen score") and out.count("\n") > 2
            n_sw += 1
    log(f"# swMatcher: {n_sw} runs in {time.time() - t0:.1f}s (host NumPy: "
        f"one path for card and CPU alike; held to the JAX CLI in "
        f"tests/test_torch_pairwise_cli.py)")
    with no_plain_members():
        sdp_align_timing(card_line(), worlds["pairs64"])


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
    _band_offsets call of the run, dispatched eagerly
    (``graphs.eager_dispatch()``), is captured, and its kernel's result
    held to the plain version on the same CUDA tensors (K6's rows in its
    global scratch there); then the same reads through graphs, each
    dispatch a replay, give the eager run's alignments."""
    from blasr_tpu_torch.kernels.anchor import Anchors, find_anchors_plain
    from blasr_tpu_torch.pipeline import graphs, map_read
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
        with graphs.eager_dispatch():
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
        out.n_pairs.shape[0] > 0 for _, _, out in k2_calls), launches
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
    # as one batch: the time of the longest walk, not the sum of them; it
    # walks host copies (a step's ~30 small ops cost a few microseconds on
    # the host, each a launch on the card)
    # each call's walked rows (map_batch's tb_rows) gathered from its
    # result and arguments
    walks, groups = [], {}
    for i, (a, kw, out) in enumerate(k2_calls):
        assert a[0].tbbits.is_cuda and a[0].tbbits.shape[1] == 65536, \
            f"long-read K2 call {i + 1} is not at L = 65536"
        kw = dict(kw)
        rows = kw.pop("rows", None)
        if rows is not None:
            a = (BandedResult(*(x[rows] for x in a[0])),
                 *(x[rows] for x in a[1:6]))
        walks.append((a, kw))
        key = (tuple(a[0].tbbits.shape[1:]), tuple(sorted(kw.items())))
        groups.setdefault(key, []).append(i)
    for idx in groups.values():
        args = [walks[i][0] for i in idx]
        res = BandedResult(*(torch.cat([getattr(a[0], f) for a in args])
                             .cpu() for f in BandedResult._fields))
        ref = banded_traceback_plain(
            res, *(torch.cat([a[j] for a in args]).cpu()
                   for j in range(1, 6)), **walks[idx[0]][1])
        start = 0
        for i in idx:
            out = k2_calls[i][2]
            n = walks[i][0][0].tbbits.shape[0]
            for f in out._fields:
                assert torch.equal(getattr(out, f).cpu(),
                                   getattr(ref, f)[start:start + n]), \
                    f"K2 long-read call {i + 1}: {f} differs from the plain"
            start += n
    log(f"# K2 == plain on the long reads' {len(k2_calls)} banded_traceback "
        f"call(s) (N={[o.n_pairs.shape[0] for _, _, o in k2_calls]}, "
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
        f"{long_wall:.1f}s on {card} (eager dispatch); launches {launches}")
    assert all(launches[k] > 0 for k in PATH_KERNELS + ("banded_dp",)), \
        f"kernels not launched (long reads): {launches}"
    graphs.reset_counts()
    t0 = time.time()
    got = (mapper_fields(mapper.map_reads([s.rec for s in sims]))
           + mapper_fields([mapper.map_reads([long_sim.rec])[0]]))
    torch.cuda.synchronize()
    calls = dict(graphs.DISPATCHES)
    log(f"# long reads through graphs in {time.time() - t0:.1f}s: "
        f"dispatches {calls}, captures "
        + json.dumps([{k: (round(v, 1) if isinstance(v, float) else v)
                       for k, v in c.items()} for c in graphs.CAPTURES]))
    assert got == mapper_fields(per_read) + mapper_fields([long_alns]), \
        "the long reads' graph replays differ from eager dispatch"
    check_replays(calls, "long reads")


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


# the bench passes: "distance", "qv" (--useQuality) and "affine"
# (--affineAlign), by label, the K1 mode each must launch and its
# MappingParams; then the modes phase 5 traces once more, one pass each,
# for the in-graph device time of a kernel mode no bench pass runs (K1's
# GEN forms under SCORE_MATRIX, K5's block mode)
BENCH_MODES = {"distance": ("distance", "banded_dp", {}),
               "qv": ("--useQuality", "banded_dp_qv",
                      dict(ignore_qualities=False)),
               "affine": ("--affineAlign", "banded_dp_hp",
                          dict(affine_align=True)),
               "gen": ("--scoreMatrix", "banded_dp_gen", dict(gen=True)),
               "qv_gen": ("--scoreMatrix --useQuality", "banded_dp_qv_gen",
                          dict(gen=True, ignore_qualities=False)),
               "hp_gen": ("--scoreMatrix --affineAlign", "banded_dp_hp_gen",
                          dict(gen=True, affine_align=True)),
               "block": ("occ_block_sample", "banded_dp", {})}


def bench_inputs(sims, mode: str):
    """The bench pass's reads and parameters in ``mode`` (BENCH_MODES): the
    reads as simulated or, under ``--useQuality``, with per-base qualities
    8-39, drawn as make_fastq draws them."""
    from blasr_tpu_torch.io.fasta import FastaRecord
    from blasr_tpu_torch.params import MappingParams
    kw = dict(BENCH_MODES[mode][2])
    if kw.pop("gen", False):
        kw["score_matrix"] = SCORE_MATRIX
    recs = [s.rec for s in sims]
    if not kw.get("ignore_qualities", True):
        rng = np.random.default_rng(13)
        recs = [FastaRecord(r.title, r.seq, rng.integers(8, 40, len(r.seq)))
                for r in recs]
    return recs, MappingParams(**kw).make_sane()


def log_captures(card, what: str) -> None:
    """Each graph captured since ``graphs.reset_counts()``: its key's L,
    batch and tb_cap, the capture's ms and the bytes the index's pool grew
    by (``torch.cuda.memory_reserved`` before and after)."""
    from blasr_tpu_torch.pipeline import graphs
    for c in graphs.CAPTURES:
        log(f"# capture ({what}): L={c['L']} batch={c['batch']} "
            f"tb_cap={c['tb_cap']} qv={int(c['use_qv'])} "
            f"hp={int(c['use_hp'])}: {c['ms']:.2f} ms, pool "
            f"+{c['pool_bytes'] / 2**20:.1f} MiB on {card}")


def placed_count(sims, per_read) -> int:
    """The reads whose best alignment (lowest score) lies on the read's
    strand and overlaps its simulated interval."""
    placed = 0
    for s, alns in zip(sims, per_read):
        if not alns:
            continue
        best = min(alns, key=lambda a: a.score)
        if (best.strand == s.strand and best.tstart < s.tend
                and best.tend > s.tstart):
            placed += 1
    return placed


def phase_bench(card, cuda_ops, gi, sims, mode: str, dev=None):
    """One bench pass in ``mode`` (BENCH_MODES) on the device index ``dev``,
    through graphs: a warm pass, which captures every key the pass
    dispatches (each capture logged), then the timed pass with launch
    counts and dispatches zeroed just before and read just after, every
    dispatch a replay, then one more pass under StageTimer for the
    per-stage device time (each replay waits for its marks there, so
    reads/s comes from the timed pass); returns the launch counts."""
    from blasr_tpu_torch.params import ShapeConfig
    from blasr_tpu_torch.pipeline import graphs
    from blasr_tpu_torch.pipeline.map_read import Mapper, StageTimer
    from blasr_tpu_torch.pipeline.metrics import MappingMetrics

    label, dp, _ = BENCH_MODES[mode]
    recs, params = bench_inputs(sims, mode)
    if mode == "affine":
        seqs = [np.asarray(r.seq) for r in recs]
        hp = sum(int(((q[1:] == q[:-1]) & (q[:-1] < 4)).sum()) for q in seqs)
        log(f"# bench ({label}): {hp / sum(len(q) for q in seqs):.4f} of the "
            f"reads' bases repeat the one before (K1-HP's hp_ok rows)")
    t0 = time.time()
    cfg = ShapeConfig(buckets=(1024, 2048), batch_size=32, max_anchors=512)
    mapper = Mapper(gi, params, cfg, device="cuda", dev=dev)
    torch.cuda.synchronize()
    log(f"# phase 4 ({label}): mapper + device index {time.time()-t0:.1f}s")

    graphs.reset_counts()
    t0 = time.time()
    mapper.map_reads(recs)                      # warm: captures the graphs
    torch.cuda.synchronize()
    log(f"# warm pass {time.time()-t0:.1f}s: dispatches "
        f"{json.dumps(graphs.DISPATCHES)}")
    log_captures(card, label)

    mapper.metrics = MappingMetrics()
    cuda_ops.reset_launch_counts()
    graphs.reset_counts()
    with no_plain_members():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        per_read = mapper.map_reads(recs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = dict(cuda_ops.LAUNCHES)
    walks = cuda_ops.INDEXED_WALKS
    calls = dict(graphs.DISPATCHES)
    clocks, counters = dict(mapper.metrics.clocks), dict(
        mapper.metrics.counters)
    with StageTimer() as st:
        mapper.map_reads(recs)
    stages = st.totals()
    rps = len(recs) / wall
    placed = placed_count(sims, per_read)
    frac = placed / len(recs)
    log(f"# bench ({label}): {len(recs)} reads in {wall:.3f}s = {rps:.2f} "
        f"reads/s on {card} (graph replays); placed {placed}/{len(recs)} "
        f"({100 * frac:.1f}%)")
    log(f"# per-stage device ms ({label}; graph replays, the stage marks "
        "event nodes of each graph, summed over batches): "
        + json.dumps({k: round(v, 3) for k, v in stages.items()}))
    log("# host clocks (s): " + json.dumps(
        {k: round(v, 6) for k, v in clocks.items()})
        + " counters: " + json.dumps(counters))
    log(f"# main-path launches ({label}): {launches}; dispatches "
        f"{json.dumps(calls)}")
    assert frac >= 0.95, f"only {100 * frac:.1f}% of reads placed ({label})"
    check_replays(calls, f"bench ({label})")
    assert calls["captures"] == 0, f"the timed pass captured: {calls}"
    assert launches[dp] > 0 and launches["banded_traceback"] > 0, \
        f"a kernel of the {label} path was not launched: {launches}"
    others = [k for k in launches if k.startswith("banded_dp") and k != dp]
    assert not any(launches[k] for k in others), \
        f"the {label} path launched another K1 mode: {launches}"
    log(f"# {label}: {launches[dp] / len(recs):.4f} {dp} launches per read, "
        f"{sum(launches.values()) / len(recs):.4f} hand-written kernel "
        f"launches per read")
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
    assert launches["chain_members"] == dispatches, \
        f"K7 launches {launches['chain_members']} != {dispatches} dispatches"
    # every K2 launch of map_batch walks the traced rows through tb_rows
    assert walks == launches["banded_traceback"] == \
        counters.get("indexed_walks"), \
        f"indexed walks {walks} (counter {counters.get('indexed_walks')}) " \
        f"!= K2 launches {launches['banded_traceback']}"
    return dict(launches, indexed_walks=walks)


def run_bucket_serial(self, recs, bucket: int, batch: int):
    """PR 9's Mapper._run_bucket, for the comparison of phase 4: one batch
    at a time, inputs copied from pageable memory, the result fetched
    and collected before the next batch is dispatched.  Each batch goes
    through ``graphs.dispatch`` as the Mapper's do (eager inside
    ``graphs.eager_dispatch()``), so its counters are the Mapper's."""
    from blasr_tpu_torch.pipeline import graphs
    from blasr_tpu_torch.pipeline.map_read import unpack_batch
    cfg = self.cfg
    L = bucket
    T = L + cfg.window_len(L)
    out = []

    def dispatch(arr_d, lens_d, tb_cap=0, qv=None):
        pos, kw = self._batch_call_args(L, tb_cap)
        return graphs.dispatch(self.dev, arr_d, lens_d, pos, kw, qv,
                               self.qv_rescore)

    for base in range(0, len(recs), batch):
        group = recs[base:base + batch]
        arr = np.full((batch, L), 4, dtype=np.int8)
        lens = np.zeros(batch, dtype=np.int32)
        for i, r in enumerate(group):
            n = min(len(r.seq), L)
            arr[i, :n] = r.seq[:n]
            lens[i] = n
        arr_d = torch.from_numpy(arr).to(self.device)
        lens_d = torch.from_numpy(lens).to(self.device)
        qv = None
        if self.use_qv:
            qv = tuple(torch.from_numpy(q).to(self.device)
                       for q in self.pack_qv_rows(group, batch, L))
        with self.metrics.clock("mapToGenome"):
            res = dispatch(arr_d, lens_d, qv=qv)
        with self.metrics.clock("collectAlignments"):
            res = unpack_batch(res)
            if (res.overflow & res.valid & (res.dp_slot >= 0)).any():
                with self.metrics.clock("mapToGenome"):
                    res = unpack_batch(dispatch(arr_d, lens_d, tb_cap=T,
                                                qv=qv))
            out.extend(self._collect_batch(res, group, lens, batch))
        self.metrics.add("numReads", len(group))
        self.metrics.add("totalAnchors", int(res.n_anchors.sum()))
        self.metrics.add("totalCandidates", int(res.valid.sum()))
        self.metrics.add(
            "cells", int((res.q_end - res.q_start)[res.valid].sum())
            * cfg.band_width)
    return out


def compare_lookahead(card, gi, sims, dev, rounds: int = 3):
    """Reads/s of the distance bench pass under PR 9's serial _run_bucket
    (A) and the lookahead of four (B), both dispatched eagerly
    (``graphs.eager_dispatch()``), in turns A B B A, three rounds, after a
    warm pass of each, on one Mapper; the alignments and MappingMetrics
    counters of every pass held equal."""
    from blasr_tpu_torch.params import ShapeConfig
    from blasr_tpu_torch.pipeline import graphs
    from blasr_tpu_torch.pipeline.map_read import Mapper
    from blasr_tpu_torch.pipeline.metrics import MappingMetrics
    recs, params = bench_inputs(sims, "distance")
    cfg = ShapeConfig(buckets=(1024, 2048), batch_size=32, max_anchors=512)
    mapper = Mapper(gi, params, cfg, device="cuda", dev=dev)
    ahead = Mapper._run_bucket

    def one(serial: bool):
        Mapper._run_bucket = run_bucket_serial if serial else ahead
        try:
            mapper.metrics = MappingMetrics()
            torch.cuda.synchronize()
            with graphs.eager_dispatch():
                t0 = time.perf_counter()
                per_read = mapper.map_reads(recs)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        finally:
            Mapper._run_bucket = ahead
        return (len(recs) / wall, mapper_fields(per_read),
                dict(mapper.metrics.counters))

    one(True), one(False)
    order = (True, False, False, True) * rounds
    runs = [one(serial) for serial in order]
    assert all(r[1:] == runs[0][1:] for r in runs), \
        "the lookahead changed the bench pass's alignments or counters"
    a = [r[0] for r, serial in zip(runs, order) if serial]
    b = [r[0] for r, serial in zip(runs, order) if not serial]
    log(f"# bench (distance, eager dispatch), reads/s in turns A B B A x "
        f"{rounds}, A = the serial _run_bucket, B = the lookahead: "
        + ", ".join(f"{'A' if serial else 'B'} {r[0]:.2f}"
                    for r, serial in zip(runs, order))
        + f"; mean A {sum(a) / len(a):.2f}, B {sum(b) / len(b):.2f} "
        f"(alignments and counters equal) on {card}")


def compare_graphs(card, gi, sims, dev, rounds: int = 5):
    """Reads/s of the distance bench pass dispatched eagerly (A, inside
    ``graphs.eager_dispatch()``) and as graph replays (B), both with the
    lookahead of four, in turns A B B A, ``rounds`` rounds, after a warm
    pass of each (B's captures its graphs), on one Mapper: every pass
    printed, the alignments and MappingMetrics counters of every pass held
    equal, each arm's median and spread (max - min)."""
    import statistics
    from blasr_tpu_torch.params import ShapeConfig
    from blasr_tpu_torch.pipeline import graphs
    from blasr_tpu_torch.pipeline.map_read import Mapper
    from blasr_tpu_torch.pipeline.metrics import MappingMetrics
    recs, params = bench_inputs(sims, "distance")
    cfg = ShapeConfig(buckets=(1024, 2048), batch_size=32, max_anchors=512)
    mapper = Mapper(gi, params, cfg, device="cuda", dev=dev)

    def one(eager: bool):
        mapper.metrics = MappingMetrics()
        torch.cuda.synchronize()
        with (graphs.eager_dispatch() if eager
              else contextlib.nullcontext()):
            t0 = time.perf_counter()
            per_read = mapper.map_reads(recs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        clocks = mapper.metrics.clocks
        return (len(recs) / wall, mapper_fields(per_read),
                dict(mapper.metrics.counters),
                (clocks.get("mapToGenome", 0.0),
                 clocks.get("collectAlignments", 0.0)))

    one(True), one(False)
    order = (True, False, False, True) * rounds
    graphs.reset_counts()
    runs = [one(eager) for eager in order]
    assert all(r[1:3] == runs[0][1:3] for r in runs), \
        "graph replays changed the bench pass's alignments or counters"
    assert graphs.DISPATCHES["captures"] == 0, graphs.DISPATCHES
    arms = {}
    for name, eager in (("A", True), ("B", False)):
        rps = [r[0] for r, e in zip(runs, order) if e == eager]
        arms[name] = dict(
            median=statistics.median(rps), spread=max(rps) - min(rps),
            clocks=[statistics.median(r[3][i] for r, e in zip(runs, order)
                                      if e == eager) for i in range(2)])
    log(f"# bench (distance), reads/s in turns A B B A x {rounds}, A = "
        f"eager dispatch, B = graph replays, both with the lookahead: "
        + ", ".join(f"{'A' if e else 'B'} {r[0]:.2f}"
                    for r, e in zip(runs, order))
        + "; " + "; ".join(
            f"{n}: median {v['median']:.2f}, spread {v['spread']:.2f}, "
            f"median mapToGenome {v['clocks'][0]:.4f} s, collectAlignments "
            f"{v['clocks'][1]:.4f} s" for n, v in arms.items())
        + f" (alignments and counters equal) on {card}")


# the CUDA runtime calls that make the host wait on the device
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy", "cudaMemcpy2D",
              "aten::_local_scalar_dense")
# the runtime calls that put work on a stream: kernel and graph launches,
# copies and fills
LAUNCH_API = ("cudaLaunch", "cuLaunch", "cudaGraphLaunch", "cudaMemcpy",
              "cudaMemset")


# the modes phase 5 traces once more each, and the traced pass (and its
# launch key) that gives each launch key's in-graph device time where that
# is not the distance pass's own
PROFILE_MODES = ("gen", "qv_gen", "hp_gen", "block")
GRAPH_PASS = {"banded_dp_qv": ("qv", "banded_dp_qv"),
              "banded_dp_hp": ("affine", "banded_dp_hp"),
              "banded_dp_gen": ("gen", "banded_dp_gen"),
              "banded_dp_qv_gen": ("qv_gen", "banded_dp_qv_gen"),
              "banded_dp_hp_gen": ("hp_gen", "banded_dp_hp_gen"),
              "anchor_search_block": ("block", "anchor_search")}


def syncs_in_dispatch(prof) -> tuple:
    """(dispatches, host waits inside them, runtime calls inside them,
    launch calls inside them, launch calls in the whole pass) in a
    profiled pass whose dispatches are marked by
    ``torch.profiler.record_function("dispatch")``: the waits are the
    SYNC_CALLS (aten::_local_scalar_dense is a tensor read as a Python
    value), the launch calls the LAUNCH_API ones."""
    evs = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CPU]
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in evs if e.name == "dispatch")
    waits, calls, launch_in, launch_all = {}, 0, 0, 0
    for e in evs:
        launch = e.name.startswith(LAUNCH_API)
        launch_all += launch
        t = e.time_range.start
        if not any(a <= t <= b for a, b in spans):
            continue
        if e.name.startswith("cu"):
            calls += 1
        launch_in += launch
        if e.name in SYNC_CALLS:
            waits[e.name] = waits.get(e.name, 0) + 1
    return len(spans), waits, calls, launch_in, launch_all


def phase_profile(card, gi, sims, dev, mode: str = "distance",
                  eager: bool = False):
    """torch.profiler over one more bench pass in ``mode`` (BENCH_MODES),
    after a warm pass (the first 64 reads, or all of them in a mode of
    PROFILE_MODES, whose graphs no earlier pass captured), through graphs
    or, with ``eager``, dispatched
    eagerly: the host's launch calls per read and per dispatch, kernels per
    read, device time against the traced wall (the device's busy share),
    host waits inside a dispatch (must be none), the kernels that take the
    most device time and each hand-written kernel's device ms per call."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from blasr_tpu_torch.params import ShapeConfig
    from blasr_tpu_torch.pipeline import graphs
    from blasr_tpu_torch.pipeline.map_read import Mapper
    label = BENCH_MODES[mode][0] + (", eager dispatch" if eager
                                    else ", graph replays")
    cfg = ShapeConfig(buckets=(1024, 2048), batch_size=32, max_anchors=512,
                      occ_block_sample=mode == "block")
    recs, params = bench_inputs(sims, mode)
    mapper = Mapper(gi, params, cfg, device="cuda", dev=dev)
    arm = graphs.eager_dispatch() if eager else contextlib.nullcontext()
    inner = graphs.dispatch

    def marked(*a, **kw):
        with record_function("dispatch"):
            return inner(*a, **kw)

    with arm:
        # a mode no bench pass ran has no graphs yet: capture them all
        mapper.map_reads(recs if mode in PROFILE_MODES else recs[:64])
        torch.cuda.synchronize()
        graphs.dispatch = marked
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                mapper.map_reads(recs)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        finally:
            graphs.dispatch = inner
    n_d, waits, calls, launch_in, launch_all = syncs_in_dispatch(prof)
    blocking = sum(waits.values())
    log(f"# profile ({label}): {n_d} dispatches, {calls} CUDA runtime "
        f"calls inside them, host waits inside them {waits}: "
        + ("not measured (no runtime calls recorded)" if not calls else
           f"{blocking / max(n_d, 1):.2f} per dispatch") + f"; launch API "
        f"calls ({'+'.join(LAUNCH_API)}) {launch_all / len(recs):.2f} per "
        f"read in the pass, {launch_in / max(n_d, 1):.2f} per dispatch "
        f"inside it on {card}")
    assert not calls or blocking == 0, \
        f"a dispatch waited on the device: {waits}"
    # (the dispatch marks appear on the device's timeline too: not work)
    dev_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and e.name != "dispatch"]
    if not dev_events:
        log(f"# profile ({label}): torch.profiler recorded no device "
            "events; device busy share not measured")
        return {}, {}
    by_name = {}
    for e in dev_events:
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    total_ms = sum(us for _, us in by_name.values()) / 1e3
    launches = sum(n for name, (n, _) in by_name.items()
                   if not name.startswith(("Memcpy", "Memset")))
    log(f"# profile ({label}, {len(recs)} reads, traced): {launches} kernel "
        f"launches ({launches / len(recs):.2f} per read), {total_ms:.3f} ms "
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
    return per_call, {name: n for name, (n, _) in by_name.items()}


# ---------------------------------------------------------------- phase 6

# the hand-written kernels of the bench's distance mode: each sharded run
# on the card launches every one
SHARDED_KERNELS = ("banded_dp",) + PATH_KERNELS
BATCH_FIELDS = ("ints", "ops", "clusters", "flat")


def mesh_static(pos, kw) -> dict:
    """map_batch's keywords for the mesh functions: the bench call's, with
    its thresholds (the positional arguments after the gap costs) named."""
    return dict(kw, sig_thresh=float(pos[2]),
                min_interval_weight=float(pos[3]), sdp_bypass=float(pos[4]))


def sharded_rank(job_path: str, rank: int) -> int:
    """``--sharded-rank JOB RANK``: one of two ranks of a gloo group at
    ``tcp://localhost:JOB["port"]``, both on this card.  Builds the bench
    world and its first batch of bucket 2048, then runs
    map_batch_ref_sharded on a (1, 2) mesh on cuda:0 and on the CPU (the
    plain versions) and map_batch_data_parallel on a (2, 1) mesh on cuda:0
    against the batch Mapper's replicated index; writes each run's batch
    to ``JOB["out"].rank<RANK>.npz`` and prints one ``SHARDED {json}``
    line: each run's wall seconds (host clock, to its batch's host copy)
    and the kernel launches it counted."""
    import torch.distributed as dist
    from blasr_tpu_torch.dist.mesh import (
        make_mesh, map_batch_data_parallel, map_batch_ref_sharded)
    from blasr_tpu_torch.kernels import cuda_ops
    with open(job_path) as f:
        job = json.load(f)
    torch.set_num_threads(4)
    dist.init_process_group("gloo", init_method="tcp://localhost:"
                            f"{job['port']}", rank=rank, world_size=2)
    try:
        t0 = time.perf_counter()
        gi, sims = bench_world()
        mapper, _, arr, lens, pos, kw = first_batch(gi, sims, "cuda")
        static = mesh_static(pos, kw)
        times = {"world": time.perf_counter() - t0}
        out, launches = {}, {}
        for name, shape, device in (("ref_cuda", (1, 2), "cuda"),
                                    ("ref_cpu", (1, 2), "cpu"),
                                    ("data_cuda", (2, 1), "cuda")):
            mesh = make_mesh(*shape, device=device)
            dist.barrier()
            cuda_ops.reset_launch_counts()
            t0 = time.perf_counter()
            if name.startswith("ref"):
                pb, offs, n_dp = map_batch_ref_sharded(
                    mesh, gi, arr, lens, pos[0], pos[1], **static)
                out["offs"], out["n_dp"] = offs, np.int64(n_dp)
            else:
                pb = map_batch_data_parallel(mesh, mapper.dev, arr, lens,
                                             pos[0], pos[1], **static)
            host = {f: getattr(pb, f).cpu().numpy() for f in BATCH_FIELDS}
            times[name] = time.perf_counter() - t0
            launches[name] = {k: n for k, n in cuda_ops.LAUNCHES.items()
                              if n}
            out.update({f"{name}.{f}": a for f, a in host.items()})
        np.savez(f"{job['out']}.rank{rank}", **out)
        print("SHARDED " + json.dumps(dict(rank=rank, times=times,
                                           launches=launches)), flush=True)
    finally:
        dist.destroy_process_group()
    return 0


def wait_all(procs, timeout: float, what: str) -> list:
    """Each process's standard output once all have ended with 0; any left
    running at ``timeout`` (or after another failed) is killed."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, (p, o) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            log(f"# {what} {i} exited {p.returncode}:\n{o[-3000:]}")
        assert p.returncode == 0, f"{what} {i} exited {p.returncode}"
    return outs


def clock_of(metrics_path: str, name: str) -> float:
    """A host clock from a ``--metrics`` summary file."""
    with open(metrics_path) as f:
        for line in f:
            k, v = line.split()
            if k == name:
                return float(v)
    raise AssertionError(f"{name} not in {metrics_path}")


def two_host_split(run, argv, out: str) -> bytes:
    """The CLI's run of ``argv`` as two hosts, one after another in this
    process (BLASR_TPU_NUM_HOSTS=2), merged by merge_outputs: the bytes of
    ``out``."""
    from blasr_tpu_torch.dist.multihost import merge_outputs
    try:
        os.environ["BLASR_TPU_NUM_HOSTS"] = "2"
        for h in range(2):
            os.environ["BLASR_TPU_HOST_ID"] = str(h)
            assert run(argv + ["--out", out]) == 0
    finally:
        os.environ.pop("BLASR_TPU_NUM_HOSTS", None)
        os.environ.pop("BLASR_TPU_HOST_ID", None)
    merge_outputs(out, 2, [])
    with open(out, "rb") as f:
        return f.read()


def phase_sharded(card, cuda_ops, sims, bb) -> None:
    """Phase 6 on the bench workload: run_sharded on two hosts of this card
    (two processes together) against the same two shards mapped in this
    process, byte for byte, and against one host's run (the lines that
    differ are printed; without the SDP pass, byte for byte); then two
    gloo ranks on cuda:0 (``--sharded-rank``): the
    ref-sharded batch on the card equals it on the CPU (plain versions)
    field for field and places >= 95% of the reads once globalized, and
    the data-parallel output equals single-rank map_batch over the whole
    batch on the card."""
    from blasr_tpu_torch.cli.blasr import run
    from blasr_tpu_torch.dist.mesh import globalize_sharded
    from blasr_tpu_torch.io.fasta import write_fasta
    from blasr_tpu_torch.pipeline.map_read import (PackedBatch, map_batch,
                                                   unpack_batch)
    from blasr_tpu_torch.sim import random_genome
    from torch_dist_rank import free_port

    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        genome, reads = os.path.join(d, "g.fa"), os.path.join(d, "r.fa")
        write_fasta(genome, random_genome(4_600_000, seed=11))
        write_fasta(reads, [s.rec for s in sims])
        argv = [reads, genome, "-m", "4", "--device", "cuda"]
        single, merged = os.path.join(d, "single.m4"), os.path.join(d, "o.m4")
        log(f"# phase 6: bench FASTA written in "
            f"{time.perf_counter() - t0:.1f}s")

        cuda_ops.reset_launch_counts()
        t0 = time.perf_counter()
        assert run(argv + ["--out", single, "--metrics",
                           os.path.join(d, "metrics.single")]) == 0
        wall = time.perf_counter() - t0
        launched = dict(cuda_ops.LAUNCHES)
        assert all(launched[k] > 0 for k in SHARDED_KERNELS), \
            f"the single CLI run did not launch every kernel: {launched}"
        log(f"# sharded 1/3, one process: CLI -m 4 over {len(sims)} reads "
            f"in {wall:.2f}s (set-up, index and captures included), "
            f"collectAlignments {clock_of(os.path.join(d, 'metrics.single'), 'collectAlignments'):.3f}s "
            f"on {card}")

        procs = []
        t0 = time.perf_counter()
        for h in range(2):
            host_argv = argv + ["--out", merged, "--metrics",
                                os.path.join(d, f"metrics.host{h}")]
            code = ("import json, sys\n"
                    "sys.modules['jax'] = None\n"
                    "sys.modules['blasr_tpu'] = None\n"
                    f"sys.path.insert(0, {HERE!r})\n"
                    "from blasr_tpu_torch.dist.multihost import run_sharded\n"
                    "from blasr_tpu_torch.kernels import cuda_ops\n"
                    f"rc = run_sharded({host_argv!r})\n"
                    "print('LAUNCHES ' + json.dumps(cuda_ops.LAUNCHES))\n"
                    "sys.exit(rc)\n")
            env = dict(os.environ, BLASR_TPU_NUM_HOSTS="2",
                       BLASR_TPU_HOST_ID=str(h))
            procs.append(subprocess.Popen(
                [sys.executable, "-c", code], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True, env=env, cwd=d))
        outs = wait_all(procs, 600, "run_sharded host")
        wall = time.perf_counter() - t0
        for h, o in enumerate(outs):
            line = [x for x in o.splitlines() if x.startswith("LAUNCHES ")]
            launched = json.loads(line[-1][len("LAUNCHES "):])
            assert all(launched[k] > 0 for k in SHARDED_KERNELS), \
                f"host {h} did not launch every kernel: {launched}"
            log(f"#   host {h}: collectAlignments "
                f"{clock_of(os.path.join(d, f'metrics.host{h}'), 'collectAlignments'):.3f}s, "
                f"launches {({k: n for k, n in launched.items() if n})}")
        left = [f for f in os.listdir(d) if f.startswith("o.m4.host")]
        assert not left, f"parts or sentinels left: {left}"
        # the same two shards mapped one after another in this process and
        # merged by merge_outputs: the batches run_sharded's hosts formed
        t0 = time.perf_counter()
        split = two_host_split(run, argv, os.path.join(d, "split.m4"))
        log(f"# sharded 1/3, the two shards one after another in this "
            f"process: {time.perf_counter() - t0:.2f}s")
        with open(merged, "rb") as f1:
            got = f1.read()
        assert got and got == split, \
            "run_sharded's merged m4 differs from the same two shards mapped " \
            "in one process"
        with open(single, "rb") as f1:
            one = f1.read()
        diff = sorted(set(one.decode().splitlines())
                      ^ set(got.decode().splitlines()))
        reads = sorted({x.split()[0] for x in diff})
        log(f"# sharded 1/3, run_sharded on two hosts of one card: both "
            f"processes in {wall:.2f}s (each with its own start, index and "
            f"captures), merged by host 0: {len(got.splitlines())} lines, "
            f"byte-identical to the same two shards mapped in one process; "
            f"parts and sentinels removed; against one host's run "
            f"({len(one.splitlines())} lines) {len(diff)} lines differ, of "
            f"reads {reads} on {card}")
        # what makes them differ: map_batch's SDP pass fills its last third
        # of rows by batch position (the JAX package's map_batch does the
        # same), so a read's alignment can depend on the reads batched with
        # it.  Without the SDP pass the host count changes no byte.
        t0 = time.perf_counter()
        flat = argv + ["--sdpTupleSize", "0"]
        one0 = os.path.join(d, "single0.m4")
        assert run(flat + ["--out", one0]) == 0
        with open(one0, "rb") as f1:
            one0 = f1.read()
        split0 = two_host_split(run, flat, os.path.join(d, "split0.m4"))
        assert one0 and one0 == split0, \
            "without the SDP pass, two hosts' merged m4 differs from one host's"
        log(f"# sharded 1/3, --sdpTupleSize 0 (no SDP pass): one host and two "
            f"hosts merged byte-identical, {len(one0.splitlines())} lines, in "
            f"{time.perf_counter() - t0:.2f}s on {card}")

    with tempfile.TemporaryDirectory() as d:
        job = os.path.join(d, "job.json")
        with open(job, "w") as f:
            json.dump(dict(port=free_port(), out=os.path.join(d, "out")), f)
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--sharded-rank",
             job, str(r)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, cwd=HERE) for r in range(2)]
        outs = wait_all(procs, 600, "sharded rank")
        wall = time.perf_counter() - t0
        ranks = [dict(np.load(os.path.join(d, f"out.rank{r}.npz")))
                 for r in range(2)]
    info = [json.loads([x for x in o.splitlines()
                        if x.startswith("SHARDED ")][-1][len("SHARDED "):])
            for o in outs]
    log(f"# sharded ranks: two processes in {wall:.2f}s; per rank "
        + "; ".join(json.dumps({k: round(v, 3) for k, v in i["times"].items()})
                    for i in info) + f" (host clock, s) on {card}")

    def batch(rank, name):
        return PackedBatch(*(torch.from_numpy(rank[f"{name}.{f}"])
                             for f in BATCH_FIELDS))

    for i in info:
        ln = i["launches"]
        for name in ("ref_cuda", "data_cuda"):
            assert all(ln[name].get(k, 0) > 0 for k in SHARDED_KERNELS), \
                f"rank {i['rank']} {name} did not launch every kernel: {ln}"
        assert not ln["ref_cpu"], f"the CPU run launched kernels: {ln}"
        log(f"#   rank {i['rank']} launches: ref-sharded on the card "
            f"{ln['ref_cuda']}; data-parallel {ln['data_cuda']}")

    for r, rank in enumerate(ranks):
        for f in BATCH_FIELDS:
            a, b = rank[f"ref_cuda.{f}"], rank[f"ref_cpu.{f}"]
            assert a.dtype == b.dtype and np.array_equal(a, b), \
                f"rank {r}: ref-sharded {f} on the card differs from the CPU"
            assert np.array_equal(a, ranks[0][f"ref_cuda.{f}"]), \
                f"rank {r}: ref-sharded {f} differs from rank 0's"
    res = unpack_batch(batch(ranks[0], "ref_cuda"))
    n_dp = int(ranks[0]["n_dp"])
    ts, te = globalize_sharded(res, ranks[0]["offs"], n_dp)
    B = len(bb["sims"])
    per_read = [[SimpleNamespace(score=res.score[row][c], strand=strand,
                                 tstart=int(ts[row][c]), tend=int(te[row][c]))
                 for strand, row in ((0, i), (1, B + i))
                 for c in np.flatnonzero(res.valid[row]
                                         & (res.dp_slot[row] >= 0))]
                for i in range(B)]
    share = placed_count(bb["sims"], per_read) / B
    log(f"# sharded 2/3, map_batch_ref_sharded R=2 on two ranks of cuda:0 "
        f"(gloo): the bench batch (B={len(bb['sims'])}, L=2048) equals the "
        f"same call on the CPU (plain versions) in every field; offsets "
        f"{ranks[0]['offs'].tolist()}, n_dp {n_dp}; placed "
        f"{100 * share:.1f}% after globalize_sharded on {card}")
    assert share >= 0.95, f"ref-sharded placed only {100 * share:.1f}%"

    t0 = time.perf_counter()
    whole = map_batch(bb["ix"], bb["reads"], bb["rl"], *bb["pos"], **bb["kw"])
    whole = {f: getattr(whole, f).cpu().numpy() for f in BATCH_FIELDS}
    wall = time.perf_counter() - t0
    for r, rank in enumerate(ranks):
        for f in BATCH_FIELDS:
            a = rank[f"data_cuda.{f}"]
            assert a.dtype == whole[f].dtype and np.array_equal(a, whole[f]), \
                f"rank {r}: data-parallel {f} differs from map_batch on the " \
                "whole batch"
    log(f"# sharded 3/3, map_batch_data_parallel on two ranks of cuda:0 "
        f"(gloo), blocks of {bb['reads'].shape[0] // 2} reads, the batch-level "
        f"choices made over the whole batch: each rank's output equals "
        f"single-rank map_batch over the whole batch on the card "
        f"({wall:.3f}s, host clock), array for array, on {card}")


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
         "K5": compare_k5, "K6": compare_k6, "K7": compare_k7,
         "K1W": compare_k1w,
         "K2W": compare_k2w}[sys.argv[2]](card, sys.argv[3:])
        return 0
    if sys.argv[1:] == ["--k4-kernels"]:
        return count_k4_kernels(card)
    if sys.argv[1:2] == ["--sharded-rank"]:
        return sharded_rank(sys.argv[2], int(sys.argv[3]))
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
    kres.update(phase_members(card, bb))
    t1 = time.time()
    kres.update(phase_wide(card))
    log(f"# phase 2 K1-W and K2-W done in {time.time() - t1:.1f}s")
    log(f"# phase 2 done in {time.time() - t0:.1f}s")
    with tempfile.TemporaryDirectory() as d:
        t0 = time.time()
        worlds = phase_goldens(d, cuda_ops)
        phase_ids(cuda_ops)
        log(f"# phase 3 goldens done in {time.time() - t0:.1f}s")
        t0 = time.time()
        mode_runs = phase_mapper_modes(worlds, cuda_ops)
        log(f"# phase 3 Mapper modes done in {time.time() - t0:.1f}s")
        t0 = time.time()
        width_runs = phase_widths(worlds, cuda_ops)
        log(f"# phase 3 band widths 64 and 256 done in "
            f"{time.time() - t0:.1f}s")
        t0 = time.time()
        phase_sam_tools(d)
        log(f"# phase 3 SAM tools done in {time.time() - t0:.1f}s")
        t0 = time.time()
        phase_options(d, worlds, cuda_ops)
        log(f"# phase 3 C15 options and the tools' --sa index done in "
            f"{time.time() - t0:.1f}s")
        t0 = time.time()
        phase_modes(d, cuda_ops)
        log(f"# phase 3 modes done in {time.time() - t0:.1f}s")
        t0 = time.time()
        phase_pairwise(d, cuda_ops)
        log(f"# phase 3 pairwise tools done in {time.time() - t0:.1f}s")
    t0 = time.time()
    phase_long_reads(card, cuda_ops)
    phase_clr_read(cuda_ops)
    log(f"# long-read phase done in {time.time() - t0:.1f}s")
    t0 = time.time()
    dist = phase_bench(card, cuda_ops, gi, sims, "distance", dev=dev)
    qvl = phase_bench(card, cuda_ops, gi, sims, "qv", dev=dev)
    aff = phase_bench(card, cuda_ops, gi, sims, "affine", dev=dev)
    compare_lookahead(card, gi, sims, dev)
    compare_graphs(card, gi, sims, dev)
    log(f"# phase 4 done in {time.time() - t0:.1f}s")
    t0 = time.time()
    # the passes through graphs give each kernel's in-graph device time
    prof, counts = {}, {}
    for mode in ("distance", "qv", "affine"):
        prof[mode], counts[mode] = phase_profile(card, gi, sims, dev, mode)
    for mode in PROFILE_MODES:
        t1 = time.time()
        prof[mode], _ = phase_profile(card, gi, sims, dev, mode)
        log(f"# traced {BENCH_MODES[mode][0]} pass in "
            f"{time.time() - t1:.1f}s")
    _, eager_counts = phase_profile(card, gi, sims, dev, eager=True)
    differ = {n: (eager_counts.get(n, 0), counts["distance"].get(n, 0))
              for n in set(eager_counts) | set(counts["distance"])
              if eager_counts.get(n, 0) != counts["distance"].get(n, 0)}
    log("# device events whose count differs between the profiled distance "
        "passes, eager | graph: " + ("none" if not differ else "; ".join(
            f"{a} | {b} x {n[:110]}" for n, (a, b) in sorted(differ.items()))))
    check_k4_one_kernel()
    log(f"# phase 5 done in {time.time() - t0:.1f}s")
    t0 = time.time()
    phase_sharded(card, cuda_ops, sims, bb)
    log(f"# phase 6 (sharded) done in {time.time() - t0:.1f}s")
    assert "jax" not in sys.modules or sys.modules["jax"] is None
    loaded = [m for m in sys.modules if m.startswith("blasr_tpu.")]
    assert not loaded, f"JAX-package modules were loaded: {loaded}"

    # the main path's counts from its two bench passes; each mode of this
    # slice's from its own path's run (the --affineAlign bench pass, the
    # Mapper-mode runs of phase 3)
    launches = {"banded_dp": dist["banded_dp"],
                "banded_dp_qv": qvl["banded_dp_qv"],
                "banded_dp_hp": aff["banded_dp_hp"]}
    for k in PATH_KERNELS + ("indexed_walks",):
        launches[k] = dist[k] + qvl[k]
    for k in ("banded_dp_gen", "banded_dp_hp_gen", "banded_dp_qv_gen",
              "anchor_search_block"):
        launches[k] = mode_runs[k][k]
    # K1-W's modes and K2-W from the band-width runs of phase 3
    launches.update(width_runs)
    rows = [("banded_dp", DP_SRC, "blasr_tpu/kernels/pallas_banded.py:388"),
            ("banded_dp_qv", DP_SRC,
             "blasr_tpu/kernels/pallas_banded.py:388"),
            ("banded_dp_hp", DP_SRC, "blasr_tpu/kernels/banded.py:362"),
            ("banded_dp_gen", DP_SRC, "blasr_tpu/kernels/banded.py:362"),
            ("banded_dp_hp_gen", DP_SRC, "blasr_tpu/kernels/banded.py:362"),
            ("banded_dp_qv_gen", DP_SRC, "blasr_tpu/kernels/banded.py:362"),
            ("banded_traceback", TB_SRC, "blasr_tpu/kernels/banded.py:424"),
            ("chain_scan", CHAIN_SRC, "blasr_tpu/kernels/chain.py:54"),
            ("sdp_window", SDP_SRC, "blasr_tpu/kernels/sdp.py:142"),
            ("anchor_search", ANCHOR_SRC, "blasr_tpu/kernels/anchor.py:74"),
            ("anchor_search_block", ANCHOR_SRC,
             "blasr_tpu/kernels/anchor.py:167"),
            ("band_offsets", BAND_SRC,
             "blasr_tpu/pipeline/map_read.py:320"),
            ("chain_members", MEMBERS_SRC,
             "blasr_tpu/kernels/chain.py:325"),
            *((k, DP_WIDE_SRC, "blasr_tpu/kernels/banded.py:362")
              for k in ("banded_dp_w", "banded_dp_w_qv", "banded_dp_w_hp",
                        "banded_dp_w_gen", "banded_dp_w_hp_gen",
                        "banded_dp_w_qv_gen")),
            ("banded_traceback_w", TB_WIDE_SRC,
             "blasr_tpu/kernels/banded.py:424")]
    # rule 2's measure: launches per pass pair x (kernel ms - bound ms),
    # the kernel's ms as phase 2's events time the call and as its device
    # time inside the graphs of phase 5's passes (torch.profiler, per
    # launch)
    graph_ms = {name: prof[GRAPH_PASS.get(name, ("distance", name))[0]]
                .get(GRAPH_PASS.get(name, ("distance", name))[1])
                for name, _, _ in rows}
    loss = {name: launches[name] * (kres[name]["ms"] - kres[name]["bound"][0])
            for name, _, _ in rows}
    dloss = {name: (None if graph_ms[name] is None else
                    launches[name] * (graph_ms[name] - kres[name]["bound"][0]))
             for name, _, _ in rows}
    log("# rule 2, launches per pass pair x (kernel ms - bound ms), call "
        "time | in-graph device time (ms per launch): " + ", ".join(
            f"{name} {loss[name]:.3f} | " + (
                "not measured" if dloss[name] is None
                else f"{dloss[name]:.3f} ({graph_ms[name]:.4f})")
            for name in sorted(loss, key=lambda k: -loss[k]))
        + f" on {card}")
    table = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": kres[name]["err"],
         "ms": kres[name]["ms"], "plain_ms": kres[name]["plain_ms"],
         "bound_ms": kres[name]["bound"][0],
         "bound_by": kres[name]["bound"][1], "library_ms": None}
        for name, src, rep in rows],
        # K2 launches of the two bench passes given an index (tb_rows)
        "indexed_walks": launches["indexed_walks"]}
    log(f"# indexed walks of the two bench passes: "
        f"{launches['indexed_walks']} of {launches['banded_traceback']} K2 "
        f"launches")
    print(json.dumps(table))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

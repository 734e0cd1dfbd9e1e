"""End-to-end batched mapping pipeline (port of
``blasr_tpu/pipeline/map_read.py``).

The device half (:class:`DeviceIndex`, :func:`map_batch`) is PyTorch on an
explicit device: anchor search (K5 on CUDA) -> chain/cluster (K3) ->
candidate windows -> band offsets (K6) and the SDP window pass (K4) ->
guided banded affine DP (K1) -> run-length traceback (K2) -> one packed
int32 result buffer, for both strands.
The host half (:class:`Alignment`, the CIGAR helpers and :class:`Mapper`)
is the JAX package's code with its device calls pointed here.
"""

from __future__ import annotations

import dataclasses
import os
import time
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from blasr_tpu_torch.index.genome import GenomeIndex
from blasr_tpu_torch.io.fasta import FastaRecord
from blasr_tpu_torch.params import MappingParams, ShapeConfig
from blasr_tpu_torch.kernels.anchor import find_anchors, read_kmer_keys
from blasr_tpu_torch.kernels.banded import banded_align, banded_traceback
from blasr_tpu_torch.kernels.chain import chain_anchors, chain_members
from blasr_tpu_torch.kernels.dispatch import on_device, per_distinct_row
from blasr_tpu_torch.kernels.pallas_banded import (SLOPE_ERROR,
                                                   banded_align_cuda,
                                                   slope_fault)
from blasr_tpu_torch.pipeline import graphs
from blasr_tpu_torch.pipeline.metrics import (count, records_spans, span,
                                              timeline)

BIG32 = 0x3FFFFFFF
MASK32 = 0xFFFFFFFF
# the genome positions (packed words) and index slots (records) that
# DeviceIndex.from_host derives per step: the set-up holds the arrays it
# builds and one step's temporaries, not several whole-genome ones
INDEX_CHUNK = 1 << 21

# the set-up spans of the latest DeviceIndex.from_host, in seconds, each
# ended by a device sync: "index.upload" (the host arrays onto the
# device), "index.words" (the packed genome words), "index.records" (the
# records table; 0.0 where none is built).  Module-level, as
# graphs.CAPTURES: the index is built before any Mapper's metrics exist.
INDEX_SPANS: Dict[str, float] = {}


@contextmanager
def _index_span(name: str, device: torch.device):
    """Time the block into :data:`INDEX_SPANS` up to a sync of
    ``device``, under a profiler range of ``name`` while one records."""
    t0 = time.perf_counter()
    with timeline(name):
        yield
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    INDEX_SPANS[name] = time.perf_counter() - t0


def _i32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values holding 32-bit patterns -> int32 with the same bits."""
    x = x & MASK32
    return (x - ((x >> 31) << 32)).to(torch.int32)


def _packed_words(gsent: torch.Tensor, chunk: int = INDEX_CHUNK):
    """(gwords, gnwords) as int64 32-bit patterns: 16 bases per word,
    2 bits each LSB-first; gnwords marks non-ACGT (and past-the-end)
    bases with 11 (``index.genome.build_packed_words``).  Written
    ``chunk`` positions at a time into the two arrays."""
    G = gsent.shape[0]
    dev = gsent.device
    gw = torch.zeros(G, dtype=torch.int64, device=dev)
    gn = torch.zeros(G, dtype=torch.int64, device=dev)
    for a in range(0, G, chunk):
        n = min(chunk, G - a)
        # the chunk's bases and the 15 after it, N codes past the genome
        seg = torch.full((n + 15,), 4, dtype=torch.int64, device=dev)
        seg[:min(n + 15, G - a)] = gsent[a:a + n + 15]
        w, m = gw[a:a + n], gn[a:a + n]
        for j in range(16):
            sh = seg[j:j + n]
            w |= (sh & 3) << (2 * j)
            m |= torch.where(sh >= 4, 3, 0) << (2 * j)
    return gw, gn


class DeviceIndex(NamedTuple):
    """Genome index resident on one device.  ``genome_pad`` is the genome
    followed by N codes, enough for the widest window of any bucket, so
    map_batch gathers its windows from it without padding the genome on
    every dispatch; from_host makes ``genome`` a view of its head."""

    genome: torch.Tensor         # int8 [G] (one sentinel N prepended)
    keys_sorted: torch.Tensor    # int64 [M] (uint32 k-mer keys)
    pos_sorted: torch.Tensor     # int64 [M] (+1 for the sentinel)
    contig_starts: torch.Tensor  # int64 [n_contigs]
    contig_ends: torch.Tensor    # int64 [n_contigs]
    k: int
    bucket_starts: Optional[torch.Tensor] = None  # int32 [4^k+1]
    bucket_pairs: Optional[torch.Tensor] = None   # int32 [4^k, 2]
    gwords: Optional[torch.Tensor] = None   # int64 [G] packed 16-base words
    gnwords: Optional[torch.Tensor] = None  # int64 [G] non-ACGT bit pairs
    # per-SA-slot records [M + RECORDS_PAD, 6] as int32 bit patterns:
    # (t, genome[t-1], gwords[t+k], gnwords[t+k], gwords[t+k+16],
    # gnwords[t+k+16]) — one contiguous 24-byte row per slot
    pos_records: Optional[torch.Tensor] = None
    genome_pad: Optional[torch.Tensor] = None  # int8 [G + pad], pad N codes

    # the most slots whose records are built on a CPU device (the JAX
    # package's cap); on CUDA the records are built when their bytes fit
    # in 1 / RECORDS_MEMORY_SHARE of the device's memory
    RECORDS_MAX_SLOTS = 1 << 26
    RECORDS_MEMORY_SHARE = 8
    RECORDS_PAD = 1024
    # the widest window of the default buckets (ShapeConfig.window_len)
    GENOME_PAD = ShapeConfig().window_len(ShapeConfig().buckets[-1])

    def with_pad(self, pad: int) -> "DeviceIndex":
        """This index with ``genome_pad`` holding at least ``pad`` N codes
        past the genome (``genome`` its head)."""
        G = self.genome.shape[0]
        if self.genome_pad is not None and self.genome_pad.shape[0] >= G + pad:
            return self
        gp = torch.cat([self.genome, torch.full(
            (pad,), 4, dtype=self.genome.dtype, device=self.genome.device)])
        return self._replace(genome=gp[:G], genome_pad=gp)

    @staticmethod
    def records_fit(n_slots: int, device) -> bool:
        """Whether :meth:`from_host` builds the records of an index of
        ``n_slots`` slots on ``device``: on CUDA when the table's bytes
        are at most 1 / :data:`RECORDS_MEMORY_SHARE` of the device's
        memory, elsewhere up to :data:`RECORDS_MAX_SLOTS` slots."""
        device = torch.device(device)
        if device.type == "cuda":
            total = torch.cuda.get_device_properties(device).total_memory
            return ((n_slots + DeviceIndex.RECORDS_PAD) * 24
                    <= total // DeviceIndex.RECORDS_MEMORY_SHARE)
        return n_slots <= DeviceIndex.RECORDS_MAX_SLOTS

    @staticmethod
    def _build_records(genome, pos_sorted, gw, gn, k: int,
                       chunk: int = INDEX_CHUNK):
        """The records table, written ``chunk`` slots at a time into one
        int32 [M + RECORDS_PAD, 6] table; the pad rows hold 0 in the first
        two columns and MASK32 (all N) in the words."""
        G = genome.shape[0]
        M = pos_sorted.shape[0]
        table = torch.empty((M + DeviceIndex.RECORDS_PAD, 6),
                            dtype=torch.int32, device=genome.device)
        for a in range(0, M, chunk):
            pos = pos_sorted[a:a + chunk]
            recs = [pos, genome[(pos - 1).clamp(0, G - 1)].to(torch.int64)]
            for j in range(2):
                off = k + 16 * j
                gidx = (pos + off).clamp(0, G - 1)
                recs.append(gw[gidx])
                recs.append(torch.where(pos + off < G, gn[gidx], MASK32))
            table[a:a + pos.shape[0]] = _i32_bits(torch.stack(recs, dim=1))
        table[M:, :2] = 0
        table[M:, 2:] = -1          # MASK32's bits as int32
        return table

    @staticmethod
    def from_host(gi: GenomeIndex, device) -> "DeviceIndex":
        """Upload a host :class:`GenomeIndex` (the same one the JAX package
        takes) and derive the packed words and, where
        :meth:`records_fit`, the records on ``device``.  Bit-identical to
        the JAX ``DeviceIndex.from_host`` arrays, and ``genome_pad`` the
        genome with :data:`GENOME_PAD` N codes after it.  Its three
        phases are timed into :data:`INDEX_SPANS`."""
        device = torch.device(device)
        INDEX_SPANS.clear()
        with _index_span("index.upload", device):
            G = gi.genome.shape[0] + 1
            gpad = np.full(G + DeviceIndex.GENOME_PAD, 4, dtype=np.int8)
            gpad[1:G] = gi.genome
            gpad_d = torch.from_numpy(gpad).to(device)
            genome_d = gpad_d[:G]
            starts = np.asarray(gi.seqdb.starts, dtype=np.int64)
            ends = starts + np.asarray(gi.seqdb.lengths, dtype=np.int64)
            contig_s = torch.from_numpy(starts + 1).to(device)
            contig_e = torch.from_numpy(ends + 1).to(device)
            M = gi.pos_sorted.shape[0]
            pos_d = torch.from_numpy(
                np.asarray(gi.pos_sorted, dtype=np.int64) + 1).to(device)
            keys_d = torch.from_numpy(
                np.asarray(gi.keys_sorted).astype(np.int64)).to(device)
            bs_d = bp_d = None
            if gi.bucket_starts is not None:
                bs_d = torch.from_numpy(
                    np.asarray(gi.bucket_starts)).to(device)
                if gi.bucket_starts.shape[0] <= (1 << 25):
                    bp_d = torch.stack([bs_d[:-1], bs_d[1:]],
                                       dim=1).contiguous()
        with _index_span("index.words", device):
            gw_d, gn_d = _packed_words(genome_d)
        rec_d = None
        with _index_span("index.records", device):
            if DeviceIndex.records_fit(M, device):
                rec_d = DeviceIndex._build_records(genome_d, pos_d, gw_d,
                                                   gn_d, gi.k)
        return DeviceIndex(
            genome=genome_d, keys_sorted=keys_d, pos_sorted=pos_d,
            contig_starts=contig_s, contig_ends=contig_e, k=gi.k,
            bucket_starts=bs_d, bucket_pairs=bp_d, gwords=gw_d,
            gnwords=gn_d, pos_records=rec_d, genome_pad=gpad_d)


def device_index_from_jax_arrays(arrs: dict, device) -> DeviceIndex:
    """A :class:`DeviceIndex` from the JAX package's DeviceIndex fields as
    numpy arrays (``{name: np.asarray(field)}`` plus ``k``), so a test can
    feed both pipelines the same index."""
    device = torch.device(device)

    def t(name, kind):
        a = arrs.get(name)
        if a is None:
            return None
        a = np.asarray(a)
        if kind == "u32":
            a = a.astype(np.int64)
        elif kind == "bits":
            a = a.astype(np.uint32).view(np.int32)
        elif kind == "i64":
            a = a.astype(np.int64)
        return torch.from_numpy(np.array(a)).to(device)

    return DeviceIndex(
        genome=t("genome", "int8"), keys_sorted=t("keys_sorted", "u32"),
        pos_sorted=t("pos_sorted", "i64"),
        contig_starts=t("contig_starts", "i64"),
        contig_ends=t("contig_ends", "i64"), k=int(arrs["k"]),
        bucket_starts=t("bucket_starts", "int32"),
        bucket_pairs=t("bucket_pairs", "int32"),
        gwords=t("gwords", "u32"), gnwords=t("gnwords", "u32"),
        pos_records=t("pos_records", "bits")).with_pad(
            DeviceIndex.GENOME_PAD)


# the anchor search's seed counts, summed over a batch's rows on the
# card (``Anchors.seed_counts``), as MappingMetrics counters: the valid
# read k-mers looked up, the sum of their occurrences (nocc), those with
# nocc > occ_per_pos, the sum of min(nocc, occ_per_pos), and the anchors
# kept (valid ones among the top A of each strand row)
SEED_COUNTERS = ("anchor_seeds", "anchor_slots", "anchor_capped",
                 "anchor_examined", "anchor_kept")
# the words of PackedBatch.flat after the ops: the seed counts (int64,
# two int32 words each), the DP rows used, K1's slope fault
TAIL_WORDS = 2 * len(SEED_COUNTERS) + 2

# column indices of PackedBatch.ints
(COL_VALID, COL_QA, COL_QB, COL_TS, COL_TE, COL_NMATCH, COL_NMIS, COL_NINS,
 COL_NDEL, COL_DPSLOT, COL_SCORE, COL_CHSCORE, COL_CHANCH, COL_NANCH,
 COL_CVALID, COL_OVF, COL_NCLIP) = range(17)
N_COLS = 17


class PackedBatch(NamedTuple):
    """Device-side result of map_batch (layout of the JAX PackedBatch, and
    :data:`TAIL_WORDS` more words at the end of ``flat``: the batch's
    seed counts (:data:`SEED_COUNTERS`, int64 as int32 pairs), the DP
    rows the batch needed, the sum of qb - qa over its valid DP items,
    then K1's slope fault, nonzero when some active row advanced the band
    by other than 0, 1 or 2).  ``dp_rows`` is the rows K1 stores, n_dp x L, from the call's
    static shape.  :func:`start_fetch` adds the host copy of ``flat`` and
    the event that marks its end.  A batch from a graph replay
    (``pipeline/graphs.py``) holds the graph's own device tensors:
    ``ints``, ``ops``, ``clusters`` and ``flat`` are valid until the next
    replay on the same index (its graphs share one pool), so a caller
    reads them through ``host`` (:func:`unpack_batch` reads only ``host``
    and the shapes)."""

    ints: torch.Tensor      # int32 [2B, C, N_COLS] columns per COL_*
    ops: torch.Tensor       # int32 [N_tb, P/2] RL traceback pairs
    clusters: torch.Tensor  # int32 [2B, C_stat, 2] (chain weight, gate ok)
    # int32 [*]: ints, clusters, ops, the seed counts, the DP rows used,
    # the fault
    flat: Optional[torch.Tensor] = None
    host: Optional[torch.Tensor] = None  # host copy of flat (start_fetch)
    ready: Optional["torch.cuda.Event"] = None  # recorded after that copy
    dp_rows: int = 0                     # n_dp x L, the rows K1 stores


class BatchResult(NamedTuple):
    """Host view of a PackedBatch (strand rows are [fwd x B, rc x B])."""

    score: np.ndarray
    valid: np.ndarray
    q_start: np.ndarray
    q_end: np.ndarray
    t_start: np.ndarray
    t_end: np.ndarray
    n_match: np.ndarray
    n_mismatch: np.ndarray
    n_ins: np.ndarray
    n_del: np.ndarray
    ops: np.ndarray
    dp_slot: np.ndarray
    chain_score: np.ndarray
    chain_anchors: np.ndarray
    n_anchors: np.ndarray
    chain_valid: np.ndarray
    cluster_bases: np.ndarray
    cluster_valid: np.ndarray
    overflow: np.ndarray
    n_clipped: np.ndarray


def start_fetch(pb: PackedBatch) -> PackedBatch:
    """Start the one transfer of ``pb.flat`` to the host.  On CUDA the copy
    goes into a pinned buffer without waiting, queued behind the batch's
    kernels, and an event is recorded after it; on the CPU the buffer is
    a plain tensor and the copy is done on return."""
    flat = pb.flat
    cuda = flat.device.type == "cuda"
    host = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=cuda)
    host.copy_(flat, non_blocking=cuda)
    ready = None
    if cuda:
        ready = torch.cuda.Event()
        ready.record()
    return pb._replace(host=host, ready=ready)


def unpack_batch(pb: PackedBatch) -> BatchResult:
    """Wait for the host copy of ``flat`` (:func:`start_fetch`, started
    here if the caller did not) and expand the column block.  Raises
    ValueError if the batch's DP ran on offsets K1 does not take.  The
    wait is span ``collect.wait`` (``graphs.DISPATCHES["waited"]`` counts
    the copies not done when it began), the rest ``collect.unpack``; the
    DP rows stored and needed go to the counters ``dp_rows_stored`` and
    ``dp_rows_used``, the seed counts to :data:`SEED_COUNTERS`."""
    if pb.host is None:
        pb = start_fetch(pb)
    if pb.ready is not None:
        with span("collect.wait"):
            if not pb.ready.query():
                graphs.DISPATCHES["waited"] += 1
                pb.ready.synchronize()
    with span("collect.unpack"):
        return _unpack(pb)


def _unpack(pb: PackedBatch) -> BatchResult:
    buf = pb.host.numpy()
    if buf[-1]:
        raise ValueError(SLOPE_ERROR)
    count("dp_rows_stored", pb.dp_rows)
    count("dp_rows_used", buf[-2])
    seeds = buf[-TAIL_WORDS:-2].copy().view(np.int64)
    for name, n in zip(SEED_COUNTERS, seeds):
        count(name, n)
    n_i = int(np.prod(pb.ints.shape))
    n_c = int(np.prod(pb.clusters.shape))
    ints = buf[:n_i].reshape(tuple(pb.ints.shape))
    clusters = buf[n_i:n_i + n_c].reshape(tuple(pb.clusters.shape))
    ops = buf[n_i + n_c:-TAIL_WORDS].reshape(tuple(pb.ops.shape))
    c = [ints[..., i] for i in range(ints.shape[-1])]
    return BatchResult(
        score=c[10].astype(np.float32), valid=c[0] > 0,
        q_start=c[1], q_end=c[2], t_start=c[3], t_end=c[4],
        n_match=c[5], n_mismatch=c[6], n_ins=c[7], n_del=c[8],
        ops=ops, dp_slot=c[9], chain_score=c[11].astype(np.float32),
        chain_anchors=c[12], n_anchors=c[13][:, 0], chain_valid=c[14] > 0,
        cluster_bases=clusters[..., 0].astype(np.float32),
        cluster_valid=clusters[..., 1] > 0,
        overflow=c[15] > 0,
        n_clipped=c[16][:, 0],
    )


def _revcomp_batch(reads: torch.Tensor, read_len: torch.Tensor):
    """Per-row reverse complement of the first read_len codes, re-padded."""
    B, L = reads.shape
    pos = torch.arange(L, device=reads.device)[None, :]
    src = read_len.to(torch.int64)[:, None] - 1 - pos
    g = reads.gather(1, src.clamp(0, L - 1))
    # the complement of codes 0-3 is 3 - code; N (4) stays N
    return torch.where((src >= 0) & (g < 4), 3 - g, 4).to(torch.int8)


def _revcomp_qv(qv: torch.Tensor, read_len: torch.Tensor,
                tag_shifts=()) -> torch.Tensor:
    """Reverse a packed per-row QV cost track by ``read_len`` (QV values
    follow their bases); 3-bit tag fields at ``tag_shifts`` are
    complemented (tag < 4 -> 3 - tag); rows past read_len are 0."""
    B, L = qv.shape
    pos = torch.arange(L, device=qv.device)[None, :]
    src = read_len.to(torch.int64)[:, None] - 1 - pos
    g = qv.gather(1, src.clamp(0, L - 1))
    for sh in tag_shifts:
        tag = (g >> sh) & 7
        ctag = torch.where(tag < 4, 3 - tag, tag)
        g = (g & ~(7 << sh)) | (ctag << sh)
    return torch.where(src >= 0, g, 0)


def _band_offsets(mq, mt, ws, L, W, w_b,
                  frag_diag=None, frag_valid=None, between_only=False):
    """Band offsets: K6 (``csrc/band_offsets.cu``) on CUDA tensors, the
    plain version on CPU tensors (same contract as
    :func:`_band_offsets_plain`)."""
    def i64(x):
        # the mapper's tensors are int64 and contiguous already: no call
        if x is None or (x.dtype == torch.int64 and x.is_contiguous()):
            return x
        return x.to(torch.int64).contiguous()

    return on_device(
        "_band_offsets", mq.device,
        lambda: _band_offsets_plain(mq, mt, ws, L, W, w_b, frag_diag,
                                    frag_valid, between_only),
        lambda ops: ops.band_offsets_launch(
            i64(mq), i64(mt), i64(ws), L=L, W=W, w_b=w_b,
            frag_diag=i64(frag_diag),
            frag_valid=(frag_valid if frag_valid is None
                        or frag_valid.is_contiguous()
                        else frag_valid.contiguous()),
            between_only=between_only))


def _band_offsets_plain(mq, mt, ws, L, W, w_b,
                        frag_diag=None, frag_valid=None, between_only=False):
    """Band start per query row from the chain guide path, densified by
    SDP fragments (see the JAX ``_band_offsets``).  Monotone, slope 0..2
    per row — the banded kernel's contract.  Rows are independent, so
    each distinct row is computed once (``per_distinct_row``)."""
    frags = () if frag_diag is None else (frag_diag, frag_valid)
    return per_distinct_row(
        lambda mq, mt, ws, *f: (_band_offset_rows(
            mq, mt, ws, L, W, w_b, *(f or (None, None)), between_only),),
        mq, mt, ws, *frags)[0]


def _band_offset_rows(mq, mt, ws, L, W, w_b, frag_diag, frag_valid,
                      between_only):
    N, MC = mq.shape
    assert L <= 1 << 16, (
        "band-offset packing supports buckets up to 65536 query rows")
    dev = mq.device
    DBITS = 15
    DBIAS = 1 << (DBITS - 1)
    DMASK = 2 * DBIAS - 1
    SENT = 0x7FFFFFFF
    valid = mq < BIG32
    tw = mt - ws[:, None]
    diag = (tw - mq).clamp(-DBIAS + 1, DBIAS - 2)
    packed = torch.where(valid, (mq << DBITS) | (diag + DBIAS), -1)
    rows = torch.where(valid, mq, L - 1).clamp(0, L - 1)
    arr = torch.full((N, L), -1, dtype=torch.int64, device=dev)
    arr = arr.scatter_reduce(1, rows, packed, reduce="amax",
                             include_self=True)

    def fills(a):
        ff = torch.cummax(a, dim=1).values          # nearest anchor at <= r
        nx = torch.flip(torch.cummin(torch.flip(
            torch.where(a >= 0, a, SENT), [1]), dim=1).values, [1])
        return (ff >= 0, ff >> DBITS, (ff & DMASK) - DBIAS,
                nx < SENT, nx >> DBITS, (nx & DMASK) - DBIAS)

    p_ok, pq, pd, n_ok, nq, nd = fills(arr)
    r = torch.arange(L, dtype=torch.int64, device=dev)[None, :]
    if frag_diag is not None:
        lo_d = torch.where(p_ok & n_ok, torch.minimum(pd, nd),
                           torch.where(p_ok, pd, nd))
        hi_d = torch.where(p_ok & n_ok, torch.maximum(pd, nd),
                           torch.where(p_ok, pd, nd))
        has_flank = (p_ok & n_ok) if between_only else (p_ok | n_ok)
        fd = frag_diag.clamp(-DBIAS + 1, DBIAS - 2)
        ok = (frag_valid & has_flank[:, :, None]
              & (fd >= (lo_d - w_b)[:, :, None])
              & (fd <= (hi_d + w_b)[:, :, None]))
        fpacked = torch.where(ok, (r[:, :, None] << DBITS) | (fd + DBIAS),
                              -1).amax(dim=2)
        arr = torch.where(arr >= 0, arr, fpacked)
        p_ok, pq, pd, n_ok, nq, nd = fills(arr)
    both = p_ok & n_ok
    denom = torch.clamp(nq - pq, min=1)
    d_interp = pd + torch.div((r - pq) * (nd - pd), denom,
                              rounding_mode="floor")
    d = torch.where(both, d_interp,
                    torch.where(p_ok, pd, torch.where(n_ok, nd, 0)))
    center = r + d
    off = (center - w_b // 2).clamp(0, W - w_b)
    off = torch.cummax(off, dim=1).values
    smax = 2
    return smax * r + torch.cummin(off - smax * r, dim=1).values


class StageTimer:
    """Per-stage device time of :func:`map_batch` from CUDA events.

    While a timer is installed (``with StageTimer() as st: ...``),
    map_batch records an event at each stage boundary on the current
    stream; :meth:`totals` synchronizes once and sums the milliseconds
    per stage name (:meth:`spans`).  Marks ``<stage>.<part>`` split a
    stage into parts that partition it: the stage's own mark ends its
    last part too (one event under both names).  Without a timer the
    marks cost one ``None`` check.  A graph replay (``pipeline/graphs.py``)
    has its marks from the capture, as event nodes of the graph: it waits
    for them and adds its spans (:meth:`add`), so a timed pass of graphs
    waits once per dispatch and measures device time only."""

    active: Optional["StageTimer"] = None
    STAGES = ("anchors", "chain", "guide_sdp", "banded_dp", "traceback",
              "pack")

    def __init__(self):
        self.marks: List[tuple] = []
        self.replayed: Dict[str, float] = {}   # graph replays' spans

    def __enter__(self):
        StageTimer.active = self
        return self

    def __exit__(self, *exc):
        StageTimer.active = None

    def record(self, name: "MarkName") -> None:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.marks.append((name, ev))

    def add(self, spans: Dict[str, float]) -> None:
        for k, ms in spans.items():
            self.replayed[k] = self.replayed.get(k, 0.0) + ms

    @staticmethod
    def spans(marks) -> Dict[str, float]:
        """Milliseconds of each (name or names, event) mark, by name: a
        part (a dotted name) from the mark before it, a stage from the
        stage mark before it, so a stage keeps its interval whether it has
        parts or not (a "start" mark opens a pass)."""
        out: Dict[str, float] = {}
        prev = prev_stage = None
        for names, ev in marks:
            names = (names,) if isinstance(names, str) else names
            for name in names:
                since = prev if "." in name else prev_stage
                if name != "start" and since is not None:
                    out[name] = out.get(name, 0.0) + since.elapsed_time(ev)
            prev = ev
            if any("." not in name for name in names):
                prev_stage = ev
        return out

    def totals(self) -> Dict[str, float]:
        torch.cuda.synchronize()
        out = {k: 0.0 for k in self.STAGES}
        for spans in (self.spans(self.marks), self.replayed):
            for k, ms in spans.items():
                out[k] = out.get(k, 0.0) + ms
        return out


# a mark's name: a stage's, a part's, or (last part, stage) for the mark
# that ends both
MarkName = Union[str, Tuple[str, str]]


def _mark(name: MarkName, dev: torch.device) -> None:
    t = StageTimer.active
    if t is not None and dev.type == "cuda":
        t.record(name)


def _saturate_i32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> int32 truncating toward zero and saturating out of range,
    as XLA's convert does (1e30 becomes 2147483647)."""
    hi = x >= 2147483648.0
    lo = x < -2147483648.0
    safe = torch.where(hi | lo, 0.0, x).to(torch.int64)
    return torch.where(hi, 2147483647,
                       torch.where(lo, -2147483648, safe)).to(torch.int32)


class OneBatch:
    """map_batch's batch-level choices, made over the batch it is given:
    the order of the DP rows (and, with ``C_dp < C``, which candidates get
    one), the rows of the SDP pass, and the rows that get a traceback
    slot.  ``dist.mesh``'s data axis gives map_batch a subclass that makes
    them over the whole batch of a group of ranks, each holding a block."""

    def n_reads(self, B: int) -> int:
        """The reads of the batch the choices are made over."""
        return B

    def dp_rows(self, rank, span, n_dp: int) -> torch.Tensor:
        """This batch's DP rows, as candidate indices [n_dp], in the
        batch's order: the first ``n_dp`` by ``rank``, then by ``span``
        (both stable)."""
        sel = torch.argsort(rank, stable=True)[:n_dp]
        return sel[torch.argsort(span[sel], stable=True)]

    def first(self, key, k: int):
        """(the DP rows among the first ``k`` of the batch's rows by
        ``key``, stable; their places in that list)."""
        rows = torch.argsort(key, stable=True)[:k]
        return rows, torch.arange(rows.shape[0], device=key.device)


ONE_BATCH = OneBatch()


def map_batch(index: DeviceIndex, reads, read_len, submat, gap_costs,
              sig_thresh=0.0, min_interval_weight=0.0, sdp_bypass=1e6,
              qv1=None, qv2=None, qv_rescore=None, *,
              cfg_k: int, L: int, W: int, w_b: int, C: int, A: int, O: int,
              E: int, T: int, max_chain: int, min_match: int,
              max_anchors_per_pos: int, max_lcp: int, indel_rate: float,
              C_dp: int = 0, use_pallas: bool = False,
              p_value_type: int = 3, lookback: int = 0,
              global_chain: bool = False, aggressive_cut: bool = False,
              advance_exact: int = 0, k_sdp: int = 0, sdp_occ: int = 2,
              between_only: bool = False, guide_drift: float = 1.0,
              cand_drift: float = 0.0, full_widen: bool = False,
              tb_cap: int = 0, use_hp: bool = False, use_qv: bool = False,
              qv_score_type: int = 0,
              occ_block_sample: bool = False,
              choices: OneBatch = ONE_BATCH) -> PackedBatch:
    """One batch through the device pipeline (the JAX ``map_batch``
    without its profiling options).

    reads int8 [B, L] and read_len int32 [B] live on the index's device;
    ``submat`` is the flattened 5x5 matrix (numpy, host), ``gap_costs`` the
    six floats (ins_open, ins_ext, del_open, del_ext, hp_open, hp_ext).
    On CUDA the DP runs K1 at band width 128 and K1-W at any other
    (``use_pallas``, band 128, also sends CPU tensors through K1's entry,
    whose slope fault the batch then carries), in the mode the other flags
    ask for: ``use_hp`` the homopolymer-insertion
    band (K1-HP), ``use_qv`` the QV-steered DP (K1-QV) on the packed
    per-read cost tracks qv1/qv2 (int32 [B, L], forward orientation), a
    matrix that is not two-valued the GEN form of either; with
    ``qv_score_type`` 0 the reported score of a traced row is the distance
    rescore of its path with ``qv_rescore`` (float32 [4]: match, mismatch,
    ins, del).  ``occ_block_sample`` samples over-abundant seeds as a
    contiguous occurrence window (K5's block mode).  ``choices`` makes the
    batch-level choices (:class:`OneBatch`: over this batch)."""
    dev = reads.device
    f32, i32, i64 = torch.float32, torch.int32, torch.int64
    B = reads.shape[0]
    G = index.genome.shape[0]

    _mark("start", dev)
    rc = _revcomp_batch(reads, read_len)
    reads2 = torch.cat([reads, rc], dim=0)                   # [2B, L]
    rlen2 = torch.cat([read_len, read_len], dim=0)

    anchors = find_anchors(
        index.genome, index.keys_sorted, index.pos_sorted, reads2, rlen2,
        k=cfg_k, occ_per_pos=O, max_anchors=A, anchor_ext=E,
        min_match=min_match, max_anchors_per_pos=max_anchors_per_pos,
        max_lcp=max_lcp, advance_exact=advance_exact,
        occ_block_sample=occ_block_sample,
        bucket_starts=index.bucket_starts, bucket_pairs=index.bucket_pairs,
        gwords=index.gwords, gnwords=index.gnwords,
        pos_records=index.pos_records)
    # the batch's seed counts, for the tail of flat
    seed_words = anchors.seed_counts.sum(dim=0).view(i32)
    _mark("anchors", dev)

    # max(2C, 16) chain intervals: the first C feed the DP, all of them
    # are the ClusterList analog
    C_stat = max(2 * C, 16)
    cands_all = chain_anchors(anchors, rlen2, n_cand=C_stat,
                              indel_rate=indel_rate,
                              rank_by_pvalue=p_value_type in (0, 1, 2),
                              p_value_type=p_value_type, lookback=lookback,
                              global_chain=global_chain,
                              drift_penalty=cand_drift)
    # float32 values as Python floats: compared in float32, no upload
    sig = float(np.float32(sig_thresh))
    miw = float(np.float32(min_interval_weight))
    cvalid = cands_all.valid & (cands_all.nlogp >= sig) \
        & (cands_all.score >= miw)
    if aggressive_cut:
        best_w = torch.where(cvalid, cands_all.score, 0.0).amax(
            dim=1, keepdim=True)
        cvalid = cvalid & (cands_all.score * 3.0 >= best_w)
    cands_all = cands_all._replace(valid=cvalid)
    cluster_stats = torch.stack([cands_all.score.to(i32),
                                 cvalid.to(i32)], dim=-1)
    cands_all = cands_all._replace(
        q_start=torch.where(cvalid, cands_all.q_start, 0),
        q_end=torch.where(cvalid, cands_all.q_end, 0),
        t_start=torch.where(cvalid, cands_all.t_start, 0),
        t_end=torch.where(cvalid, cands_all.t_end, 0))
    cands = cands_all._replace(
        q_start=cands_all.q_start[:, :C], q_end=cands_all.q_end[:, :C],
        t_start=cands_all.t_start[:, :C], t_end=cands_all.t_end[:, :C],
        score=cands_all.score[:, :C], n_anchors=cands_all.n_anchors[:, :C],
        nlogp=cands_all.nlogp[:, :C], valid=cands_all.valid[:, :C],
        end_idx=cands_all.end_idx[:, :C])
    if guide_drift > 0.0:
        # guide members from a drift-penalized chain pass (same end
        # anchors; the path cannot mosaic across tandem-repeat copies)
        pen = chain_anchors(anchors, rlen2, n_cand=1,
                            indel_rate=indel_rate,
                            rank_by_pvalue=p_value_type in (0, 1, 2),
                            p_value_type=p_value_type, lookback=lookback,
                            global_chain=global_chain,
                            drift_penalty=guide_drift)
        cands_for_guide = cands._replace(parent=pen.parent)
    else:
        cands_for_guide = cands
    mq, mt, ml, mvalid = chain_members(cands_for_guide, anchors,
                                       max_chain=max_chain)
    _mark("chain", dev)

    # candidate compaction: within-read rank first, then chain weight;
    # similar query spans grouped for the DP
    n2 = 2 * B
    c_dp = C_dp if C_dp > 0 else C
    n2_all = 2 * choices.n_reads(B)         # strand rows of the whole batch
    n_dp = n2_all * c_dp
    flat_valid = cands.valid.reshape(-1)
    c_rank = torch.arange(C, dtype=i64, device=dev).repeat(n2)
    sc_i = cands.score.reshape(-1).clamp(0, 131071).to(i64)
    rank = torch.where(flat_valid, c_rank * 131072 + (131071 - sc_i), BIG32)
    sel = choices.dp_rows(rank, -cands.q_end.reshape(-1), n_dp)
    n_rows = sel.shape[0]                   # the DP rows of these reads
    sel_valid = flat_valid[sel]

    def pick(x):
        return x.reshape(n2 * C, *x.shape[2:])[sel]

    # widen the chain span toward the read ends (margin 96, or the whole
    # read for the ambiguity-rescue deep pass)
    margin = L if full_widen else 96
    read_row = torch.div(sel, C, rounding_mode="floor")
    rlen_sel = rlen2.to(i64)[read_row]
    qa0 = pick(cands.q_start)
    qb0 = torch.maximum(pick(cands.q_end), qa0 + 1)
    vsel_i = sel_valid.to(i64)
    head = torch.clamp(qa0, max=margin) * vsel_i
    tail = (rlen_sel - qb0).clamp(0, margin) * vsel_i
    ts0 = pick(cands.t_start)
    ts = torch.clamp(ts0 - head, min=0)
    te = pick(cands.t_end) + tail
    # contig lookup on the unwidened start
    ci = torch.searchsorted(index.contig_starts, ts0, side="right") - 1
    ci = ci.clamp(0, index.contig_starts.shape[0] - 1)
    c_lo = index.contig_starts[ci]
    c_hi = index.contig_ends[ci]
    ws = torch.clamp(ts - w_b, min=c_lo - 1,
                     max=torch.maximum(c_hi - W, c_lo - 1))
    ws = torch.clamp(ws, min=0)
    _mark("guide_sdp.compact", dev)

    gpad = index.genome_pad
    if gpad is None or gpad.shape[0] < G + W:
        raise ValueError(f"the index's genome_pad holds fewer than W = {W} "
                         "codes past the genome (DeviceIndex.with_pad)")
    wstart = ws.clamp(0, G)      # lax.dynamic_slice clamps its start
    windows = gpad[wstart[:, None]
                   + torch.arange(W, device=dev)[None, :]]   # [N_dp, W]

    ta = torch.maximum(ts, c_lo) - ws
    tb = torch.minimum(torch.minimum(te, c_hi), ws + W) - ws
    tb = torch.maximum(tb, ta + 1)

    reads_sel = reads2[read_row]                             # [N_dp, L]
    qa = qa0 - head
    qb = torch.maximum(torch.minimum(qb0 + tail, rlen_sel), qa + 1)

    # SDP guide densification: the anchor stage's raw per-position hits
    # are the fragment set
    q3 = torch.arange(L, dtype=i64, device=dev)[None, :, None]
    ht = anchors.hits_t[read_row]                            # [N_dp, L, O]
    hv = anchors.hits_valid[read_row]
    _mark("guide_sdp.gather", dev)
    frag_diag = ht - ws[:, None, None] - q3
    ratio = ((pick(cands.t_end) - ts0).to(f32)
             / torch.clamp(rlen_sel, min=1).to(f32))
    no_bypass = ratio < float(np.float32(sdp_bypass))
    frag_ok = (hv & (ht >= ws[:, None, None])
               & (ht < (ws + W)[:, None, None])
               & no_bypass[:, None, None])

    mcw = mq.shape[-1]
    mqs = pick(mq.reshape(n2, C, mcw))
    mts = pick(mt.reshape(n2, C, mcw))
    offs = _band_offsets(mqs, mts, ws, L, W, w_b,
                         frag_diag, frag_ok, between_only)
    if k_sdp > 0:
        _mark("guide_sdp.fragments", dev)
        # short-tuple window pass: the top-2 chain-ranked candidates per
        # strand-row plus lower-ranked ones whose guide has an anchor
        # desert wider than the band
        from blasr_tpu_torch.kernels.sdp import window_fragment_diags_banded
        n_sdp = min(3 * n2_all, n_dp)
        gmask = (sel % C) < 2
        mv = mqs < BIG32
        desert = ((mv[:, 1:] & mv[:, :-1]
                   & (mqs[:, 1:] - mqs[:, :-1] > w_b)).any(dim=1)
                  & sel_valid & no_bypass)
        prio = torch.where(gmask, 0, torch.where(desert, 1, 2))
        srows = choices.first(prio, n_sdp)[0]
        rk2, rv2 = read_kmer_keys(reads2, rlen2, k_sdp)
        rr = read_row[srows]
        wfd, wfo = window_fragment_diags_banded(
            rk2[rr], rv2[rr], windows[srows],
            torch.full((srows.shape[0],), W, dtype=i64, device=dev),
            offs[srows],
            k=k_sdp, occ=sdp_occ, w_b=w_b)
        fd2 = torch.cat([frag_diag[srows], wfd], dim=2)
        fo2 = torch.cat([frag_ok[srows],
                         wfo & no_bypass[srows][:, None, None]], dim=2)
        offs_sub = _band_offsets(mqs[srows], mts[srows], ws[srows], L, W,
                                 w_b, fd2, fo2, between_only)
        offs = offs.clone()
        offs[srows] = offs_sub

    _mark(("guide_sdp.sdp" if k_sdp > 0 else "guide_sdp.fragments",
           "guide_sdp"), dev)
    dp_args = (reads_sel.contiguous(), windows.contiguous(),
               offs.to(i32).contiguous(), qa.to(i32), qb.to(i32),
               ta.to(i32), tb.to(i32))
    g = [float(x) for x in gap_costs[:4]]
    # the homopolymer-insertion band of the affine path (QV mode has none)
    hp = (dict(use_hp=True, hp_open=float(gap_costs[4]),
               hp_ext=float(gap_costs[5])) if use_hp else {})
    qv = {}
    if use_qv:
        # QV-steered DP: per-read packed cost tracks, reversed by read_len
        # (+ tag-complemented in qv1) for the rc rows
        qv1_2 = torch.cat([qv1, _revcomp_qv(qv1, read_len,
                                            tag_shifts=(24, 27))], dim=0)
        qv2_2 = torch.cat([qv2, _revcomp_qv(qv2, read_len)], dim=0)
        qv = dict(qv1=qv1_2[read_row].contiguous(),
                  qv2=qv2_2[read_row].contiguous())
    fault = torch.zeros((), dtype=torch.bool, device=dev)
    if use_pallas or dev.type == "cuda":
        # K1 at band 128, K1-W at any other width (the plain DP on CPU
        # tensors); K1's slope limit is checked on the device: the flag
        # rides in flat and unpack_batch raises on it
        if w_b == 128:
            fault = slope_fault(dp_args[2], dp_args[3], dp_args[4])
        res = banded_align_cuda(*dp_args, submat, *g, w_b=w_b, **hp, **qv,
                                slope_checked=True)
    else:
        res = banded_align(*dp_args, submat, *g, w_b=w_b, **hp, **qv)
    valid_sel = sel_valid & res.valid
    _mark("banded_dp", dev)

    # traceback compaction: the top nCandidates alignments per READ (both
    # strands, DP score with deterministic ties) get a traceback
    n_tb = min(n2_all // 2 * C, n_dp)
    read_of = read_row % B
    sc_key = torch.where(valid_sel, torch.where(res.valid, res.score,
                                                0.0).to(i64), BIG32)
    ii = torch.arange(n_rows, device=dev)
    same_read = read_of[:, None] == read_of[None, :]
    better = ((sc_key[None, :] < sc_key[:, None])
              | ((sc_key[None, :] == sc_key[:, None])
                 & (ii[None, :] < ii[:, None])))
    tb_rank = (same_read & better).sum(dim=1)
    keep_tb = valid_sel & (tb_rank < C)
    tb_rows, tb_slots = choices.first(torch.where(keep_tb, 0, 1), n_tb)
    _mark("traceback.rank", dev)

    # the walk reads the traced rows' cell words, offsets and bounds in
    # place through tb_rows: no copy of them precedes it
    _mark("traceback.gather", dev)
    t_rl = tb_cap if tb_cap > 0 else max(128, (3 * T) // 8)
    tbk = banded_traceback(res, *dp_args[2:7], rows=tb_rows, t_max=t_rl,
                           w_b=w_b)
    _mark(("traceback.k2", "traceback"), dev)

    def back(v):
        out = torch.zeros((n_rows,), dtype=v.dtype, device=dev)
        out[tb_rows] = v
        return out

    slot_of_dp = torch.full((n_rows,), -1, dtype=i64, device=dev)
    slot_of_dp[tb_rows] = tb_slots
    slot_of_dp = torch.where(keep_tb, slot_of_dp, -1)

    def scatter(vals, fill=0):
        buf = torch.full((n2 * C,) + tuple(vals.shape[1:]), fill,
                         dtype=vals.dtype, device=dev)
        buf[sel] = vals
        return buf.reshape(n2, C, *vals.shape[1:])

    dp_slot = scatter(slot_of_dp, -1).to(i32)
    score_out = res.score
    if use_qv and not qv_score_type:
        # the QV DP chose the path; the reported score is its distance
        # rescore (scoreType 0); untraced rows keep the QV score.  Every
        # term is an integer below 2^24, so float32 gives XLA's bits with
        # or without a fused multiply-add: no xla_math emulation needed.
        f = [tbk.n_match, tbk.n_mismatch, tbk.n_ins, tbk.n_del]
        score_dist = (qv_rescore[0] * f[0].to(f32)
                      + qv_rescore[1] * f[1].to(f32)
                      + qv_rescore[2] * f[2].to(f32)
                      + qv_rescore[3] * f[3].to(f32))
        score_out = torch.where(keep_tb, back(score_dist), res.score)
    ints = torch.stack([
        scatter(valid_sel.to(i32)),
        scatter(qa.to(i32)),
        scatter(qb.to(i32)),
        scatter((ta + ws - 1).to(i32)),   # -1: device genome sentinel
        scatter((tb + ws - 1).to(i32)),
        scatter(back(tbk.n_match)),
        scatter(back(tbk.n_mismatch)),
        scatter(back(tbk.n_ins)),
        scatter(back(tbk.n_del)),
        dp_slot,
        _saturate_i32(scatter(score_out, 1e30)),
        _saturate_i32(cands.score.reshape(n2, C)),
        cands.n_anchors.reshape(n2, C).to(i32),
        anchors.n_total[:, None].expand(n2, C).to(i32),
        cands.valid.reshape(n2, C).to(i32),
        scatter(back(tbk.overflow.to(i32))),
        anchors.n_clipped[:, None].expand(n2, C).to(i32),
    ], dim=-1)
    packed = tbk.pairs
    # the query rows the valid DP items need, of the n_dp x L K1 stores
    rows_used = torch.where(sel_valid, qb - qa, 0).sum().to(i32)
    flat = torch.cat([ints.reshape(-1), cluster_stats.reshape(-1),
                      packed.reshape(-1), seed_words, rows_used.reshape(1),
                      fault.to(i32).reshape(1)])
    _mark("pack", dev)
    return PackedBatch(ints=ints, ops=packed, clusters=cluster_stats,
                       flat=flat, dp_rows=n_rows * L)


# ---------------------------------------------------------------------------
# host wrapper
# ---------------------------------------------------------------------------

@dataclass
class Alignment:
    """Host-side alignment record (reference AlignmentCandidate analog,
    iblasr/ReadAlignments.hpp:8)."""

    qname: str
    qlen: int
    qstart: int          # forward-read coordinates
    qend: int
    strand: int          # 0 fwd, 1 rc
    tindex: int          # contig index
    tname: str
    tlen: int
    tstart: int          # forward contig coordinates
    tend: int
    score: float
    n_match: int
    n_mismatch: int
    n_ins: int
    n_del: int
    map_qv: int = 254
    cigar: Optional[List] = None      # list of (op_char, count), query-fwd order
    read: Optional[np.ndarray] = None  # read codes (forward orientation)
    qual: Optional[np.ndarray] = None
    tracks: Optional[dict] = None      # named QV tracks (fwd orientation)
    n_candidates: int = 0
    n_significant_clusters: int = 0
    cluster_weight: float = 0.0  # anchor bases of the producing chain
    #                              (WeightedInterval size; feeds the
    #                              anchor-distribution significance gate)
    band_width: int = 128  # DP band that produced this alignment (the
    #                        nCells metric scales with it)

    @property
    def pct_similarity(self) -> float:
        n = self.n_match + self.n_mismatch + self.n_ins + self.n_del
        return 100.0 * self.n_match / n if n else 0.0

    @property
    def n_cells(self) -> int:
        return (self.qend - self.qstart) * self.band_width


# placeholder CIGAR for alignments awaiting batched assembly: truthy (the
# has-blocks bit is known before assembly) and visibly bogus if it leaks
_CIGAR_PENDING: List = [("?", -1)]


class LazyCigar:
    """CIGAR runs held as raw (op-code, count) arrays; the [(op_char, n),
    ...] tuple list materializes on first element access and is cached.

    Building the tuple list is the single largest host cost of the
    mapping loop (~0.4 ms for a noisy 2 kb alignment with ~1400 runs),
    and the loop itself only ever needs truthiness/len — which this
    answers from the array shape.  Printing/rescoring of the alignments
    that survive hit selection pays materialization, exactly once."""

    __slots__ = ("_ops", "_cnts", "_list")

    def __init__(self, ops: np.ndarray, cnts: np.ndarray):
        self._ops = ops
        self._cnts = cnts
        self._list = None

    def _mat(self) -> List:
        if self._list is None:
            from blasr_tpu_torch.native import runs_to_list
            self._list = runs_to_list(self._ops, self._cnts)
        return self._list

    def __len__(self):
        return int(self._ops.shape[0])

    def __bool__(self):
        return self._ops.shape[0] > 0

    def __iter__(self):
        return iter(self._mat())

    def __getitem__(self, i):
        return self._mat()[i]

    def __add__(self, other):
        return self._mat() + list(other)

    def __radd__(self, other):
        return list(other) + self._mat()

    def __eq__(self, other):
        if isinstance(other, LazyCigar):
            other = other._mat()
        return self._mat() == other

    def __repr__(self):
        return f"LazyCigar({self._mat()!r})"

    def arrays(self):
        """(op codes uint8 [n] per 1=M 2=I 3=D 4=X, counts int32 [n])."""
        return self._ops, self._cnts


def unpack_pairs(words: np.ndarray):
    """RL traceback words (one TracebackResult.pairs row) -> (ops, counts)
    end-first.  Each int32 word holds two uint16 halves (low first), each
    half = op | count << 2; op 0 = stop."""
    u = np.ascontiguousarray(words, dtype=np.int32).view(np.uint32)
    h = np.empty(u.size * 2, dtype=np.uint32)
    h[0::2] = u & 0xFFFF
    h[1::2] = u >> 16
    ops = (h & 3).astype(np.uint8)
    stop = np.nonzero(ops == 0)[0]
    n = int(stop[0]) if stop.size else len(ops)
    cnts = (h[:n] >> 2).astype(np.int64)
    keep = cnts > 0  # zero-count no-op pairs (traceback stall steps)
    return ops[:n][keep], cnts[keep]


def pairs_to_cigar(words: np.ndarray) -> List:
    """RL traceback words -> run-length [(op, n), ...] in alignment order.
    Adjacent same-op pairs (RUN_CAP segments, single-base indel steps)
    coalesce.  op codes: 1 'M', 2 'I', 3 'D'."""
    ops, cnts = unpack_pairs(words)
    n = len(ops)
    if n == 0:
        return []
    ops = ops[::-1]
    cnts = cnts[::-1]
    sym = "?MID"
    keep = np.concatenate([[True], ops[1:] != ops[:-1]])
    starts = np.nonzero(keep)[0]
    ends = np.concatenate([starts[1:], [n]])
    csum = np.concatenate([[0], np.cumsum(cnts)])
    return [(sym[ops[s]], int(csum[e] - csum[s]))
            for s, e in zip(starts, ends)]


def split_match_runs(cigar: List, query: np.ndarray,
                     target: np.ndarray) -> List:
    """Split 'M' runs into '='/'X' by sequence comparison (cigarUseSeqMatch,
    RegisterBlasrOptions.h --cigarUseSeqMatch).  query/target: the aligned
    subsequences (strand-local query [qa:qb], target [ts:te])."""
    out: List = []
    qi = ti = 0
    for op, n in cigar:
        if op == "M":
            eq = query[qi:qi + n] == target[ti:ti + n]
            start = 0
            for j in range(1, n + 1):
                if j == n or eq[j] != eq[start]:
                    sym = "=" if eq[start] else "X"
                    if out and out[-1][0] == sym:
                        out[-1] = (sym, out[-1][1] + j - start)
                    else:
                        out.append((sym, j - start))
                    start = j
            qi += n
            ti += n
        else:
            out.append((op, n))
            if op in "I=X":
                qi += n
            if op in "D":
                ti += n
            if op in "=X":
                ti += n
    return out


def merge_adjacent_indels(cigar: List) -> List:
    """Convert adjacent I/D (or D/I) pairs into match columns, as the
    reference SAM printer does unless --allowAdjacentIndels
    (ctest/cigarAdjecentIndels.t contract: no ID or DI in CIGAR)."""
    runs = list(cigar)
    changed = True
    while changed:
        changed = False
        out: List = []
        i = 0
        while i < len(runs):
            if (i + 1 < len(runs)
                    and runs[i][0] in "ID" and runs[i + 1][0] in "ID"
                    and runs[i][0] != runs[i + 1][0]):
                a, na = runs[i]
                b, nb = runs[i + 1]
                m = min(na, nb)
                # folded columns consume both sides with unknown match
                # status -> 'M' (the reference's SAM convention; claiming
                # 'X' would assert a mismatch the bases may not have).
                # --cigarUseSeqMatch later splits 'M' into '='/'X' by
                # actual comparison.
                out.append(("M", m))
                if na > m:
                    out.append((a, na - m))
                if nb > m:
                    out.append((b, nb - m))
                i += 2
                changed = True
            else:
                out.append(runs[i])
                i += 1
        # coalesce equal neighbours
        runs = []
        for op, n in out:
            if runs and runs[-1][0] == op:
                runs[-1] = (op, runs[-1][1] + n)
            else:
                runs.append((op, n))
    return runs



class Mapper:
    """Host driver: buckets reads by length, invokes the device pipeline,
    and produces :class:`Alignment` records (coordinate bookkeeping,
    CIGAR assembly, strand flips).  The JAX package's ``Mapper`` with its
    device seam (``__init__``, ``warmup``, ``_run_bucket``) on PyTorch;
    sub-mappers are built with ``type(self)``."""

    def __init__(self, gi: GenomeIndex, params: MappingParams,
                 cfg: Optional[ShapeConfig] = None, metrics=None, dev=None,
                 rescue: Optional["Mapper"] = None, device=None):
        from blasr_tpu_torch.pipeline.metrics import MappingMetrics
        # rescue: a second Mapper over a more sensitive index (e.g. k=12
        # when this one uses the k=14 large-genome LUT); reads that end up
        # unmapped or weakly mapped re-run through it and keep the better
        # result.  It runs on this Mapper's device.
        self.rescue = rescue
        self._anchor_totals: Dict[int, int] = {}
        self._ambiguity_rescue = True
        self._vlog_file = None
        self.gi = gi
        self.params = params.make_sane()
        self.cfg = cfg or ShapeConfig(n_candidates=self.params.n_candidates)
        mapp = self.params.max_anchors_per_position
        if 0 < mapp <= 256 and mapp > self.cfg.occ_per_pos:
            self.cfg = dataclasses.replace(
                self.cfg, occ_per_pos=mapp,
                max_anchors=max(self.cfg.max_anchors, 4 * mapp))
        self.metrics = metrics or MappingMetrics()
        if device is None:
            device = dev.genome.device if dev is not None else "cuda"
        self.device = torch.device(device)
        if rescue is not None and rescue.device != self.device:
            raise ValueError(f"the rescue Mapper runs on {rescue.device}, "
                             f"this one on {self.device}")
        self.dev = (dev if dev is not None
                    else DeviceIndex.from_host(gi, self.device))
        # map_batch gathers every bucket's windows from the padded genome
        self.dev = self.dev.with_pad(self.cfg.window_len(self.cfg.buckets[-1]))
        m = np.asarray(self.params.score_matrix, dtype=np.float32).reshape(25)
        # the host matrix: K1 takes it by value, so a batch reads no
        # device copy of it
        self.submat = m
        self.submat_np = m
        p = self.params
        # QV-steered DP (--useQuality): the IDS/QV score function runs
        # inside the banded kernel (K1-QV on CUDA); reads without QVs get
        # flat per-row costs that reproduce the distance-mode DP exactly
        self.use_qv = not p.ignore_qualities
        # distance-matrix rescore of the QV-chosen path: match/mismatch
        # from the matrix, indels at params.indel
        self.qv_rescore = torch.tensor([m[0], m[1], p.indel, p.indel],
                                       dtype=torch.float32,
                                       device=self.device)
        # K1 on CUDA (the plain DP on CPU tensors) in every mode: distance,
        # QV, the affine path's hp band, each with any matrix; map_batch
        # runs K1-W on CUDA at any other band width
        self.use_pallas = self.cfg.band_width == 128
        if p.affine_align:
            gaps = [p.affine_open + p.insertion, max(p.affine_extend, 1),
                    p.affine_open + p.deletion, max(p.affine_extend, 1),
                    # hp ins open/extend = indel+2 / indel-3
                    # (AffineKBandAlign call, BlasrAlignImpl.hpp:1262-1263)
                    p.indel + 2, max(p.indel - 3, 1)]
        else:
            gaps = [p.insertion, p.insertion, p.deletion, p.deletion, 0, 0]
        self.gap_costs = [float(x) for x in gaps]

    def _chain_lookback(self) -> int:
        """Transition-window size for the chain DP: --fastMaxInterval
        limits each anchor to the 64 most recent predecessors (the
        reference's faster, less exhaustive interval search); --advanceHalf
        halves whatever window applies (its "clustering begins at
        a_(n/2)" speed trick, RegisterBlasrOptions.h:312-316)."""
        p = self.params
        d = 64 if p.fast_max_interval else 0
        if p.advance_half:
            base = d if d else self.cfg.max_anchors
            d = max(base // 2, 32)
        return d

    def batch_size_for(self, bucket: int) -> int:
        # keep traceback HBM bounded: 2B*C*L*w_b bytes
        budget = self.cfg.hbm_budget
        b = budget // (2 * self.cfg.n_candidates * bucket * self.cfg.band_width)
        # the anchor stage materializes [2B, L, O] expansions (~16 int32
        # planes incl. the fused 24-byte records); deep occ_per_pos runs
        # (emit-all flag / ambiguity rescue) must shrink the batch
        b2 = budget // (2 * bucket * self.cfg.occ_per_pos * 16)
        return int(max(1, min(self.cfg.batch_size, b, b2)))

    def _batch_call_args(self, L: int, tb_cap: int = 0):
        """(positional args after reads/lens, static kwargs) of the
        map_batch call for bucket L — shared by dispatch and warmup."""
        cfg, p = self.cfg, self.params
        W = cfg.window_len(L)
        sig = float(np.log(2.0 * max(self.gi.glen, 2) * L))
        pos = (self.submat, self.gap_costs, np.float32(sig),
               np.float32(p.min_interval_weight),
               np.float32(p.sdp_bypass_threshold))
        kw = dict(
            cfg_k=self.gi.k, L=L, W=W, w_b=cfg.band_width,
            C=cfg.n_candidates, A=cfg.max_anchors, O=cfg.occ_per_pos,
            E=cfg.anchor_ext, T=L + W,
            max_chain=min(cfg.guide_anchors, cfg.max_anchors),
            min_match=p.min_match_length,
            max_anchors_per_pos=p.max_anchors_per_position,
            max_lcp=p.max_match_length, indel_rate=p.indel_rate,
            C_dp=cfg.dp_cands, use_pallas=self.use_pallas,
            p_value_type=p.p_value_type,
            lookback=self._chain_lookback(),
            global_chain=p.global_chain_type >= 1,
            aggressive_cut=p.aggressive_interval_cut,
            advance_exact=p.advance_exact_matches,
            k_sdp=min(p.sdp_tuple_size, 16),
            sdp_occ=1 if p.fast_sdp else 2,
            between_only=p.refine_between_anchors_only,
            use_hp=p.affine_align and not self.use_qv,
            use_qv=self.use_qv, qv_score_type=p.score_type,
            occ_block_sample=(cfg.occ_block_sample or bool(int(
                os.environ.get("BLASR_TPU_OCC_BLOCK", "0")))),
            cand_drift=p.candidate_drift_penalty,
            full_widen=cfg.full_widen,
            tb_cap=tb_cap)
        return pos, kw

    _TAG_CODE = None

    @classmethod
    def _tag_codes(cls):
        if cls._TAG_CODE is None:
            t = np.full(256, 7, np.int32)  # 7 = matches no target base
            for i, c in enumerate("ACGT"):
                t[ord(c)] = i
            cls._TAG_CODE = t
        return cls._TAG_CODE

    def pack_qv_rows(self, group, batch: int, L: int):
        """Per-read packed QV cost tracks (kernels.banded layout).

        Per-row fallbacks make every flavor exact: full IDS tracks use
        insertion/deletion/substitution QVs with tag-gated priors;
        plain-QV reads (FASTQ) price mismatches at the base's quality
        with flat indels (QualityValueScoreFunction, scoreFn.ins/del =
        params.indel); reads with no QVs at all reproduce the flat
        non-affine costs bit-for-bit."""
        p = self.params
        q1 = np.zeros((batch, L), np.int32)
        q2 = np.zeros((batch, L), np.int32)
        mm_default = int(np.clip(self.submat_np[1], 0, 255))
        tagc = self._tag_codes()
        for i, r in enumerate(group):
            n = min(len(r.seq), L)
            if n == 0:
                continue
            t = getattr(r, "tracks", None) or {}
            iq = t.get("InsertionQV")
            if iq is not None and len(np.unique(iq[:n])) > 1:
                # IDS flavor (reference gate: insertionQV present and
                # meaningful, BlasrMiscsImpl.hpp:50-77)
                insq = np.clip(iq[:n], 0, 255).astype(np.int32)
                dq = t.get("DeletionQV")
                if dq is not None:
                    delq = np.clip(dq[:n], 0, 255).astype(np.int32)
                    dt = t.get("DeletionTag")
                    if dt is not None:
                        dtag = tagc[np.asarray(dt[:n], np.uint8)]
                        dpri = np.full(n, p.global_deletion_prior,
                                       np.int32)
                    else:  # no tag: always the deletionQV
                        dtag = np.full(n, 7, np.int32)
                        dpri = delq
                else:
                    delq = np.zeros(n, np.int32)
                    dtag = np.full(n, 7, np.int32)
                    dpri = np.full(n, p.deletion, np.int32)
                sq = t.get("SubstitutionQV")
                if sq is not None:
                    subq = np.clip(sq[:n], 0, 255).astype(np.int32)
                    st = t.get("SubstitutionTag")
                    if st is not None:
                        stag = tagc[np.asarray(st[:n], np.uint8)]
                        spri = np.full(n, p.substitution_prior, np.int32)
                    else:
                        stag = np.full(n, 7, np.int32)
                        spri = subq
                else:
                    subq = np.zeros(n, np.int32)
                    stag = np.full(n, 7, np.int32)
                    spri = np.full(n, mm_default, np.int32)
            elif r.qual is not None and len(r.qual) >= n \
                    and len(np.unique(r.qual[:n])) > 1:
                # plain-QV flavor: mismatch = base quality, flat indels
                insq = np.full(n, p.indel, np.int32)
                delq = np.zeros(n, np.int32)
                dtag = np.full(n, 7, np.int32)
                dpri = np.full(n, p.indel, np.int32)
                subq = np.zeros(n, np.int32)
                stag = np.full(n, 7, np.int32)
                spri = np.clip(r.qual[:n], 0, 255).astype(np.int32)
            else:
                # no QVs: flat costs identical to the non-affine kernel
                insq = np.full(n, p.insertion, np.int32)
                delq = np.zeros(n, np.int32)
                dtag = np.full(n, 7, np.int32)
                dpri = np.full(n, p.deletion, np.int32)
                subq = np.zeros(n, np.int32)
                stag = np.full(n, 7, np.int32)
                spri = np.full(n, mm_default, np.int32)
            q1[i, :n] = (insq | (delq << 8) | (subq << 16)
                         | (dtag << 24) | (stag << 27))
            q2[i, :n] = dpri | (spri << 8)
        return q1, q2

    def warmup(self, buckets: Optional[Sequence[int]] = None,
               n_threads: int = 0) -> None:
        """Build (or load) the CUDA kernels, set their attributes, and
        capture the first-pass graph of each given bucket (default: every
        configured bucket) as the JAX warmup compiles it, unless it is
        cached already or the caller is inside ``graphs.eager_dispatch()``.
        The plain PyTorch path needs no warmup."""
        if self.device.type != "cuda":
            return
        from blasr_tpu_torch.kernels import cuda_ops
        cuda_ops._load(self.device)
        if graphs._eager:
            return
        cached = graphs.cache_for(self.dev).graphs
        for L in (self.cfg.buckets if buckets is None else buckets):
            batch = self.batch_size_for(L)
            pos, kw = self._batch_call_args(L)
            if graphs.graph_key(self.dev, batch, pos, kw) in cached:
                continue
            # N reads: the shapes are what a graph holds
            reads = torch.full((batch, L), 4, dtype=torch.int8,
                               device=self.device)
            lens = torch.zeros(batch, dtype=torch.int32, device=self.device)
            qv = None
            if self.use_qv:
                qv = tuple(torch.zeros((batch, L), dtype=torch.int32,
                                       device=self.device) for _ in range(2))
            graphs.prepare(self.dev, reads, lens, pos, kw, qv,
                           self.qv_rescore)

    def _run_bucket(self, recs: Sequence[FastaRecord], bucket: int,
                    batch: int) -> List[List[Alignment]]:
        cfg = self.cfg
        L = bucket
        W = cfg.window_len(L)
        T = L + W
        out: List[List[Alignment]] = []
        cuda = self.device.type == "cuda"

        def dispatch(arr, lens, tb_cap=0, qv=None):
            # on CUDA a replay of the key's graph (graphs.dispatch)
            pos, kw = self._batch_call_args(L, tb_cap)
            return graphs.dispatch(self.dev, arr, lens, pos, kw, qv,
                                   self.qv_rescore)

        def upload(a: np.ndarray) -> torch.Tensor:
            # pinned on CUDA, so the copy neither waits nor stages
            h = torch.from_numpy(a)
            if cuda:
                h = h.pin_memory()
            return h.to(self.device, non_blocking=cuda)

        # sliding-window pipeline: input transfers are staged LOOKAHEAD
        # batches ahead of dispatch (copies from pinned buffers, queued on
        # the stream without a wait), each result's copy to the host starts
        # at its dispatch (start_fetch), and results are collected once
        # more than LOOKAHEAD dispatches are in flight (collect overlaps
        # with the queued batches' compute).  Both ends bounded: host and
        # device memory stay O(LOOKAHEAD), not O(reads).
        def stage(base):
            with self.metrics.clock("map.stage"):
                group = recs[base:base + batch]
                arr = np.full((batch, L), 4, dtype=np.int8)
                lens = np.zeros(batch, dtype=np.int32)
                for i, r in enumerate(group):
                    n = min(len(r.seq), L)
                    arr[i, :n] = r.seq[:n]
                    lens[i] = n
                qv = None
                if self.use_qv:
                    qv = tuple(upload(q)
                               for q in self.pack_qv_rows(group, batch, L))
                return group, lens, upload(arr), upload(lens), qv

        def collect(group, lens, arr_d, lens_d, qv, res):
            with self.metrics.clock("collectAlignments"):
                res = unpack_batch(res)
                # dense rerun only when an overflowed traceback can reach
                # the output: candidates without a traceback slot are
                # dropped at collection, so their truncation is harmless
                if (res.overflow & res.valid & (res.dp_slot >= 0)).any():
                    with self.metrics.clock("mapToGenome"):
                        res = unpack_batch(
                            dispatch(arr_d, lens_d, tb_cap=T, qv=qv))
                out.extend(self._collect_batch(res, group, lens, batch))
            self.metrics.add("numReads", len(group))
            self.metrics.add("totalAnchors", int(res.n_anchors.sum()))
            self.metrics.add("totalCandidates", int(res.valid.sum()))
            self.metrics.add(
                "cells", int((res.q_end - res.q_start)[res.valid].sum())
                * cfg.band_width)

        # on CUDA every dispatch of a key replays one graph: the stream
        # runs each dispatch's input copies, replay and start_fetch copy in
        # order, so no later replay on the index (its graphs share one
        # pool) overwrites a flat before that flat's copy has read it
        LOOKAHEAD = 4
        bases = list(range(0, len(recs), batch))
        staged = {i: stage(b) for i, b in enumerate(bases[:LOOKAHEAD])}
        pending = []
        for i in range(len(bases)):
            if i + LOOKAHEAD < len(bases):
                staged[i + LOOKAHEAD] = stage(bases[i + LOOKAHEAD])
            group, lens, arr_d, lens_d, qv = staged.pop(i)
            with self.metrics.clock("mapToGenome"):
                res = start_fetch(dispatch(arr_d, lens_d, qv=qv))
            pending.append((group, lens, arr_d, lens_d, qv, res))
            if len(pending) > LOOKAHEAD:
                collect(*pending.pop(0))
        for item in pending:
            collect(*item)
        return out

    def _collect_batch(self, res: BatchResult, group: Sequence[FastaRecord],
                       lens: np.ndarray, B: int) -> List[List[Alignment]]:
        """Collect one batch's alignments (the host side of the per-ZMW
        print loop, Blasr.cpp:832-840): a vectorized candidate survey,
        per-read pruning on cheap fields, then ONE native call assembling
        every surviving CIGAR (run-for-run identical to the per-candidate
        path; tests/test_pipeline.py pins the decoder)."""
        with self.metrics.clock("collect.survey"):
            p = self.params
            seqdb = self.gi.seqdb
            C = res.score.shape[1]
            valid = res.valid & (res.dp_slot >= 0)
            if p.forward_only:
                valid[B:] = False
            # contig lookup + boundary-crossing drop: one searchsorted for the
            # whole batch instead of one per candidate
            starts = seqdb.starts
            ci = np.clip(
                np.searchsorted(starts, res.t_start, side="right") - 1,
                0, seqdb.n_contigs - 1)
            lo = starts[ci]
            valid &= res.t_end <= lo + seqdb.lengths[ci]
            # bulk scalar conversion: list indexing in the loops below is ~10x
            # cheaper than per-element numpy scalar reads
            valid_l = valid.tolist()
            qa_l, qb_l = res.q_start.tolist(), res.q_end.tolist()
            te_l, lo_l = res.t_end.tolist(), lo.tolist()
            ts_l = res.t_start.tolist()
            sc_l, ch_l = res.score.tolist(), res.chain_score.tolist()
            nm_l, nx_l = res.n_match.tolist(), res.n_mismatch.tolist()
            ni_l, nd_l = res.n_ins.tolist(), res.n_del.tolist()
            ci_l, slot_l = ci.tolist(), res.dp_slot.tolist()
            # an empty traceback (no blocks) starts with op 0 in halfword 0
            has_runs = ((res.ops[:, 0] & 3) != 0).tolist()
            names, tlens = seqdb.names, seqdb.lengths
            from blasr_tpu_torch.pipeline.select import (
                num_significant_clusters, prune_alignments)
            out: List[List[Alignment]] = []
            deferred: List[tuple] = []  # (alignment, traceback slot)
            for i, rec in enumerate(group):
                rlen = int(lens[i])
                self._anchor_totals[id(rec)] = (
                    int(res.n_anchors[i]) + int(res.n_anchors[i + B]),
                    int(res.n_clipped[i]) + int(res.n_clipped[i + B]))
                alns: List[Alignment] = []
                slot_of: Dict[int, int] = {}
                for strand in (0, 1):
                    row = i + strand * B
                    vrow, qar, qbr = valid_l[row], qa_l[row], qb_l[row]
                    for c in range(C):
                        if not vrow[c]:
                            continue
                        qa, qb = qar[c], qbr[c]
                        cidx = ci_l[row][c]
                        clo = lo_l[row][c]
                        slot = slot_l[row][c]
                        if strand == 0:
                            qs, qe = qa, qb
                        else:
                            qs, qe = rlen - qb, rlen - qa
                        a = Alignment(
                            qname=rec.name if rec.name else f"read/{i}",
                            qlen=rlen, qstart=qs, qend=qe, strand=strand,
                            tindex=cidx, tname=names[cidx],
                            tlen=int(tlens[cidx]),
                            tstart=ts_l[row][c] - clo, tend=te_l[row][c] - clo,
                            score=float(sc_l[row][c]),
                            n_match=nm_l[row][c], n_mismatch=nx_l[row][c],
                            n_ins=ni_l[row][c], n_del=nd_l[row][c],
                            cigar=_CIGAR_PENDING if has_runs[slot] else [],
                            read=rec.seq, qual=rec.qual,
                            tracks=getattr(rec, "tracks", None),
                            cluster_weight=float(ch_l[row][c]),
                            band_width=self.cfg.band_width,
                        )
                        alns.append(a)
                        slot_of[id(a)] = slot
                # alignment-level pruning (RemoveLowQualitySDPAlignments /
                # RemoveLowQualityAlignments / RemoveOverlappingAlignments,
                # BlasrUtilsImpl.hpp:447-605); needs no CIGAR beyond the
                # has-blocks bit, so assembly is deferred to the survivors
                alns = prune_alignments(alns, p, read_len=rlen)
                deferred.extend((a, slot_of[id(a)]) for a in alns)
                # anchor-distribution significance gate ->
                # numSignificantClusters (BlasrAlignImpl.hpp:391-488); the
                # cluster list is the gate-passing examined-cluster chain
                # weights of both strands
                cl = np.concatenate([
                    res.cluster_bases[i][res.cluster_valid[i]],
                    res.cluster_bases[i + B][res.cluster_valid[i + B]]])
                nsig = num_significant_clusters(alns, cl, p, k=self.gi.k)
                for a in alns:
                    a.n_candidates = len(alns)
                    a.n_significant_clusters = nsig
                out.append(alns)
        with self.metrics.clock("collect.cigars"):
            self._materialize_cigars(res.ops, deferred)
        if p.verbosity >= 1:
            # interval prints (reference -V, BlasrAlignImpl.hpp:260-277);
            # -V >=3 routes them to a per-process pid.shard.log file
            # (Blasr.cpp:757-764) and -V >=2 adds the sequence dumps
            w = self._vlog().write
            if p.verbosity >= 2:
                from blasr_tpu_torch.io.fasta import decode
                for i, rec in enumerate(group):
                    w(f"read {rec.name if rec.name else f'read/{i}'} "
                      f"{int(lens[i])}\n{decode(rec.seq[:int(lens[i])])}\n")
            for alns in out:
                for a in alns:
                    w(f"interval {a.qname} {a.qstart} {a.qend} {a.tname} "
                      f"{a.tstart} {a.tend} {int(a.score)} {a.strand}\n")
        return out

    def _vlog(self):
        """Verbose-log sink: stderr for -V 1/2, a per-process
        ``<pid>.<shard>.log`` file for -V >=3 (the reference opens one
        log per worker thread, Blasr.cpp:757-764)."""
        import sys
        if self.params.verbosity < 3:
            return sys.stderr
        if self._vlog_file is None:
            shard = os.environ.get("BLASR_TPU_HOST_ID", "0")
            self._vlog_file = open(f"{os.getpid()}.{shard}.log", "a")
        return self._vlog_file

    def _materialize_cigars(self, ops: np.ndarray,
                            deferred: List[tuple]) -> None:
        """Assemble CIGAR runs for (alignment, slot) pairs — one native
        call for the whole batch, per-slot fallback without the
        extension."""
        if not deferred:
            return
        p = self.params
        batch = None
        try:
            from blasr_tpu_torch.native import cigar_native_batch
            slots = np.fromiter((s for _, s in deferred), dtype=np.int64,
                                count=len(deferred))
            batch = cigar_native_batch(ops, slots, p.allow_adjacent_indels)
        except Exception:
            batch = None
        if batch is not None:
            ops_b, cnt_b, offs = batch
            for j, (a, _) in enumerate(deferred):
                a.cigar = LazyCigar(ops_b[offs[j]:offs[j + 1]],
                                    cnt_b[offs[j]:offs[j + 1]])
        else:
            for a, slot in deferred:
                cg = pairs_to_cigar(ops[slot])
                if not p.allow_adjacent_indels:
                    cg = merge_adjacent_indels(cg)
                a.cigar = cg
        if p.cigar_use_seq_match:
            from blasr_tpu_torch.io.fasta import revcomp
            for a, _ in deferred:
                if a.strand == 0:
                    oq, qa = a.read, a.qstart
                else:
                    oq, qa = revcomp(a.read[:a.qlen]), a.qlen - a.qend
                gs = self.gi.seqdb.chrom_to_genome(a.tindex, a.tstart)
                a.cigar = split_match_runs(
                    a.cigar, oq[qa:qa + (a.qend - a.qstart)],
                    self.gi.genome[gs:gs + (a.tend - a.tstart)])

    def _max_seed_depth(self, rec: FastaRecord) -> int:
        """Deepest k-mer occurrence count along a read, BOTH orientations
        (host-side; feeds the ambiguity rescue's emit-all occurrence
        capacity).  The index is forward-strand only, so a reverse-strand
        read's own k-mers barely hit it — the rc probe is what sees the
        true depth (a strand-1 tandem read measured depth 3 vs ~100)."""
        fwd = np.asarray(rec.seq)
        comp = np.array([3, 2, 1, 0, 4], dtype=fwd.dtype)
        rc = comp[fwd[::-1]]
        return max(self._max_seed_depth_1(fwd),
                   self._max_seed_depth_1(rc))

    def _max_seed_depth_1(self, seq: np.ndarray) -> int:
        gi = self.gi
        k = gi.k
        if len(seq) < k:
            return 0
        keys = np.zeros(len(seq) - k + 1, dtype=np.int64)
        ok = np.ones(len(seq) - k + 1, dtype=bool)
        for j in range(k):
            c = seq[j: j + len(keys)].astype(np.int64)
            keys = (keys << 2) | (c & 3)
            ok &= c < 4
        if not ok.any():
            return 0
        keys = keys[ok]
        if gi.bucket_starts is not None:
            nocc = (gi.bucket_starts[keys + 1].astype(np.int64)
                    - gi.bucket_starts[keys].astype(np.int64))
        else:
            ks = gi.keys_sorted
            nocc = (np.searchsorted(ks, keys.astype(np.uint32), "right")
                    - np.searchsorted(ks, keys.astype(np.uint32), "left"))
        # only depths the emitter would accept (over-abundant seeds are
        # skipped outright by maxAnchorsPerPosition)
        mapp = self.params.max_anchors_per_position
        if mapp:
            nocc = nocc[nocc <= mapp]
        return int(nocc.max()) if nocc.size else 0

    def _expanded(self, expand: int) -> "Mapper":
        """Mapper with anchoring loosened by 2^expand (the reference's
        expand parameter widens SA search bounds per retry)."""
        cfg = dataclasses.replace(
            self.cfg,
            occ_per_pos=self.cfg.occ_per_pos * 2 ** expand,
            max_anchors=self.cfg.max_anchors * 2 ** expand)
        return type(self)(self.gi, self.params, cfg, metrics=self.metrics,
                      dev=self.dev)

    @records_spans
    def map_reads(self, recs: Sequence[FastaRecord]) -> List[List[Alignment]]:
        """Map reads; returns per-read alignment lists in input order."""
        p = self.params
        self._anchor_totals.clear()
        order: Dict[int, List[Alignment]] = {}
        kept = [(j, r) for j, r in enumerate(recs)
                if len(r.seq) >= p.min_read_length
                and (p.max_read_length == 0 or len(r.seq) <= p.max_read_length)]
        for j in range(len(recs)):
            order[j] = []
        # reads beyond the largest bucket take the segment+stitch path
        long_items = [(j, r) for j, r in kept
                      if len(r.seq) > self.cfg.buckets[-1]]
        kept = [(j, r) for j, r in kept
                if len(r.seq) <= self.cfg.buckets[-1]]
        buckets: Dict[int, List] = {}
        for j, r in kept:
            b = self.cfg.bucket_for(len(r.seq))
            buckets.setdefault(b, []).append((j, r))
        # the initial pass runs at expansion level minExpand (the
        # reference's expand loop starts there, BlasrAlignImpl.hpp:24,
        # RegisterBlasrOptions.h --minExpand)
        first = self if p.min_expand == 0 else self._expanded(p.min_expand)
        if len(buckets) > 1:
            # compile the used buckets concurrently (XLA releases the
            # GIL): cold multi-bucket warmup in max() not sum() time
            first.warmup(sorted(buckets))
        for b, items in sorted(buckets.items()):
            batch = first.batch_size_for(b)
            results = first._run_bucket([r for _, r in items], b, batch)
            for (j, _), alns in zip(items, results):
                order[j] = alns
        # expand-retry loop (reference minExpand..maxExpand,
        # BlasrAlignImpl.hpp:319-336): reads with no alignment are retried
        # with progressively looser anchoring (more seed occurrences and
        # anchor capacity per retry)
        for expand in range(p.min_expand + 1, p.max_expand + 1):
            misses = [(j, r) for j, r in kept if not order[j]]
            if not misses:
                break
            retry = self._expanded(expand)
            rbuckets: Dict[int, List] = {}
            for j, r in misses:
                rbuckets.setdefault(
                    retry.cfg.bucket_for(len(r.seq)), []).append((j, r))
            for b, items in sorted(rbuckets.items()):
                batch = retry.batch_size_for(b)
                results = retry._run_bucket([r for _, r in items], b, batch)
                for (j, _), alns in zip(items, results):
                    order[j] = alns
        # anchor-ambiguity rescue (unrolled/repetitive templates,
        # ctest/bug25328.t): the reference's default emits every SA
        # occurrence per position (maxAnchorsPerPosition=10000,
        # MappingParameters.h:731), so its base pass resolves highly
        # repetitive templates that occ_per_pos sampling cannot.  Reads
        # whose anchor search saturated the capacity yet produced no
        # alignment get one deep-occurrence retry.
        if self._ambiguity_rescue:
            def coverage(j, r):
                if not order[j]:
                    return 0.0
                return max(a.qend - a.qstart for a in order[j]) / len(r.seq)

            def ambiguous(j, rlen):
                """Best placement has a distinct-locus competitor that is
                either within 15% of its score, or TRUNCATED but per-base
                competitive (full-span extrapolation would beat the best,
                and its identity is at least the best's): occurrence
                sampling may have starved the true copy's anchors, handing
                the win to a fully-anchored wrong copy via chain coverage
                (the reference never has this failure mode because it
                emits every occurrence — repeat microbench: 20/24 own-copy
                default vs 24/24 emit-all; 150-copy tandem diag: the true
                chain interval often starts mid-read)."""
                alns = order[j]
                if not alns or len(alns) < 2:
                    return False
                best = min(alns, key=lambda a: a.score)
                bspan = max(best.qend - best.qstart, 1)
                for a in alns:
                    if a is best:
                        continue
                    distinct = (a.tindex != best.tindex
                                or a.strand != best.strand)
                    if not distinct:
                        ov = (min(a.tend, best.tend)
                              - max(a.tstart, best.tstart))
                        distinct = 2 * ov < min(a.tend - a.tstart,
                                                best.tend - best.tstart)
                    if not distinct:
                        continue
                    if a.score <= best.score * 0.85:
                        return True
                    span = max(a.qend - a.qstart, 1)
                    if (span < 0.9 * rlen and span < bspan
                            and a.pct_similarity
                            >= best.pct_similarity - 2.0
                            and (a.score / span) * rlen < best.score):
                        return True
                return False

            deep = []
            for j, r in kept:
                total, clipped = self._anchor_totals.get(id(r), (0, 0))
                if clipped > max(total, 64) and coverage(j, r) < 0.5:
                    deep.append((j, r))
                elif clipped > 0 and ambiguous(j, len(r.seq)):
                    deep.append((j, r))
                elif clipped > 16 * max(total, 64):
                    # the read lives inside a deep repeat family (nearly
                    # every seed clipped): sampling may have handed the
                    # win to a wrong copy without leaving a visible
                    # competitor, so no score-based trigger can fire.
                    # The retry's result only replaces on a strictly
                    # better score, so this can't hurt accuracy.
                    deep.append((j, r))
            if deep:
                # raise the occurrence capacity to the deepest observed
                # seed depth among the rescued reads (bounded by
                # --maxAnchorsPerPosition and a device-memory cap),
                # rounded to a power of two so retry shapes stay reusable
                # — emit-all semantics where the heuristic fired
                # (reference default maxAnchorsPerPosition=10000)
                depth = max(self._max_seed_depth(r) for _, r in deep)
                mapp = self.params.max_anchors_per_position or 1024
                occ = min(max(48, depth), mapp, 1024)
                occ = 1 << (occ - 1).bit_length()
                dcfg = dataclasses.replace(
                    self.cfg,
                    occ_per_pos=max(occ, self.cfg.occ_per_pos),
                    max_anchors=max(2048, self.cfg.max_anchors),
                    # a 150-copy family competes for candidate slots;
                    # 10 of ~150 near-ties rarely include the true copy
                    # even with drift-penalized ranking
                    n_candidates=max(32, self.cfg.n_candidates),
                    full_widen=True)
                # the deep pass also ranks candidates drift-penalized:
                # with emit-all anchors every repeat copy chains to a
                # near-tie and mosaic chains hop copies for free, so the
                # true copy often misses the top-C cut (150-copy tandem
                # diag).  The rescue is already beyond reference
                # semantics; penalized ranking here leaves the default
                # pass reference-faithful while making the retry actually
                # resolve what it was invoked for.
                p_deep = (p if p.candidate_drift_penalty > 0 else
                          dataclasses.replace(
                              p, candidate_drift_penalty=1.0))
                dm = type(self)(self.gi, p_deep, dcfg, metrics=self.metrics,
                            dev=self.dev)
                dm._ambiguity_rescue = False
                with self.metrics.clock("ambiguityRescue"):
                    res = dm.map_reads([r for _, r in deep])
                for (j, r), alns in zip(deep, res):
                    if alns and (not order[j] or
                                 min(a.score for a in alns)
                                 < min(a.score for a in order[j])):
                        order[j] = alns
                    elif alns and p.full_span_mapqv:
                        # --fullSpanMapQV: the deep pass aligned every
                        # candidate against the FULL read span; even when
                        # its best does not beat the original, its
                        # near-tie competitors are the phase-ambiguity
                        # evidence the mapQV partition needs (reference
                        # AlignIntervals semantics).  Merge non-duplicate
                        # placements.
                        def dup(a, existing):
                            for e in existing:
                                if (e.strand == a.strand
                                        and e.tindex == a.tindex
                                        and abs(e.tstart - a.tstart) < 128):
                                    return True
                            return False
                        extra = [a for a in alns if not dup(a, order[j])]
                        if extra:
                            order[j] = order[j] + extra
        if self.rescue is not None:
            # cross-index rescue: unmapped or weak (< 72% similar) reads
            # re-map on the sensitive index; the better score wins
            weak = [(j, r) for j, r in kept
                    if not order[j]
                    or max(a.pct_similarity for a in order[j]) < 72.0]
            if weak:
                with self.metrics.clock("rescue"):
                    res = self.rescue.map_reads([r for _, r in weak])
                for (j, r), alns in zip(weak, res):
                    if alns and (not order[j]
                                 or min(a.score for a in alns)
                                 < min(a.score for a in order[j])):
                        order[j] = alns
        if p.do_sensitive_search:
            # --useSensitiveSearch (Blasr.cpp:404-414): reads that are
            # unmapped or whose best alignment is < 80% similar are re-run
            # with SetForSensitivity parameters (advanceExactMatches=0 +
            # looser anchoring); the sensitive result replaces the first
            # when it finds anything
            weak = [(j, r) for j, r in kept
                    if not order[j]
                    or max(a.pct_similarity for a in order[j]) < 80.0]
            if weak:
                sp = dataclasses.replace(p, advance_exact_matches=0,
                                         do_sensitive_search=False)
                scfg = dataclasses.replace(
                    self.cfg, occ_per_pos=self.cfg.occ_per_pos * 2,
                    max_anchors=self.cfg.max_anchors * 2)
                sens = type(self)(self.gi, sp, scfg, metrics=self.metrics,
                              dev=self.dev)
                for (j, r), alns in zip(
                        weak, sens.map_reads([r for _, r in weak])):
                    if alns:
                        order[j] = alns
        if long_items:
            from blasr_tpu_torch.pipeline.longread import map_long_reads
            with self.metrics.clock("longReads"):
                res = map_long_reads(self, [r for _, r in long_items], p)
            for (j, _), alns in zip(long_items, res):
                order[j] = alns
        if p.extend_alignments:
            from blasr_tpu_torch.pipeline.extend import extend_alignment
            with self.metrics.clock("extendAlignments"):
                for alns in order.values():
                    for a in alns:
                        extend_alignment(a, self.gi, p)
        return [order[j] for j in range(len(recs))]

    def dump_debug(self, recs: Sequence[FastaRecord],
                   anchors_out=None, clusters_out=None) -> None:
        """Debug taps: raw anchor dump (--anchors,
        BlasrAlignImpl.hpp:62-87) and per-read cluster statistics
        (--clusters, Blasr.cpp:1197-1204, BlasrAlignImpl.hpp:465-486).
        The anchors (K5 on CUDA) and the chain candidates (K3) of one read
        come to the host in one copy each."""
        cfg, p, dev = self.cfg, self.params, self.device
        if clusters_out is not None:
            clusters_out.write(
                "nBases qLength tLength nAnchors\n")
        for rec in recs:
            L = cfg.bucket_for(len(rec.seq))
            arr = np.full((1, L), 4, dtype=np.int8)
            n = min(len(rec.seq), L)
            arr[0, :n] = rec.seq[:n]
            reads = torch.from_numpy(arr).to(dev)
            rlen2 = torch.tensor([n, n], dtype=torch.int32, device=dev)
            reads2 = torch.cat([reads, _revcomp_batch(reads, rlen2[:1])])
            anchors = find_anchors(
                self.dev.genome, self.dev.keys_sorted, self.dev.pos_sorted,
                reads2, rlen2, k=self.gi.k, occ_per_pos=cfg.occ_per_pos,
                max_anchors=cfg.max_anchors, anchor_ext=cfg.anchor_ext,
                min_match=p.min_match_length,
                max_anchors_per_pos=p.max_anchors_per_position,
                max_lcp=p.max_match_length,
                bucket_starts=self.dev.bucket_starts,
                bucket_pairs=self.dev.bucket_pairs,
                gwords=self.dev.gwords, gnwords=self.dev.gnwords,
                pos_records=self.dev.pos_records)
            if anchors_out is not None:
                q, t, ln, v = torch.stack(
                    [anchors.q, anchors.t, anchors.l,
                     anchors.valid.to(torch.int64)]).cpu().numpy()
                v = v.astype(bool)
                for strand in (0, 1):
                    for q_, t_, l_ in zip(q[strand][v[strand]],
                                          t[strand][v[strand]],
                                          ln[strand][v[strand]]):
                        anchors_out.write(
                            f"{rec.name} {int(q_)} {int(t_) - 1} {int(l_)} "
                            f"{strand}\n")
            if clusters_out is not None:
                cands = chain_anchors(anchors, rlen2, n_cand=cfg.n_candidates,
                                      indel_rate=p.indel_rate,
                                      global_chain=p.global_chain_type >= 1)
                sc, na, cv = torch.stack(
                    [cands.score.to(torch.float64),
                     cands.n_anchors.to(torch.float64),
                     cands.valid.to(torch.float64)]).cpu().numpy()
                for strand in (0, 1):
                    for c in range(sc.shape[1]):
                        if cv[strand, c]:
                            clusters_out.write(
                                f"{int(sc[strand, c])} {n} "
                                f"{int(self.gi.glen)} "
                                f"{int(na[strand, c])}\n")

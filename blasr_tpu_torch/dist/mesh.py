"""Multi-device mapping on torch.distributed (port of
``blasr_tpu/dist/mesh.py``): data-parallel reads and reference-sharded
genomes.

The ranks of the default process group form a ``(data, ref)`` grid
(:func:`make_mesh`), with one process group per axis:

  * data axis: each rank maps its contiguous block of the batch
    (:func:`map_batch_data_parallel`); map_batch's few batch-level
    choices are made over the whole batch from keys all-gathered over the
    data group (:class:`WholeBatch`), so the blocks together give one
    map_batch over the whole batch;
  * ref axis: each rank holds a contiguous genome slice and its k-mer
    index (:func:`shard_index`, :func:`shard_device_index`) and runs the
    whole ``map_batch`` against it; the shards' outputs are
    ``all_gather``-ed over the ref group and merged on the device
    (:func:`merge_ref_shards`): the global best candidates per read,
    deterministically, since scores are integers and ties break on
    (shard, candidate) order.  The host globalizes the shard-local
    coordinates (:func:`globalize_sharded`).

The backend is the caller's choice, made once: NCCL where each rank has a
card of its own, gloo on the CPU (and for several ranks on one card).
Each shard's ``map_batch`` runs on the mesh's device: the hand-written
kernels on CUDA, their plain versions on the CPU.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch
import torch.distributed as dist

from blasr_tpu_torch.index.genome import GenomeIndex, build_kmer_index
from blasr_tpu_torch.pipeline.map_read import (
    BIG32, COL_DPSLOT, COL_NANCH, COL_NCLIP, COL_SCORE, COL_VALID, N_COLS,
    TAIL_WORDS, DeviceIndex, OneBatch, PackedBatch, map_batch)


@dataclass
class Mesh:
    """This rank's place in a ``(data, ref)`` grid of ranks: the axis
    sizes, its coordinates, the group of each axis it belongs to and the
    device its ``map_batch`` runs on."""

    shape: Dict[str, int]      # {"data": n_data, "ref": n_ref}
    data: int                  # this rank's coordinate on the data axis
    ref: int                   # ... and on the ref axis
    data_group: object         # the ranks that share this rank's ref
    ref_group: object          # the ranks that share this rank's data
    device: torch.device


def make_mesh(n_data: int, n_ref: int = 1, device=None) -> Mesh:
    """The ``(data, ref)`` grid over the default process group, rank
    ``d * n_ref + r`` at ``(d, r)`` (the JAX ``make_mesh`` reshape).  Every
    rank calls it: each group is made by all ranks, in one order, on the
    default group's backend.  ``device`` defaults to the card a launcher
    gave this process (``cuda:$LOCAL_RANK``, as torchrun sets it), else
    ``cuda``."""
    assert dist.is_initialized(), (
        "make_mesh: start the default process group first "
        "(torch.distributed.init_process_group)")
    world = dist.get_world_size()
    assert world == n_data * n_ref, (
        f"need {n_data * n_ref} ranks, have {world}")
    rank = dist.get_rank()
    d, r = divmod(rank, n_ref)
    grid = np.arange(world).reshape(n_data, n_ref)
    data_group = ref_group = None
    for j in range(n_ref):
        g = dist.new_group(grid[:, j].tolist())
        if j == r:
            data_group = g
    for i in range(n_data):
        g = dist.new_group(grid[i].tolist())
        if i == d:
            ref_group = g
    if device is None:
        local = os.environ.get("LOCAL_RANK")
        device = f"cuda:{int(local)}" if local is not None else "cuda"
    return Mesh({"data": n_data, "ref": n_ref}, d, r, data_group, ref_group,
                torch.device(device))


def _block(mesh: Mesh, x: np.ndarray) -> torch.Tensor:
    """This rank's contiguous block of the host batch ``x`` along the data
    axis, on the mesh's device."""
    n_data = mesh.shape["data"]
    B = x.shape[0]
    assert B % n_data == 0, f"batch {B} does not split over {n_data} ranks"
    b = B // n_data
    return torch.from_numpy(np.ascontiguousarray(
        x[mesh.data * b:(mesh.data + 1) * b])).to(mesh.device)


def _call_args(mesh: Mesh, submat, gap_costs, static):
    """map_batch's matrix, six gap costs and static keywords for the JAX
    mesh functions' arguments.  Four gap costs (ins open, ins ext, del
    open, del ext, what the JAX map_batch takes) get no hp band, as
    ``Mapper.__init__`` sets them outside the affine path.  On CUDA the DP
    goes to K1 (``use_pallas``): the JAX callers pass none and run XLA's
    ``banded_align``, whose output at band 128 is K1's, and the port's
    map_batch takes no other DP on the card."""
    m = np.asarray(submat, dtype=np.float32).reshape(25)
    g = [float(x) for x in np.asarray(gap_costs, dtype=np.float64).ravel()]
    if len(g) == 4:
        g += [0.0, 0.0]
    if mesh.device.type == "cuda":
        static = dict(static, use_pallas=True)
    return m, g, static


class WholeBatch(OneBatch):
    """map_batch's batch-level choices (:class:`OneBatch`) over the whole
    batch of the data group, for a rank that maps block ``mesh.data`` of
    it: each choice all-gathers its keys (one int64 a candidate or a DP
    row) over the group and makes it as one map_batch over the whole
    batch would, the same on every rank; the rank keeps its own rows.
    :meth:`assemble` then gathers the blocks' outputs into that
    map_batch's :class:`PackedBatch`."""

    def __init__(self, mesh: Mesh, b: int, C: int):
        self.group, self.n, self.me = mesh.data_group, mesh.shape["data"], \
            mesh.data
        self.b, self.C = b, C
        dev = mesh.device
        # the whole batch's candidate index of each rank's candidates,
        # rows [fwd x b, rc x b] of block d at d * b and B + d * b
        B = self.n * b
        d = torch.arange(self.n, device=dev)[:, None]
        i = torch.arange(2 * b, device=dev)[None, :]
        row = torch.where(i < b, d * b + i, B + d * b + i - b)
        self.cand = (row[..., None] * C
                     + torch.arange(C, device=dev)).reshape(self.n, -1)
        flat = self.cand.reshape(-1)
        self.owner_of = torch.empty_like(flat)
        self.owner_of[flat] = d.expand_as(self.cand).reshape(-1)
        self.local_of = torch.empty_like(flat)
        self.local_of[flat] = torch.arange(
            2 * b * C, device=dev).repeat(self.n)

    def n_reads(self, B: int) -> int:
        return self.n * B

    def _whole(self, x: torch.Tensor) -> torch.Tensor:
        """A per-candidate key of every block, in the whole batch's
        candidate order."""
        out = torch.empty(self.cand.numel(), dtype=torch.int64,
                          device=x.device)
        out[self.cand.reshape(-1)] = _all_gather(
            x.to(torch.int64), self.group, self.n).reshape(-1)
        return out

    def dp_rows(self, rank, span, n_dp: int) -> torch.Tensor:
        sel = super().dp_rows(self._whole(rank), self._whole(span), n_dp)
        self.owner = self.owner_of[sel]              # [n_dp] the rows' ranks
        hot = torch.nn.functional.one_hot(self.owner, self.n)
        self.pos = (hot.cumsum(0) - 1).gather(1, self.owner[:, None])[:, 0]
        self.counts = hot.sum(0).tolist()
        return self.local_of[sel[self.owner == self.me]]

    def _rows(self, key: torch.Tensor) -> torch.Tensor:
        """A per-DP-row key of every block, in the whole batch's row
        order."""
        m = max(self.counts)
        pad = torch.zeros(m, dtype=torch.int64, device=key.device)
        pad[: key.shape[0]] = key
        return _all_gather(pad, self.group, self.n)[self.owner, self.pos]

    def first(self, key, k: int):
        order = torch.argsort(self._rows(key), stable=True)[:k]
        mine = self.owner[order] == self.me
        self.slots = torch.arange(order.shape[0], device=key.device)[mine]
        return self.pos[order[mine]], self.slots

    def assemble(self, pb: PackedBatch) -> PackedBatch:
        """The whole batch's :class:`PackedBatch` from this rank's block
        ``pb`` (its strand rows, its traceback rows, which :meth:`first`
        numbered last) and the other blocks', on every rank; ``flat``
        ends in the sums of the blocks' seed counts and DP rows used and
        the OR of their fault words."""
        n, b = self.n, self.b

        def rows(x):                  # [n, 2b, ...] -> [fwd x B, rc x B]
            x = _all_gather(x, self.group, n)
            return torch.cat([x[:, :b].flatten(0, 1), x[:, b:].flatten(0, 1)])

        ints, clusters = rows(pb.ints), rows(pb.clusters)
        n_tb = self.slots.shape[0]
        m = int(_all_gather(torch.tensor([n_tb], device=pb.ops.device),
                            self.group, n).max())
        pad = pb.ops.new_zeros((m,) + pb.ops.shape[1:])
        pad[:n_tb] = pb.ops
        slots = torch.full((m,), -1, dtype=torch.int64, device=pb.ops.device)
        slots[:n_tb] = self.slots
        g_ops = _all_gather(pad, self.group, n).flatten(0, 1)
        g_slots = _all_gather(slots, self.group, n).reshape(-1)
        has = g_slots >= 0
        ops = g_ops.new_zeros((int(has.sum()),) + pb.ops.shape[1:])
        ops[g_slots[has]] = g_ops[has]
        tail = _all_gather(pb.flat[-TAIL_WORDS:], self.group, n)
        seeds = _sum_seed_words(tail[:, :-2])
        used = tail[:, -2].sum(dtype=pb.flat.dtype)
        fault = (tail[:, -1] != 0).any()
        flat = torch.cat([ints.reshape(-1), clusters.reshape(-1),
                          ops.reshape(-1), seeds, used[None],
                          fault.to(pb.flat.dtype)[None]])
        return PackedBatch(ints=ints, ops=ops, clusters=clusters, flat=flat)


def map_batch_data_parallel(mesh: Mesh, index: DeviceIndex, reads,
                            read_len, submat, gap_costs, **static):
    """Pure data parallelism: reads split over the 'data' axis, index
    replicated on the mesh's device.  Each rank runs map_batch's per-read
    stages (K5, K3, K7, K6, K4, K1, K2) on its contiguous block of the
    host batch (``B / n_data`` reads); map_batch's batch-level choices
    (the DP rows' order, the SDP pass's rows, the traceback rows) are
    made over the whole batch (:class:`WholeBatch`), as the JAX function,
    one program partitioned over the batch, makes them.  Returns the
    whole batch's :class:`PackedBatch` on every rank: one map_batch over
    the whole batch, array for array."""
    m, g, static = _call_args(mesh, submat, gap_costs, static)
    B = np.asarray(reads).shape[0]
    choices = WholeBatch(mesh, B // mesh.shape["data"], static["C"])
    pb = map_batch(index, _block(mesh, reads), _block(mesh, read_len), m,
                   g, choices=choices, **static)
    # every rank's DP rows, stored at the bucket's length
    return choices.assemble(pb)._replace(
        dp_rows=sum(choices.counts) * static["L"])


def shard_index(gi: GenomeIndex, n_shards: int, overlap: int = 65536,
                fast_path: bool = False):
    """Split the genome into n_shards contiguous slices (with right-overlap
    so alignments near boundaries are found by exactly one shard... the
    overlap region's anchors are indexed by the left shard only up to
    slice end; candidates crossing the cut are recovered by the overlap).

    Returns stacked per-shard arrays, padded to common sizes:
      genomes  int8  [S, Gs]
      keys     uint32[S, Ms]
      pos      int32 [S, Ms]  (positions are *shard-local* slice
               coordinates — int32-safe no matter the global genome size;
               globalization happens on the host via ``offsets``)
      offsets  int64 [S]      global start of each slice

    With ``fast_path=True`` additionally returns a dict of the anchor
    fast-path arrays (the same ones DeviceIndex.from_host builds for the
    replicated index): per-shard direct LUT ``bucket_starts``
    [S, 4^k+1], packed words ``gwords``/``gnwords`` [S, Gs+1], and fused
    gather records ``pos_records`` [S, Ms, 6] in the sentinel-shifted
    local coordinates per_shard uses.
    """
    from blasr_tpu_torch.index.genome import build_packed_words

    g = gi.genome
    n = len(g)
    base = -(-n // n_shards)
    assert base + overlap < 2 ** 31, (
        f"a single shard would span {base + overlap} bp >= 2^31; "
        f"raise n_shards (global coordinates stay int64-safe, but "
        f"shard-local coordinates are int32)")
    slices, offs = [], []
    for s in range(n_shards):
        lo = s * base
        hi = min(n, lo + base + overlap)
        lo_c = min(lo, n)
        slices.append(g[lo_c:hi])
        offs.append(lo_c)
    gs = max(len(x) for x in slices)
    genomes = np.full((n_shards, gs), 4, dtype=np.int8)
    keys_l, pos_l = [], []
    for s, sl in enumerate(slices):
        genomes[s, : len(sl)] = sl
        k, p = build_kmer_index(sl, gi.k)
        keys_l.append(k)
        pos_l.append(p.astype(np.int32))
    ms = max(len(k) for k in keys_l)
    keys = np.full((n_shards, ms), np.uint32(0xFFFFFFFF), dtype=np.uint32)
    pos = np.zeros((n_shards, ms), dtype=np.int32)
    for s in range(n_shards):
        keys[s, : len(keys_l[s])] = keys_l[s]
        pos[s, : len(pos_l[s])] = pos_l[s]
    offs = np.asarray(offs, dtype=np.int64)
    if not fast_path:
        return genomes, keys, pos, offs

    nb = 4 ** gi.k + 1
    bucket_starts = np.zeros((n_shards, nb), dtype=np.int32)
    gwords = np.zeros((n_shards, gs + 1), dtype=np.uint32)
    gnwords = np.zeros((n_shards, gs + 1), dtype=np.uint32)
    records = np.zeros((n_shards, ms, 6), dtype=np.uint32)
    allN = np.uint32(0xFFFFFFFF)
    for s, sl in enumerate(slices):
        # padding keys are 0xFFFFFFFF > any real k-mer key, so the
        # boundary search stays inside the valid prefix
        bucket_starts[s] = np.searchsorted(
            keys[s], np.arange(nb, dtype=np.int64)).astype(np.int32)
        gsent = np.concatenate([np.full(1, 4, dtype=sl.dtype), sl])
        gw, gn = build_packed_words(gsent)
        gwords[s, : len(gw)] = gw
        gnwords[s, : len(gn)] = gn
        gnwords[s, len(gn):] = allN
        # fused gather records in sentinel-shifted local coords
        # (DeviceIndex._build_records layout)
        t = pos_l[s].astype(np.int64) + 1
        G1 = len(gsent)
        m = len(t)
        records[s, :m, 0] = t.astype(np.uint32)
        records[s, :m, 1] = gsent[np.clip(t - 1, 0, G1 - 1)].astype(np.uint32)
        for j in range(2):
            off = gi.k + 16 * j
            gidx = np.clip(t + off, 0, G1 - 1)
            records[s, :m, 2 + 2 * j] = gwords[s][gidx]
            records[s, :m, 3 + 2 * j] = np.where(
                t + off < G1, gnwords[s][gidx], allN)
        records[s, m:, 3] = allN  # padded slots extend nowhere
        records[s, m:, 5] = allN
    fast = dict(bucket_starts=bucket_starts, gwords=gwords,
                gnwords=gnwords, pos_records=records)
    return genomes, keys, pos, offs, fast


def shard_device_index(gi: GenomeIndex, shards, s: int,
                       device) -> DeviceIndex:
    """Shard ``s`` of ``shard_index(gi, S, fast_path=True)`` as a
    :class:`DeviceIndex` on ``device``: the JAX ``per_shard`` index
    (``blasr_tpu/dist/mesh.py``) held as the port holds an index.

    * the sentinel N before the slice, and ``genome_pad`` (``with_pad``);
    * keys int64 holding the uint32 keys (padded slots 0xFFFFFFFF), the
      local positions + 1 as int64 (padded slots 1);
    * contig bounds clipped to the slice ``[0, Gs]`` in int64, then + 1;
    * the packed words as int64 32-bit patterns, the records as int32
      bit patterns with the port's ``RECORDS_PAD`` tail
      (``DeviceIndex._build_records``);
    * ``bucket_pairs`` derived from ``bucket_starts`` as ``from_host``
      does (the JAX shard index has none; both give K5 the same LUT)."""
    genomes, keys, pos, offs, fast = shards
    device = torch.device(device)
    gs = genomes.shape[1]

    def up(a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    starts = np.asarray(gi.seqdb.starts, np.int64)
    ends = starts + np.asarray(gi.seqdb.lengths, np.int64)
    recs = fast["pos_records"][s].view(np.int32)
    pad = np.zeros((DeviceIndex.RECORDS_PAD, 6), np.int32)
    pad[:, 2:] = -1                              # 0xFFFFFFFF: extends nowhere
    bs = up(fast["bucket_starts"][s])
    bp = None
    if bs.shape[0] <= (1 << 25):
        bp = torch.stack([bs[:-1], bs[1:]], dim=1).contiguous()
    return DeviceIndex(
        genome=up(np.concatenate([np.full(1, 4, np.int8), genomes[s]])),
        keys_sorted=up(keys[s].astype(np.int64)),
        pos_sorted=up(pos[s].astype(np.int64) + 1),
        contig_starts=up(np.clip(starts - offs[s], 0, gs) + 1),
        contig_ends=up(np.clip(ends - offs[s], 0, gs) + 1),
        k=gi.k, bucket_starts=bs, bucket_pairs=bp,
        gwords=up(fast["gwords"][s].astype(np.int64)),
        gnwords=up(fast["gnwords"][s].astype(np.int64)),
        pos_records=up(np.concatenate([recs, pad])),
    ).with_pad(DeviceIndex.GENOME_PAD)


def _sum_seed_words(words: torch.Tensor) -> torch.Tensor:
    """The int32 words of the seed counts' sums over the rows of
    ``words`` ([R, TAIL_WORDS - 2] int32, each row int64 counts
    as int32 pairs, as ``map_batch`` puts them in ``flat``)."""
    return words.contiguous().view(torch.int64).sum(dim=0).view(torch.int32)


def merge_ref_shards(ints: torch.Tensor, ops: torch.Tensor,
                     clusters: torch.Tensor, faults: torch.Tensor,
                     rows_used: torch.Tensor,
                     seed_words: torch.Tensor) -> PackedBatch:
    """The ref axis's merge of the R shards' outputs stacked on a leading
    axis (ints [R, 2B, C, N_COLS], ops [R, n_dp, P/2], clusters
    [R, 2B, C_stat, 2], faults [R], each shard's last word of ``flat``,
    rows_used [R], the word before it, and seed_words
    [R, TAIL_WORDS - 2], the seed counts' words before that):
    dp slots translated into rows of the concatenated ops, anchor and
    clip counts summed, the top C candidates per row by score (stable,
    invalid rows last), the heaviest gate-passing clusters of the union,
    the sums of the seed counts and of the DP rows used and the OR of the
    faults as the tail of ``flat``, so that a K1 fault in any shard
    raises in ``unpack_batch``."""
    R, n2, C, _ = ints.shape
    n_dp, t_len = ops.shape[1:]
    dev = ints.device
    i32 = torch.int32
    slot = ints[..., COL_DPSLOT]
    shard = torch.arange(R, dtype=i32, device=dev)[:, None, None]
    ints = ints.clone()
    ints[..., COL_DPSLOT] = torch.where(slot >= 0, slot + shard * n_dp, -1)
    nanch = ints[..., COL_NANCH].sum(dim=0, dtype=i32)
    nclip = ints[..., COL_NCLIP].sum(dim=0, dtype=i32)
    merged = ints.transpose(0, 1).reshape(n2, R * C, N_COLS)
    key = torch.where(merged[..., COL_VALID] > 0, merged[..., COL_SCORE],
                      BIG32)
    order = torch.argsort(key, dim=1, stable=True)[:, :C]
    top = merged.gather(1, order[..., None].expand(-1, -1, N_COLS))
    top[..., COL_NANCH] = nanch[:, :1]
    top[..., COL_NCLIP] = nclip[:, :1]
    # merge cluster lists: union over shards, keep the heaviest
    # gate-passing clusters (the ClusterList analog stays fixed-width)
    c_stat = clusters.shape[2]
    mcl = clusters.transpose(0, 1).reshape(n2, R * c_stat, 2)
    ckey = torch.where(mcl[..., 1] > 0, -mcl[..., 0], BIG32)
    corder = torch.argsort(ckey, dim=1, stable=True)[:, :c_stat]
    top_cl = mcl.gather(1, corder[..., None].expand(-1, -1, 2))
    ops = ops.reshape(R * n_dp, t_len)
    fault = (faults != 0).any().to(i32)
    used = rows_used.sum(dtype=i32)
    flat = torch.cat([top.reshape(-1), top_cl.reshape(-1), ops.reshape(-1),
                      _sum_seed_words(seed_words), used.reshape(1),
                      fault.reshape(1)])
    return PackedBatch(ints=top, ops=ops, clusters=top_cl, flat=flat)


def _all_gather(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """``x`` of every rank of ``group`` (``n`` ranks), stacked in rank
    order."""
    x = x.contiguous()
    out: List[torch.Tensor] = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(out, x, group=group)
    return torch.stack(out)


def map_batch_ref_sharded(
    mesh: Mesh,
    gi: GenomeIndex,
    reads,
    read_len,
    submat, gap_costs,
    **static,
):
    """Reference-sharded mapping over mesh axes (data, ref).

    Each rank runs the whole pipeline for its data block of the reads
    against its genome shard; the shards' outputs are all-gathered over
    the ref group and the global top candidates selected per read
    (:func:`merge_ref_shards`).  Returns (this rank's merged
    :class:`PackedBatch`, the int64 shard offsets, ``n_dp``: the ops rows
    per shard, the stride of the translated dp slots), the JAX function's
    triple for the rank's data block; :func:`globalize_sharded` makes the
    coordinates global.  ``map_batch`` runs eagerly: the shard index is
    built anew on every call, as the JAX function builds it, so a CUDA
    graph of it would never replay.
    """
    n_ref = mesh.shape["ref"]
    shards = shard_index(gi, n_ref, fast_path=True)
    offs = shards[3]
    m, g, static = _call_args(mesh, submat, gap_costs, static)
    idx = shard_device_index(gi, shards, mesh.ref,
                             mesh.device).with_pad(static["W"])
    res = map_batch(idx, _block(mesh, reads), _block(mesh, read_len), m, g,
                    **static)
    stacked = [_all_gather(x, mesh.ref_group, n_ref)
               for x in (res.ints, res.ops, res.clusters, res.flat[-1:],
                         res.flat[-2:-1], res.flat[-TAIL_WORDS:-2])]
    merged = merge_ref_shards(*stacked)._replace(
        dp_rows=res.dp_rows * n_ref)
    return merged, offs, int(res.ops.shape[0])


def globalize_sharded(result, offs: np.ndarray, n_dp: int):
    """Host-side coordinate globalization for map_batch_ref_sharded
    results: per-shard local t coordinates + the producing shard's int64
    offset (shard = dp_slot // n_dp — every collected candidate has a
    traceback slot; slotless ones are dropped at collection, as on the
    replicated path).  Returns int64 (t_start, t_end) arrays — exact past
    the reference's 4 Gbp / int32 limit (utils/SAWriter.cpp:186-193)."""
    slot = result.dp_slot
    shard = np.where(slot >= 0, slot // max(n_dp, 1), 0)
    off = np.asarray(offs, np.int64)[shard]
    ts = result.t_start.astype(np.int64) + np.where(slot >= 0, off, 0)
    te = result.t_end.astype(np.int64) + np.where(slot >= 0, off, 0)
    return ts, te

"""Batched anchor search (port of ``blasr_tpu/kernels/anchor.py``).

``find_anchors`` dispatches on the device of its inputs: CUDA tensors go
to K5 (``csrc/anchor_search.cu``, one call of two kernels), CPU tensors
to ``find_anchors_plain``.

``find_anchors_plain`` is plain PyTorch on the JAX ``find_anchors``: the
paired LUT rows (or the LUT / a sorted-key search), strided rotating
occurrence sampling or, with ``occ_block_sample``, a contiguous window of
O occurrences whose base rotates with the read position, the fused
24-byte per-slot records (or separate word gathers), the containment
prune, the 16-base XOR extension, top-A selection and the final
genome-position order.  The ``profile_stop`` hooks are not ported.

The JAX package holds k-mer keys and packed genome words as uint32.  Here
they are int64 holding the same 32-bit patterns (masked with 0xFFFFFFFF
after every shift and complement); the records table stays int32 bit
patterns on the device (24 bytes per slot) and widens after its gather.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from blasr_tpu_torch.kernels.dispatch import on_device, per_distinct_row
from blasr_tpu_torch.kernels.xla_math import fma_f32, log_f32

BIG = 0x3FFFFFFF
MASK32 = 0xFFFFFFFF


class Anchors(NamedTuple):
    """Fixed-capacity anchor set per read (sorted by t, invalid at end)."""

    q: torch.Tensor        # int64 [B, A] read position
    t: torch.Tensor        # int64 [B, A] genome position
    l: torch.Tensor        # int64 [B, A] exact-match length
    valid: torch.Tensor    # bool  [B, A]
    n_total: torch.Tensor  # int32 [B] anchors found before capacity cap
    nlogp: torch.Tensor    # float32 [B, A] -log P(anchor by chance)
    hits_t: Optional[torch.Tensor] = None      # int64 [B, L, O]
    hits_valid: Optional[torch.Tensor] = None  # bool [B, L, O]
    n_clipped: Optional[torch.Tensor] = None   # int32 [B]
    # int64 [B, 5]: the row's valid k-mers, the sum of their occurrences,
    # those with more than O, the sum of min(occurrences, O), the anchors
    # kept (the valid ones of the A selected)
    seed_counts: Optional[torch.Tensor] = None


def _shift_left(x: torch.Tensor, j: int, fill) -> torch.Tensor:
    """out[:, i] = x[:, i + j], fill past the end (j may exceed the width)."""
    B, L = x.shape
    if j == 0:
        return x
    pad = torch.full((B, min(j, L)), fill, dtype=x.dtype, device=x.device)
    return torch.cat([x[:, j:], pad], dim=1)[:, :L]


def read_kmer_keys(reads: torch.Tensor, read_len: torch.Tensor, k: int):
    """(keys [B, L] int64 holding uint32, valid [B, L]) k-mer starting at
    every position."""
    B, L = reads.shape
    r = reads.to(torch.int64)
    keys = torch.zeros((B, L), dtype=torch.int64, device=reads.device)
    ok = torch.ones((B, L), dtype=torch.bool, device=reads.device)
    for j in range(k):
        shifted = _shift_left(r, j, 4)
        keys = ((keys << 2) & MASK32) | (shifted & 3)
        ok &= shifted < 4
    pos = torch.arange(L, device=reads.device)
    ok &= pos[None, :] + k <= read_len.to(torch.int64)[:, None]
    return keys, ok


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Bit count of int64 values holding 32-bit patterns."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & MASK32) >> 24


def _bit_reverse_spread(n: int):
    """(bit-reversed 0..n-1 as int64, bit count): the top-A tie-break."""
    nbits = max(1, (n - 1).bit_length())
    iota = np.arange(n, dtype=np.uint32)
    rev = np.zeros_like(iota)
    for b in range(nbits):
        rev |= ((iota >> b) & 1) << (nbits - 1 - b)
    return rev.astype(np.int64), nbits


def find_anchors(genome, keys_sorted, pos_sorted, reads, read_len, *,
                 k: int, occ_per_pos: int, max_anchors: int, anchor_ext: int,
                 min_match: int, max_anchors_per_pos: int, max_lcp: int = 0,
                 advance_exact: int = 0, occ_block_sample: bool = False,
                 bucket_starts=None, bucket_pairs=None, gwords=None,
                 gnwords=None, pos_records=None) -> Anchors:
    """The anchor search: K5 on CUDA tensors, the plain version on CPU
    tensors (same contract as :func:`find_anchors_plain`)."""
    kw = dict(k=k, occ_per_pos=occ_per_pos, max_anchors=max_anchors,
              anchor_ext=anchor_ext, min_match=min_match,
              max_anchors_per_pos=max_anchors_per_pos, max_lcp=max_lcp,
              advance_exact=advance_exact,
              occ_block_sample=occ_block_sample, bucket_starts=bucket_starts,
              bucket_pairs=bucket_pairs, gwords=gwords, gnwords=gnwords,
              pos_records=pos_records)
    return on_device(
        "find_anchors", reads.device,
        lambda: find_anchors_plain(genome, keys_sorted, pos_sorted, reads,
                                   read_len, **kw),
        lambda ops: ops.anchor_search_launch(
            genome, keys_sorted, pos_sorted, reads.contiguous(),
            # the mapper's read lengths are int32 already: no call
            read_len if read_len.dtype == torch.int32
            and read_len.is_contiguous()
            else read_len.to(torch.int32).contiguous(), **kw))


def find_anchors_plain(genome, keys_sorted, pos_sorted, reads, read_len, *,
                       k: int, occ_per_pos: int, max_anchors: int,
                       anchor_ext: int, min_match: int,
                       max_anchors_per_pos: int, max_lcp: int = 0,
                       advance_exact: int = 0, occ_block_sample: bool = False,
                       bucket_starts=None, bucket_pairs=None, gwords=None,
                       gnwords=None, pos_records=None) -> Anchors:
    """See ``blasr_tpu.kernels.anchor.find_anchors``: anchor significance
    is -log P = log(M/n) + (l-k)*log(4) for a seed occurring n times in an
    M-slot index and extending to length l.  ``occ_block_sample`` samples
    an over-abundant seed's occurrences as O consecutive slots from a base
    lo + (q * 97) % (nocc - O + 1) instead of the strided picket.  A
    read's anchors depend on its own bases only, so the search runs once
    per distinct read row (``per_distinct_row``)."""
    if gwords is None:
        raise NotImplementedError(
            "find_anchors needs the packed genome words (DeviceIndex)")
    kw = dict(k=k, occ_per_pos=occ_per_pos, max_anchors=max_anchors,
              anchor_ext=anchor_ext, min_match=min_match,
              max_anchors_per_pos=max_anchors_per_pos, max_lcp=max_lcp,
              advance_exact=advance_exact,
              occ_block_sample=occ_block_sample, bucket_starts=bucket_starts,
              bucket_pairs=bucket_pairs, gwords=gwords, gnwords=gnwords,
              pos_records=pos_records)
    return per_distinct_row(
        lambda reads, read_len: _anchor_rows(genome, keys_sorted, pos_sorted,
                                             reads, read_len, **kw),
        reads, read_len)


def _anchor_rows(genome, keys_sorted, pos_sorted, reads, read_len, *, k,
                 occ_per_pos, max_anchors, anchor_ext, min_match,
                 max_anchors_per_pos, max_lcp, advance_exact,
                 occ_block_sample, bucket_starts, bucket_pairs, gwords,
                 gnwords, pos_records) -> Anchors:
    dev = reads.device
    i64 = torch.int64
    B, L = reads.shape
    G = genome.shape[0]
    O = occ_per_pos
    M_slots = pos_sorted.shape[0]

    keys, kvalid = read_kmer_keys(reads, read_len, k)
    flatk = keys.reshape(-1)
    if bucket_pairs is not None:
        pair = bucket_pairs[flatk].to(i64)                      # [B*L, 2]
        lo = pair[:, 0].reshape(B, L)
        hi = pair[:, 1].reshape(B, L)
    elif bucket_starts is not None:
        lo = bucket_starts[flatk].to(i64).reshape(B, L)
        hi = bucket_starts[flatk + 1].to(i64).reshape(B, L)
    else:
        lo = torch.searchsorted(keys_sorted, flatk, side="left").reshape(B, L)
        hi = torch.searchsorted(keys_sorted, flatk,
                                side="right").reshape(B, L)
    nocc = hi - lo
    pos_ok = kvalid & (nocc > 0) & (nocc <= max_anchors_per_pos)

    occ3 = torch.arange(O, dtype=i64, device=dev)[None, None, :]
    nocc3 = nocc[:, :, None]
    q = torch.arange(L, dtype=i64, device=dev)[None, :, None].expand(B, L, O)
    use_rec = pos_records is not None and anchor_ext <= 32
    if occ_block_sample:
        # a contiguous window of O slots from a base rotating with q inside
        # [lo, hi - O]; (q * 97) wraps as the JAX package's int32 does
        q2 = torch.arange(L, dtype=i64, device=dev)[None, :]
        span = torch.clamp(nocc - O + 1, min=1)
        q97 = (q2 * 97).to(torch.int32).to(i64)
        base = lo + torch.where(nocc > O, q97 % span, 0)
        idx = (base[:, :, None] + occ3).clamp(0, M_slots - 1)
        # the records come as one O-row slice from base, its start clipped
        # to the table's rows (RECORDS_PAD included), not slot by slot
        rec_rows = (None if not use_rec else
                    base.clamp(0, pos_records.shape[0] - O)[:, :, None]
                    + occ3)
    else:
        # strided occurrence sampling with a phase rotating with q
        stride0 = occ3 * (nocc3 // O) + (occ3 * (nocc3 % O)) // O
        strided = (stride0 + q) % torch.clamp(nocc3, min=1)
        occ_off = torch.where(nocc3 > O, strided, occ3)
        idx = (lo[:, :, None] + occ_off).clamp(0, M_slots - 1)  # [B, L, O]
        rec_rows = idx
    cand_valid = pos_ok[:, :, None] & (occ3 < nocc3)
    if use_rec:
        rec = pos_records[rec_rows].to(i64) & MASK32            # [B,L,O,6]
        t = rec[..., 0]
        gprev = rec[..., 1]
    else:
        rec = None
        t = pos_sorted[idx].to(i64)
        gprev = genome[(t - 1).clamp(0, G - 1)].to(i64)

    # containment prune (RemoveOverlappingAnchors) with periodic
    # representatives every E/2 positions
    rprev = torch.cat([torch.full((B, 1), 4, dtype=i64, device=dev),
                       reads[:, :-1].to(i64)], dim=1)[:, :, None]
    keep_stride = max(anchor_ext // 2, 1)
    periodic = q % keep_stride == 0
    contained = ((q > 0) & (t > 0) & (gprev == rprev) & (rprev < 4)
                 & ~periodic)
    cand_valid = cand_valid & ~contained

    # forward extension, 16 bases per XOR + count-trailing-zeros
    E = anchor_ext
    r64 = reads.to(i64)
    rw = torch.zeros((B, L), dtype=i64, device=dev)
    rn = torch.zeros((B, L), dtype=i64, device=dev)
    for j16 in range(16):
        shifted = _shift_left(r64, j16, 4)
        rw = rw | ((shifted & 3) << (2 * j16))
        rn = rn | (torch.where(shifted >= 4, 3, 0) << (2 * j16))
    n_words = -(-E // 16)
    ext = torch.zeros((B, L, O), dtype=i64, device=dev)
    full_prev = torch.ones((B, L, O), dtype=i64, device=dev)
    for j in range(n_words):
        off = k + 16 * j
        if use_rec:
            gw_j = rec[..., 2 + 2 * j]
            gn_j = rec[..., 3 + 2 * j]
        else:
            gidx = (t + off).clamp(0, G - 1)
            gw_j = gwords[gidx]
            gn_j = torch.where(t + off < G, gnwords[gidx], MASK32)
        rw_sh = _shift_left(rw, off, 0)
        rn_sh = _shift_left(rn, off, MASK32)
        diff = (gw_j ^ rw_sh[:, :, None]) | gn_j | rn_sh[:, :, None]
        lsb = diff & ((~diff + 1) & MASK32)
        tz = _popcount32((lsb - 1) & MASK32)
        mlen = tz >> 1
        ext = ext + mlen * full_prev
        full_prev = full_prev * (mlen == 16).to(i64)
    length = k + torch.clamp(ext, max=E)
    if max_lcp > 0:
        length = torch.clamp(length, max=max_lcp)
    cand_valid = cand_valid & (length >= min_match)

    if advance_exact > 0:
        maxlen = torch.where(cand_valid, length, 0).amax(dim=2)     # [B, L]
        pos2 = torch.arange(L, dtype=i64, device=dev)[None, :]
        reach = torch.where(maxlen > 0, pos2 + maxlen - advance_exact, -1)
        reach_prev = torch.cat(
            [torch.full((B, 1), -1, dtype=i64, device=dev),
             torch.cummax(reach, dim=1).values[:, :-1]], dim=1)
        cand_valid = cand_valid & (pos2 >= reach_prev)[:, :, None]

    # anchor significance in nats: XLA's log and its fused multiply-add
    LOG4 = 1.3862944
    m_total = torch.tensor(float(M_slots), dtype=torch.float32, device=dev)
    seed_nlogp = log_f32(m_total / torch.clamp(nocc, min=1).to(torch.float32))
    nlogp = fma_f32((length - k).to(torch.float32), LOG4,
                    seed_nlogp[:, :, None])

    # top-A: valid first, longer first, bit-reversed position tie-break
    flat_valid = cand_valid.reshape(B, L * O)
    flat_len = length.reshape(B, L * O)
    flat_q = q.reshape(B, L * O)
    flat_t = t.reshape(B, L * O)
    flat_p = nlogp.reshape(B, L * O)
    rev, nbits = _bit_reverse_spread(L * O)
    spread = torch.from_numpy(rev).to(dev)[None, :]
    rank = torch.where(flat_valid, (-flat_len << nbits) + spread, BIG)
    order = torch.argsort(rank, dim=1, stable=True)[:, :max_anchors]
    sel_q = flat_q.gather(1, order)
    sel_t = flat_t.gather(1, order)
    sel_l = flat_len.gather(1, order)
    sel_v = flat_valid.gather(1, order)
    sel_p = flat_p.gather(1, order)
    n_total = flat_valid.sum(dim=1).to(torch.int32)
    seed_counts = torch.stack([
        kvalid.sum(dim=1), torch.where(kvalid, nocc, 0).sum(dim=1),
        (kvalid & (nocc > O)).sum(dim=1),
        torch.where(kvalid, torch.clamp(nocc, max=O), 0).sum(dim=1),
        sel_v.sum(dim=1)], dim=1).to(i64)
    n_clipped = torch.where(pos_ok, torch.clamp(nocc - O, min=0),
                            0).sum(dim=1).to(torch.int32)

    # final order: by genome position, invalid pushed to the end
    tkey = torch.where(sel_v, sel_t, BIG)
    order2 = torch.argsort(tkey, dim=1, stable=True)
    return Anchors(
        q=sel_q.gather(1, order2), t=sel_t.gather(1, order2),
        l=sel_l.gather(1, order2), valid=sel_v.gather(1, order2),
        n_total=n_total, n_clipped=n_clipped, seed_counts=seed_counts,
        nlogp=sel_p.gather(1, order2),
        hits_t=t,
        hits_valid=pos_ok[:, :, None] & (occ3 < nocc3)
        & (length >= min_match),
    )

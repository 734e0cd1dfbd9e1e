# Copied from blasr_tpu/index/genome.py; only the imports differ (blasr_tpu -> blasr_tpu_torch).
"""Genome index: concatenated packed genome + seqdb + sorted k-mer anchor index.

TPU-first redesign of the reference's index stack:

  * reference: 3-bit genome + Larsson-Sadakane suffix array + 8-mer prefix
    lookup table + TupleCountTable (Blasr.cpp:1082-1147).
  * here: int8 genome codes + a *sorted fixed-k k-mer table*
    (keys_sorted, pos_sorted) giving every anchor-seed hit via one
    vectorized ``searchsorted`` — the device-friendly equivalent of
    "lookup-table jump + SA binary search" (MapBySuffixArray usage at
    iblasr/BlasrAlignImpl.hpp:34-58).  Maximal-match extension beyond k is
    done by direct genome comparison in the anchor kernel.
  * TupleCountTable equivalent: k-mer occurrence counts for the
    tuple-frequency P-value weightor, derivable from the same sorted table.

Contigs are concatenated with a single N separator; any k-window crossing a
boundary contains the N and is excluded from the index, and alignment
windows are clamped to contig bounds via the seqdb
(cf. BlasrAlignImpl.hpp:660-698).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from blasr_tpu_torch.io.fasta import FastaRecord, md5_of_seq
from blasr_tpu_torch.index.suffix_array import kmer_keys

SPACER = 1  # N bases between concatenated contigs


@dataclass
class SeqDB:
    """Contig name/offset table over the concatenated genome
    (reference SequenceIndexDatabase, Blasr.cpp:1001-1013)."""

    names: List[str]
    starts: np.ndarray   # int64 [n_contigs] offset in concatenated genome
    lengths: np.ndarray  # int64 [n_contigs]
    md5s: List[str]

    @property
    def n_contigs(self) -> int:
        return len(self.names)

    def search_for_index(self, gpos: int) -> int:
        """Contig index containing concatenated-genome position gpos."""
        i = int(np.searchsorted(self.starts, gpos, side="right") - 1)
        return max(0, min(i, self.n_contigs - 1))

    def genome_to_chrom(self, gpos: int):
        i = self.search_for_index(gpos)
        return i, int(gpos - self.starts[i])

    def chrom_to_genome(self, contig: int, pos: int) -> int:
        return int(self.starts[contig] + pos)

    def contig_bounds(self, contig: int):
        s = int(self.starts[contig])
        return s, s + int(self.lengths[contig])


@dataclass
class GenomeIndex:
    genome: np.ndarray        # int8 [G] codes, contigs + N spacers
    seqdb: SeqDB
    k: int                    # seed length of the sorted k-mer table
    keys_sorted: np.ndarray   # uint32/uint64 [M] sorted k-mer keys
    pos_sorted: np.ndarray    # int32/int64 [M] genome positions, key-sorted
    ctab_k: int               # tuple-count table k (reference default 8)
    ctab: np.ndarray          # int32 [4^ctab_k] genome k-mer counts
    suffix_array: Optional[np.ndarray] = None  # full SA (tools / --sa parity)
    bucket_starts: Optional[np.ndarray] = None  # int32 [4^k+1] direct lookup
    # True when keys_sorted/pos_sorted contain synthetic rows that are NOT
    # genome k-mer windows (zmw._pad_mini_index sentinel pads): disables
    # DeviceIndex.from_host's derive-on-device path, which reconstructs the
    # k-mer table by gathering from the genome
    synthetic_kmer_rows: bool = False

    @property
    def glen(self) -> int:
        return len(self.genome)

    def save(self, path: str) -> None:
        np.savez_compressed(
            path,
            version=np.int32(1),
            genome=self.genome,
            seq_starts=self.seqdb.starts,
            seq_lengths=self.seqdb.lengths,
            seq_names=np.array(self.seqdb.names),
            seq_md5s=np.array(self.seqdb.md5s),
            k=np.int32(self.k),
            keys_sorted=self.keys_sorted,
            pos_sorted=self.pos_sorted,
            ctab_k=np.int32(self.ctab_k),
            ctab=self.ctab,
            suffix_array=(self.suffix_array
                          if self.suffix_array is not None
                          else np.zeros(0, dtype=np.int32)),
            bucket_starts=(self.bucket_starts
                           if self.bucket_starts is not None
                           else np.zeros(0, dtype=np.int32)),
        )

    @staticmethod
    def load(path: str) -> "GenomeIndex":
        z = np.load(path, allow_pickle=False)
        sa = z["suffix_array"]
        bs = z["bucket_starts"] if "bucket_starts" in z.files else np.zeros(0)
        return GenomeIndex(
            genome=z["genome"],
            seqdb=SeqDB(
                names=[str(x) for x in z["seq_names"]],
                starts=z["seq_starts"],
                lengths=z["seq_lengths"],
                md5s=[str(x) for x in z["seq_md5s"]],
            ),
            k=int(z["k"]),
            keys_sorted=z["keys_sorted"],
            pos_sorted=z["pos_sorted"],
            ctab_k=int(z["ctab_k"]),
            ctab=z["ctab"],
            suffix_array=sa if len(sa) else None,
            bucket_starts=bs if len(bs) else None,
        )


def concat_contigs(contigs: Sequence[FastaRecord]):
    parts = []
    names, starts, lengths, md5s = [], [], [], []
    off = 0
    spacer = np.full(SPACER, 4, dtype=np.int8)
    for i, c in enumerate(contigs):
        if i > 0:
            parts.append(spacer)
            off += SPACER
        names.append(c.name)
        starts.append(off)
        lengths.append(len(c.seq))
        md5s.append(md5_of_seq(c.seq))
        parts.append(np.asarray(c.seq, dtype=np.int8))
        off += len(c.seq)
    genome = np.concatenate(parts) if parts else np.zeros(0, dtype=np.int8)
    seqdb = SeqDB(names, np.array(starts, dtype=np.int64),
                  np.array(lengths, dtype=np.int64), md5s)
    return genome, seqdb


def build_kmer_index(genome: np.ndarray, k: int):
    """Sorted (key, pos) table over all valid k-windows of the genome."""
    keys, valid = kmer_keys(genome, k)
    pos = np.nonzero(valid)[0]
    kv = keys[pos]
    if k <= 16 and len(genome) < 2**31:
        # pack (key, pos) into one uint64 and radix-sort it: one sort
        # pass replaces argsort + two 50M-element gathers, and the
        # (key, pos) lexicographic order IS the stable order
        packed = kv.astype(np.uint64)
        packed <<= np.uint64(32)
        np.bitwise_or(packed, pos.astype(np.uint32), out=packed)
        packed.sort(kind="stable")
        pos_sorted = (packed & np.uint64(0xFFFFFFFF)).astype(np.int32)
        keys_sorted = (packed >> np.uint64(32)).astype(np.uint32)
        return keys_sorted, pos_sorted
    order = np.argsort(kv, kind="stable")
    pos_sorted = pos[order]
    keys_sorted = kv[order]
    if k <= 16:
        keys_sorted = keys_sorted.astype(np.uint32)
    if len(genome) < 2**31:
        pos_sorted = pos_sorted.astype(np.int32)
    return keys_sorted, pos_sorted


def build_bucket_starts(keys_sorted: np.ndarray, k: int) -> np.ndarray:
    """Direct lookup table: bucket_starts[key] .. bucket_starts[key+1) is
    the pos_sorted range whose k-mer equals key.  The device-native form of
    the reference's SA prefix lookup table (BuildLookupTable,
    Blasr.cpp:1101), sized 4^k+1 (k=14 is 1 GiB int32 — affordable
    on 16 GB HBM and much faster than searchsorted for large genomes).
    Replaces the whole binary search with two gathers."""
    nb = 1 << (2 * k)
    m = len(keys_sorted)
    dt = np.int32 if m < 2**31 else np.int64
    table = np.zeros(nb + 1, dtype=dt)
    if m:
        # keys_sorted is sorted: scatter each key run's length at key+1
        # and prefix-sum in place — avoids bincount's int64 [4^k] array
        # and a second [4^k] cumsum allocation (k=14: 2 GiB saved)
        bnd = np.flatnonzero(keys_sorted[1:] != keys_sorted[:-1]) + 1
        run_starts = np.concatenate([[0], bnd])
        run_ends = np.concatenate([bnd, [m]])
        uk = keys_sorted[run_starts].astype(np.int64)
        table[uk + 1] = (run_ends - run_starts).astype(dt)
        np.cumsum(table, out=table)
    return table


def build_packed_words(genome: np.ndarray):
    """(gwords, gnwords) uint32 [G]: gwords[t] packs codes of
    genome[t..t+15] LSB-first (2 bits/base); gnwords has 11 in the bit
    pair of every non-ACGT base (or past-the-end position).  Used by the
    anchor kernel to extend seed matches 16 bases per XOR+ctz instead of
    byte-at-a-time gathers."""
    g = np.asarray(genome)
    n = len(g)
    gw = np.zeros(n, dtype=np.uint32)
    gn = np.zeros(n, dtype=np.uint32)
    for j in range(16):
        shifted = np.full(n, 4, dtype=np.uint8)
        shifted[: n - j] = g[j:]
        gw |= (shifted & 3).astype(np.uint32) << np.uint32(2 * j)
        gn |= np.where(shifted >= 4, np.uint32(3),
                       np.uint32(0)) << np.uint32(2 * j)
    return gw, gn


def build_ctab(genome: np.ndarray, ctab_k: int = 8) -> np.ndarray:
    """Genome k-mer frequency table (reference TupleCountTable,
    Blasr.cpp:1136-1147; default k=8) for anchor P-value weighting."""
    keys, valid = kmer_keys(genome, ctab_k)
    return np.bincount(keys[valid],
                       minlength=4 ** ctab_k).astype(np.int32)


def build_genome_index(
    contigs: Sequence[FastaRecord],
    k: int = 12,
    ctab_k: int = 8,
    with_suffix_array: bool = False,
) -> GenomeIndex:
    genome, seqdb = concat_contigs(contigs)
    keys_sorted, pos_sorted = build_kmer_index(genome, k)
    ctab = build_ctab(genome, ctab_k)
    sa = None
    if with_suffix_array:
        from blasr_tpu_torch.index.suffix_array import build_suffix_array
        sa = build_suffix_array(genome)
    bs = build_bucket_starts(keys_sorted, k) if k <= 14 else None
    return GenomeIndex(genome, seqdb, k, keys_sorted, pos_sorted, ctab_k,
                       ctab, sa, bs)

# Copied from blasr_tpu/sim.py; only the imports differ (blasr_tpu -> blasr_tpu_torch).
"""Synthetic genome / PacBio-like read simulation.

The reference's cram tests run on PacBio-internal NFS data
(ctest/setup.sh DATDIR) which is unavailable here, so correctness and
benchmarks are established on simulated data with known ground truth:
random genomes and reads sampled with CLR-like error profiles
(~85% accuracy: insertions > deletions > substitutions, matching the
priors encoded at iblasr/MappingParameters.h readAccuracyPrior=0.85,
insertion=4 < deletion=5 asymmetry).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from blasr_tpu_torch.io.fasta import FastaRecord, revcomp


def random_genome(length: int, seed: int = 0, n_contigs: int = 1,
                  names: Optional[List[str]] = None) -> List[FastaRecord]:
    rng = np.random.default_rng(seed)
    sizes = [length // n_contigs] * n_contigs
    sizes[-1] += length - sum(sizes)
    out = []
    for i, n in enumerate(sizes):
        name = names[i] if names else f"contig{i}"
        out.append(FastaRecord(name, rng.integers(0, 4, n, dtype=np.int8)))
    return out


@dataclass
class GenomeFeature:
    """A planted repeat/structure annotation (structured_genome)."""

    kind: str    # "tandem" | "segdup" | "nrun"
    start: int   # [start, end) on the (single) contig
    end: int
    partner_start: int = -1   # segdup: start of the duplicated source
    partner_end: int = -1
    period: int = 0           # tandem: monomer length
    identity: float = 1.0     # per-copy identity vs the monomer/source


def _hp_run_lengths(seq: np.ndarray) -> np.ndarray:
    """Length of the homopolymer run each position belongs to."""
    n = len(seq)
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    new = np.empty(n, dtype=bool)
    new[0] = True
    new[1:] = seq[1:] != seq[:-1]
    rid = np.cumsum(new) - 1
    counts = np.bincount(rid)
    return counts[rid]


def _mutate_frac(seq: np.ndarray, rng: np.random.Generator,
                 divergence: float) -> np.ndarray:
    """Substitution-only divergence (repeat copies drift mostly by subs)."""
    out = seq.copy()
    m = rng.random(len(seq)) < divergence
    out[m] = (out[m] + rng.integers(1, 4, int(m.sum()))) % 4
    return out


def structured_genome(length: int, seed: int = 0, *,
                      n_tandem: int = 0, tandem_period: int = 171,
                      tandem_copies: Tuple[int, int] = (60, 300),
                      tandem_divergence: float = 0.015,
                      n_segdup: int = 0,
                      segdup_len: Tuple[int, int] = (5_000, 50_000),
                      segdup_identity: Tuple[float, float] = (0.95, 0.995),
                      n_nrun: int = 0,
                      nrun_len: Tuple[int, int] = (100, 5_000),
                      n_str: int = 0,
                      str_period: Tuple[int, int] = (2, 6),
                      str_len: Tuple[int, int] = (200, 2_000),
                      str_divergence: float = 0.01,
                      name: str = "chrS",
                      ) -> Tuple[List[FastaRecord], List[GenomeFeature]]:
    """Random genome with planted repeat structure (the validation the
    pure-random soak cannot provide: alpha-satellite-like tandem arrays,
    segmental duplications at 95-99.5% identity, N runs — the
    ctest/bug25328.t repetitive-genome test class).

    Returns a single contig plus the planted feature annotations."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, length, dtype=np.int8)
    features: List[GenomeFeature] = []
    taken: List[Tuple[int, int]] = []

    def claim(size: int, margin: int = 2_000) -> int:
        for _ in range(200):
            s = int(rng.integers(margin, max(length - size - margin, margin + 1)))
            if all(e0 + margin < s or s + size + margin < s0
                   for s0, e0 in taken):
                taken.append((s, s + size))
                return s
        return -1

    for _ in range(n_tandem):
        copies = int(rng.integers(*tandem_copies))
        size = copies * tandem_period
        s = claim(size)
        if s < 0:
            continue
        monomer = rng.integers(0, 4, tandem_period, dtype=np.int8)
        for c in range(copies):
            g[s + c * tandem_period:s + (c + 1) * tandem_period] = \
                _mutate_frac(monomer, rng, tandem_divergence)
        features.append(GenomeFeature(
            "tandem", s, s + size, period=tandem_period,
            identity=1.0 - tandem_divergence))

    for _ in range(n_segdup):
        size = int(rng.integers(*segdup_len))
        src = claim(size)
        dst = claim(size)
        if src < 0 or dst < 0:
            continue
        ident = float(rng.uniform(*segdup_identity))
        g[dst:dst + size] = _mutate_frac(g[src:src + size], rng,
                                         1.0 - ident)
        features.append(GenomeFeature(
            "segdup", dst, dst + size, partner_start=src,
            partner_end=src + size, identity=ident))

    for _ in range(n_nrun):
        size = int(rng.integers(*nrun_len))
        s = claim(size)
        if s < 0:
            continue
        g[s:s + size] = 4
        features.append(GenomeFeature("nrun", s, s + size))

    for _ in range(n_str):
        # short-period microsatellite (2-6 bp unit): the classic banded-DP
        # / chain-drift stressor, distinct from the 171 bp tandem monomers
        period = int(rng.integers(str_period[0], str_period[1] + 1))
        size = int(rng.integers(*str_len))
        size -= size % period
        s = claim(size, margin=500)
        if s < 0:
            continue
        monomer = rng.integers(0, 4, period, dtype=np.int8)
        arr = np.tile(monomer, size // period)
        g[s:s + size] = _mutate_frac(arr, rng, str_divergence)
        features.append(GenomeFeature(
            "str", s, s + size, period=period,
            identity=1.0 - str_divergence))

    return [FastaRecord(name, g)], features


@dataclass
class SimRead:
    rec: FastaRecord
    contig: int
    tstart: int     # true forward-genome interval
    tend: int
    strand: int


def mutate(seq: np.ndarray, rng: np.random.Generator,
           sub: float, ins: float, dele: float,
           hp_ins_mult: float = 1.0) -> np.ndarray:
    """Apply per-base substitution/insertion/deletion errors.

    ``hp_ins_mult > 1`` switches to the homopolymer-biased insertion
    model (the dominant real PacBio CLR error mode — the reason the
    reference carries a dedicated hp-insertion band,
    BlasrAlignImpl.hpp:1262-1266, and IDS QV steering): positions inside
    homopolymer runs (length >= 3) carry ``hp_ins_mult``x the insertion
    probability of other positions, renormalized so the EXPECTED total
    insertion count still equals ``ins * len(seq)``; 90% of hp-run
    insertions duplicate the run base (true hp-length error) rather
    than inserting a random base.  ``hp_ins_mult == 1.0`` is
    bit-identical to the historical iid model (same RNG draw order) —
    golden worlds depend on that."""
    out = []
    n = len(seq)
    r = rng.random(n)
    subs = rng.integers(1, 4, n)
    if hp_ins_mult != 1.0:
        rl = _hp_run_lengths(seq)
        hp = rl >= 3
        w = np.where(hp, hp_ins_mult, 1.0)
        denom = float(w.sum())
        p_ins = np.minimum(ins * n * w / denom, 0.75) if denom else w
        ins_mask = rng.random(n) < p_ins
        dup = rng.random(n) < 0.9
        ins_base = np.where(hp & dup, seq,
                            rng.integers(0, 4, n)).astype(np.int8)
    else:
        ins_mask = rng.random(n) < ins
        ins_base = rng.integers(0, 4, n, dtype=np.int8)
    for i in range(n):
        x = seq[i]
        if r[i] < dele:
            pass  # deleted
        elif r[i] < dele + sub:
            out.append(np.int8((x + subs[i]) % 4))
        else:
            out.append(np.int8(x))
        if ins_mask[i]:
            out.append(ins_base[i])
    return np.array(out, dtype=np.int8) if out else np.zeros(0, dtype=np.int8)


def simulate_reads(
    contigs: List[FastaRecord],
    n_reads: int,
    read_len: Tuple[int, int] = (500, 3000),
    accuracy: float = 0.85,
    seed: int = 1,
    both_strands: bool = True,
    hp_ins_mult: float = 1.0,
) -> List[SimRead]:
    rng = np.random.default_rng(seed)
    err = 1.0 - accuracy
    # CLR-like split: ~50% ins, ~30% del, ~20% sub of total error
    ins, dele, sub = 0.5 * err, 0.3 * err, 0.2 * err
    lens = np.array([len(c.seq) for c in contigs])
    probs = lens / lens.sum()
    out: List[SimRead] = []
    for i in range(n_reads):
        ci = int(rng.choice(len(contigs), p=probs))
        g = contigs[ci].seq
        rl = int(rng.integers(read_len[0], read_len[1] + 1))
        rl = min(rl, len(g))
        ts = int(rng.integers(0, len(g) - rl + 1))
        frag = g[ts:ts + rl]
        strand = int(rng.integers(0, 2)) if both_strands else 0
        if strand:
            frag = revcomp(frag)
        seq = mutate(frag, rng, sub, ins, dele, hp_ins_mult=hp_ins_mult)
        name = f"sim/{i}/0_{len(seq)}"
        out.append(SimRead(FastaRecord(name, seq), ci, ts, ts + rl, strand))
    return out

"""How the benchmark decides ``correct``: one call of the window, drawn
from the seed, against the plain reference (``benchmark/reference``).

The reference maps a sample of the call's first-pass batches, drawn from
the seed: the batches as ``Mapper.map_reads`` forms them (reads bucketed
by length in pool order, ``batch_size_for`` reads a batch), the first
one drawn whatever its size and then each further one while the buckets
of those further ones add up to at most ``REFERENCE_ROWS`` DP rows.  A
batch is the unit because the SDP pass shares its spare rows over a
batch, so a read's alignments can depend on the other reads of its
batch.

For every read of those batches the comparison takes what the CLI's
output is made from: each alignment ``map_reads`` returned (contig,
strand, read and contig coordinates, score, match / mismatch / insertion
/ deletion counts, CIGAR) with the mapQV ``store_map_qvs`` gave it, and
which of them ``select_alignments`` printed.

* A read the ambiguity rescue does not send on must equal the reference
  exactly (``reads_differ``, limit 0).
* A read it sends on (the reference names them: its trigger reads only
  the read's own first pass) was mapped again by the port's deep pass,
  which batches the deep reads of the whole call together, so the
  reference does not map it again: the port's answer must be the
  reference's first-pass answer, or one whose best score is strictly
  lower (the rescue keeps only such answers; ``rescued_not_better``,
  limit 0), and each of its alignments must agree with the sequences:
  its CIGAR spans its read and contig intervals, and the matches,
  mismatches, insertions, deletions and distance score it reports are
  those that the CIGAR gives over the read and the contig
  (``rescued_inconsistent``, limit 0).  Where the deep pass places such
  a read is not compared with a reference.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from benchmark.inputs import Inputs, sub_seeds

# the DP rows (sum of the sampled batches' buckets) the reference maps
# past its first batch: at ~1 ms a row on an H100, its own index build
# included, 11-33 s a sample (median ~18 s), holding 16-185 reads
REFERENCE_ROWS = 8192

# the numbers compared and their limits
LIMITS = {"reads_differ": 0, "rescued_not_better": 0,
          "rescued_inconsistent": 0}

Canon = Tuple[tuple, tuple]


def canon_alignment(a) -> tuple:
    """One alignment as the fields the comparison holds to."""
    cigar = tuple((str(op), int(n)) for op, n in (a.cigar or ()))
    return (int(a.tindex), int(a.strand), int(a.qstart), int(a.qend),
            int(a.tstart), int(a.tend), float(a.score), int(a.n_match),
            int(a.n_mismatch), int(a.n_ins), int(a.n_del), int(a.map_qv),
            cigar)


def canon_read(alns: Sequence, chosen: Sequence) -> Canon:
    """A read's alignments and the places of the printed ones among
    them."""
    where = {id(a): i for i, a in enumerate(alns)}
    return (tuple(canon_alignment(a) for a in alns),
            tuple(where[id(a)] for a in chosen))


def best_score(c: Canon) -> float:
    return min((a[6] for a in c[0]), default=math.inf)


def finish_reads(per_read, recs, params, gi, select, zmw_key,
                 store: bool = True) -> List[Optional[Canon]]:
    """The CLI's first output pass over ``map_reads``' result
    (``cli/blasr.py::emit``): mapQVs stored (unless ``store`` is false:
    the program's run stored them in its own emit), the printed
    alignments selected; ``select`` is the module holding
    ``store_map_qvs``, ``select_alignments`` and ``zmw_rand_int``.  Reads
    the reference did not map stay None."""
    out: List[Optional[Canon]] = []
    for rec, alns in zip(recs, per_read):
        if alns is None:
            out.append(None)
            continue
        if store and params.store_map_qv:
            select.store_map_qvs(alns, params, gi)
        rint = select.zmw_rand_int(zmw_key(rec.name), params.random_seed)
        out.append(canon_read(alns, select.select_alignments(alns, params,
                                                             rint)))
    return out


def first_pass_batches(mapper, lens: Sequence[int]) -> List[Tuple[int, int]]:
    """The (bucket, batch index) of every first-pass batch of a call over
    reads of these lengths, as ``Mapper.map_reads`` forms them."""
    p, cfg = mapper.params, mapper.cfg
    n_in: Dict[int, int] = {}
    for n in lens:
        if n < p.min_read_length or (p.max_read_length
                                     and n > p.max_read_length):
            continue
        if n > cfg.buckets[-1]:
            continue
        b = cfg.bucket_for(n)
        n_in[b] = n_in.get(b, 0) + 1
    out = []
    for b in sorted(n_in):
        batch = mapper.batch_size_for(b)
        out.extend((b, i) for i in range(-(-n_in[b] // batch)))
    return out


def sample_batches(batches: List[Tuple[int, int]], seed: int,
                   rows: int = REFERENCE_ROWS) -> Set[Tuple[int, int]]:
    """The batches the reference maps (module docstring)."""
    rng = np.random.default_rng(sub_seeds(seed, 3)[2])
    order = rng.permutation(len(batches))
    chosen = [batches[order[0]]]
    used = 0
    for k in order[1:]:
        b = batches[k][0]
        if used + b <= rows:
            chosen.append(batches[k])
            used += b
    return set(chosen)


@dataclass
class Reference:
    """The reference's answers for the sampled reads, and what the
    consistency of an alignment is judged by: the reads, the contigs and
    the distance scoring (the 5x5 matrix, insertion and deletion)."""

    reads: List[Optional[Canon]]
    deep: Set[int]
    batches: Set[Tuple[int, int]]
    inputs: Optional[Inputs] = None
    scoring: Optional[Tuple[np.ndarray, float, float]] = None


def revcomp(seq: np.ndarray) -> np.ndarray:
    s = np.asarray(seq)
    return np.where(s < 4, 3 - s, s)[::-1]


def inconsistent(c: Canon, read: np.ndarray, contigs,
                 scoring: Tuple[np.ndarray, float, float]) -> int:
    """How many of a read's alignments disagree with the sequences: the
    CIGAR, walked over the read's interval (reverse-complemented on
    strand 1) and the contig's, must end at both intervals' ends and give
    the reported counts and distance score."""
    submat, ins_cost, del_cost = scoring
    bad = 0
    for a in c[0]:
        tindex, strand, qs, qe, ts, te, score = a[:7]
        q = np.asarray(read[qs:qe], dtype=np.int64)
        if strand:
            q = revcomp(q)
        t = np.asarray(contigs[tindex].seq[ts:te], dtype=np.int64)
        i = j = 0
        m = x = n_i = n_d = 0
        total = 0.0
        ok = True
        for op, n in a[12]:
            if op in "M=X":
                if i + n > len(q) or j + n > len(t):
                    ok = False
                    break
                qq, tt = q[i:i + n], t[j:j + n]
                eq = int((qq == tt).sum())
                m += eq
                x += n - eq
                total += float(submat[qq * 5 + tt].sum())
                i += n
                j += n
            elif op == "I":
                n_i += n
                total += ins_cost * n
                i += n
            elif op == "D":
                n_d += n
                total += del_cost * n
                j += n
            else:
                ok = False
                break
        ok = ok and (i, j) == (len(q), len(t)) \
            and (m, x, n_i, n_d) == tuple(a[7:11]) and total == score
        bad += int(not ok)
    return bad


def run_reference(inputs: Inputs, seed: int, device, dtype=None,
                  rows: int = REFERENCE_ROWS) -> Reference:
    """The reference (``benchmark/reference``) over the sampled batches
    of the pool, on ``device``; ``dtype`` the DP's cost type (None:
    float32, as the port)."""
    import torch

    from benchmark.reference import banded, genome, map_read, params
    from benchmark.reference import select as rselect
    from benchmark.reference.fasta import FastaRecord
    p = params.MappingParams(**inputs.mapper).make_sane()
    gi = genome.build_genome_index(
        [FastaRecord(c.title, c.seq) for c in inputs.contigs],
        k=min(p.min_match_length, 16))
    mapper = map_read.Mapper(gi, p, device=device)
    recs = [FastaRecord(r.name, r.seq) for r in inputs.pool]
    sample = sample_batches(
        first_pass_batches(mapper, [len(r.seq) for r in recs]), seed, rows)
    with banded.cost_dtype(dtype or torch.float32):
        per_read = mapper.map_reads(recs, only=sample)
    return Reference(finish_reads(per_read, recs, mapper.params, gi,
                                  rselect, rselect.zmw_key),
                     set(mapper.deep), sample, inputs,
                     (np.asarray(p.score_matrix, np.float64).reshape(25),
                      float(p.insertion), float(p.deletion)))


def compare(program: Sequence[Canon], ref: Reference) -> Dict[str, int]:
    """The numbers compared (module docstring) and what they were counted
    over."""
    out = dict(reads_differ=0, rescued_not_better=0,
               rescued_inconsistent=0, reads_compared=0, deep_reads=0,
               deep_replaced=0)
    for j, rc in enumerate(ref.reads):
        if rc is None:
            continue
        pc = program[j]
        if j in ref.deep:
            out["deep_reads"] += 1
            if pc == rc:
                continue
            out["rescued_inconsistent"] += int(inconsistent(
                pc, ref.inputs.pool[j].seq, ref.inputs.contigs,
                ref.scoring) > 0)
            if best_score(pc) < best_score(rc):
                out["deep_replaced"] += 1
            else:
                out["rescued_not_better"] += 1
        else:
            out["reads_compared"] += 1
            out["reads_differ"] += int(pc != rc)
    return out


def verdict(numbers: Dict[str, int]) -> Tuple[bool, Dict[str, dict]]:
    checks = {k: {"value": numbers[k], "limit": lim}
              for k, lim in LIMITS.items()}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks


def placed_share(pool, per_read) -> float:
    """The share of reads whose best alignment (lowest score) lies on the
    read's contig and strand and overlaps its simulated interval."""
    placed = 0
    for r, alns in zip(pool, per_read):
        if not alns:
            continue
        best = min(alns, key=lambda a: a.score)
        placed += int(best.tindex == r.contig and best.strand == r.strand
                      and best.tstart < r.tend and best.tend > r.tstart)
    return placed / max(len(pool), 1)

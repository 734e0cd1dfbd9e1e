"""Reads longer than the largest bucket through the PyTorch port's Mapper
on the CPU (the segment + stitch path, ``pipeline/longread.py``) against
the JAX package's Mapper: tests/test_longread.py's 5.5 kb read at 4%
error on both strands, with ``ShapeConfig(buckets=(1024, 2048),
batch_size=8)``.  Every alignment's strand, contig, target and query
interval, CIGAR and score must be identical.  The ~20 kb CLR read is in
``test_torch_longread_clr.py``, a file of its own so that ``--dist
loadfile`` puts the two on two workers."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from blasr_tpu.index.genome import build_genome_index  # noqa: E402
from blasr_tpu.io.fasta import FastaRecord, revcomp  # noqa: E402
from blasr_tpu.params import MappingParams, ShapeConfig  # noqa: E402
from blasr_tpu.pipeline import map_read as jmr  # noqa: E402
from blasr_tpu.sim import random_genome  # noqa: E402
from blasr_tpu_torch.pipeline import map_read as tmr  # noqa: E402

torch.set_num_threads(2)

CFG = ShapeConfig(buckets=(1024, 2048), batch_size=8)


def alignment_tuples(per_read):
    return [[(a.strand, a.tindex, a.tstart, a.tend, a.qstart, a.qend,
              list(a.cigar), a.score) for a in alns] for alns in per_read]


def port_equals_jax(gi, recs):
    """Map ``recs`` with both Mappers; returns the port's alignments."""
    params = MappingParams(min_read_length=50).make_sane()
    want = jmr.Mapper(gi, params, CFG).map_reads(recs)
    got = tmr.Mapper(gi, params, CFG, device="cpu").map_reads(recs)
    assert alignment_tuples(got) == alignment_tuples(want)
    return got


@pytest.fixture(scope="module")
def genome_60k():
    contigs = random_genome(60_000, seed=141)
    return contigs, build_genome_index(contigs, k=12)


@pytest.mark.parametrize("rc", [False, True])
def test_long_read_segments_match_jax(genome_60k, rc):
    contigs, gi = genome_60k
    read = contigs[0].seq[5_000:10_500].copy()     # 5.5 kb, bucket cap 2048
    rng = np.random.default_rng(142)
    idx = rng.random(len(read)) < 0.04
    read[idx] = rng.integers(0, 4, int(idx.sum()))
    if rc:
        read = revcomp(read)
    got = port_equals_jax(gi, [FastaRecord("long/0/0_5500", read)])
    best = min(got[0], key=lambda a: a.score)
    assert best.strand == int(rc) and best.qend - best.qstart > 4500


"""tests/test_longread.py's ~20 kb CLR read at 85% accuracy (errors
crossing every segment boundary) through the PyTorch port's Mapper on the
CPU against the JAX package's, segment + stitch at buckets (1024, 2048):
identical alignments."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from blasr_tpu.index.genome import build_genome_index  # noqa: E402
from blasr_tpu.io.fasta import FastaRecord  # noqa: E402
from blasr_tpu.sim import mutate, random_genome  # noqa: E402
from test_torch_longread import port_equals_jax  # noqa: E402


def test_20kb_clr_read_matches_jax():
    contigs = random_genome(300_000, seed=181)
    gi = build_genome_index(contigs, k=12)
    rng = np.random.default_rng(182)
    ts, tl, err = 40_000, 20_000, 0.15
    read = mutate(contigs[0].seq[ts:ts + tl], rng, 0.2 * err, 0.5 * err,
                  0.3 * err)
    got = port_equals_jax(gi, [FastaRecord(f"clr/0/0_{len(read)}", read)])
    best = min(got[0], key=lambda a: a.score)
    assert best.strand == 0 and best.qend - best.qstart >= 0.97 * len(read)

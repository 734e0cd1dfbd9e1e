"""The cross-index rescue through the PyTorch port's Mapper against the
JAX package's on the CPU (every alignment identical): a strict k = 14
Mapper (minimum match 18) whose weak and unmapped reads re-map through a
``Mapper(rescue=...)`` over a k = 12 index (tools/soak_genome.py's
layout), on reads at 90% and 70% accuracy.  ``occ_block_sample`` is in
``test_torch_mapper_block.py``.  The same run goes through the card in
chip_smoke.py (card == CPU)."""

import pytest

torch = pytest.importorskip("torch")

from blasr_tpu.index.genome import build_genome_index  # noqa: E402
from blasr_tpu.io.fasta import FastaRecord  # noqa: E402
from blasr_tpu.params import MappingParams  # noqa: E402
from blasr_tpu.pipeline import map_read as jmr  # noqa: E402
from blasr_tpu.sim import random_genome, simulate_reads  # noqa: E402
from blasr_tpu_torch.pipeline import map_read as tmr  # noqa: E402
from test_torch_mapper_modes import CFG, fields, same_as_jax  # noqa: E402
from torch_shared import TORCH_THREADS  # noqa: E402

torch.set_num_threads(TORCH_THREADS)


def test_rescue_mapper_matches_jax():
    contigs = random_genome(40_000, seed=71)
    sims = simulate_reads(contigs, 4, read_len=(400, 700), accuracy=0.9,
                          seed=72)
    sims += simulate_reads(contigs, 4, read_len=(400, 700), accuracy=0.7,
                           seed=73)
    recs = [FastaRecord(f"r/{i}/0_{len(s.rec.seq)}", s.rec.seq)
            for i, s in enumerate(sims)]
    gi14 = build_genome_index(contigs, k=14)
    gi12 = build_genome_index(contigs, k=12)
    p = MappingParams(min_match_length=18)
    rp = MappingParams().make_sane()
    got = same_as_jax(
        gi14, p, recs,
        jax_kw=dict(rescue=jmr.Mapper(gi12, rp, CFG)),
        port_kw=dict(rescue=tmr.Mapper(gi12, rp, CFG, device="cpu")))
    # the rescue changed something: the strict Mapper alone maps fewer
    alone = tmr.Mapper(gi14, p.make_sane(), CFG, device="cpu").map_reads(recs)
    assert fields(alone) != fields(got)

"""``ShapeConfig(occ_block_sample=True)`` through the PyTorch port's Mapper
against the JAX package's on the CPU (every alignment identical), on a
genome with an eight-copy repeat at O = 3: over-abundant seeds take the
contiguous occurrence window (K5's block mode on the card).  The same
run goes through the card in chip_smoke.py (card == CPU)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from blasr_tpu.index.genome import build_genome_index  # noqa: E402
from blasr_tpu.io.fasta import FastaRecord  # noqa: E402
from blasr_tpu.params import MappingParams, ShapeConfig  # noqa: E402
from blasr_tpu.sim import simulate_reads  # noqa: E402
from test_torch_mapper_modes import same_as_jax  # noqa: E402
from torch_shared import TORCH_THREADS  # noqa: E402

torch.set_num_threads(TORCH_THREADS)


def test_occ_block_sample_matches_jax():
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
    recs.append(FastaRecord("b/5/0_400", unit.copy()))
    cfg = ShapeConfig(buckets=(1024,), batch_size=8, occ_per_pos=3,
                      occ_block_sample=True)
    got = same_as_jax(build_genome_index(contigs, k=12), MappingParams(),
                      recs, cfg=cfg)
    assert sum(map(bool, got)) >= 5

"""The smoke's two ~40 kb reads (1 Mbp genome, seeds 40 and 41; the
default ShapeConfig, so bucket 65536) mapped by the JAX package's Mapper
and by the PyTorch port's on the CPU: identical alignments, spans
included.  Marked slow (tier-1 runs ``-m 'not slow'``): the plain banded
DP walks ~154k rows per dispatch on the CPU.  Run it alone with
``python -m pytest -n 0 -m slow tests/test_torch_longread_65536.py``."""

import pytest

torch = pytest.importorskip("torch")

from blasr_tpu.index.genome import build_genome_index  # noqa: E402
from blasr_tpu.params import MappingParams, ShapeConfig  # noqa: E402
from blasr_tpu.pipeline import map_read as jmr  # noqa: E402
from blasr_tpu.sim import random_genome, simulate_reads  # noqa: E402
from blasr_tpu_torch.pipeline import map_read as tmr  # noqa: E402
from test_torch_longread import alignment_tuples  # noqa: E402


@pytest.mark.slow
def test_40kb_reads_at_bucket_65536_match_jax():
    contigs = random_genome(1_000_000, seed=40)
    gi = build_genome_index(contigs, k=12)
    sims = simulate_reads(contigs, 2, read_len=(38_000, 42_000),
                          accuracy=0.85, seed=41)
    cfg = ShapeConfig()
    assert all(cfg.bucket_for(len(s.rec.seq)) == 65536 for s in sims)
    recs = [s.rec for s in sims]
    params = MappingParams().make_sane()
    want = jmr.Mapper(gi, params, cfg).map_reads(recs)
    got = tmr.Mapper(gi, params, cfg, device="cpu").map_reads(recs)
    for s, alns in zip(sims, got):
        best = min(alns, key=lambda a: a.score)
        print(f"read {len(s.rec.seq)} b: span {best.qend - best.qstart} "
              f"({(best.qend - best.qstart) / len(s.rec.seq):.4f}), "
              f"strand {best.strand}, [{best.tstart}, {best.tend})")
    assert alignment_tuples(got) == alignment_tuples(want)

"""Batch-size invariance (tests/test_pipeline.py:209) through the JAX
Mapper and the PyTorch port's on the CPU, on that test's world (120 kb,
20 reads, bucket 1024): batch 3 pushes seven batches through each
package's window of four dispatches in flight, and every alignment field
equals the world's batch-8 run in both packages."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from blasr_tpu.index import build_genome_index  # noqa: E402
from blasr_tpu.params import MappingParams, ShapeConfig  # noqa: E402
from blasr_tpu.sim import random_genome, simulate_reads  # noqa: E402
from test_torch_mapper_modes import fields  # noqa: E402
from torch_options import map_both, recorded  # noqa: E402
from torch_shared import TORCH_THREADS  # noqa: E402

torch.set_num_threads(TORCH_THREADS)

CFG = ShapeConfig(buckets=(1024,), batch_size=8, max_anchors=256)


def test_batch_size_invariance_matches_jax():
    contigs = random_genome(120_000, seed=5, n_contigs=2)
    gi = build_genome_index(contigs, k=12)
    recs = [s.rec for s in simulate_reads(contigs, 20, read_len=(300, 900),
                                          accuracy=0.87, seed=7)]
    base, _, _ = map_both(gi, MappingParams(), recs, CFG)
    with recorded() as calls:
        got, _, _ = map_both(gi, MappingParams(), recs,
                             dataclasses.replace(CFG, batch_size=3))
    assert len(calls["map_batch"]) == 7
    assert fields(got) == fields(base)

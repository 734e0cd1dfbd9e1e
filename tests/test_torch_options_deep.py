"""The ambiguity rescue's deep pass (``Mapper._max_seed_depth``, then
``map_batch(full_widen=True)`` at ``n_candidates`` >= 32 and
``max_anchors`` >= 2048) through the JAX Mapper and the PyTorch port's on
the CPU, on tests/test_repetitive.py:139's world (a 600 bp unit tandem
ten times, then 5 kb of unique sequence) with a read from inside the
repeat: every alignment field identical, and the deep pass ran in both
packages with its arguments.  The same run goes through the card in
chip_smoke.py (card == CPU)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from blasr_tpu.index import build_genome_index  # noqa: E402
from blasr_tpu.io.fasta import FastaRecord  # noqa: E402
from blasr_tpu.params import MappingParams, ShapeConfig  # noqa: E402
from torch_options import map_both  # noqa: E402
from torch_shared import TORCH_THREADS  # noqa: E402

torch.set_num_threads(TORCH_THREADS)


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(4)
    unit = rng.integers(0, 4, 600).astype(np.int8)
    g = np.concatenate([np.tile(unit, 10),
                        rng.integers(0, 4, 5000).astype(np.int8)])
    gi = build_genome_index([FastaRecord("c", g)], k=12)
    return gi, FastaRecord("r", unit[:400])


def test_deep_pass_matches_jax(world):
    gi, read = world
    got, args, (jm, tm) = map_both(
        gi, MappingParams(), [read], ShapeConfig(buckets=(512,),
                                                 batch_size=1))
    assert got[0]
    # the read sees ~10 occurrences a seed in both packages
    assert 9 <= jm._max_seed_depth(read) == tm._max_seed_depth(read) <= 12
    first, deep = args
    assert not first["full_widen"]
    assert deep["full_widen"] and deep["C"] >= 32 and deep["A"] >= 2048
    assert deep["O"] >= 48 and deep["cand_drift"] > 0

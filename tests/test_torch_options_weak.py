"""``--useSensitiveSearch`` (tests/test_flags.py:186) through the JAX
Mapper and the PyTorch port's on the CPU, on that test's world (the
200 kb genome of tests/conftest.py, ``occ_per_pos`` 1, ``max_anchors``
64) and its weak read, every 16th base mutated: every alignment field
identical, and the sensitive pass ran in both packages with its
arguments (``advance_exact`` 0, twice the ``occ_per_pos`` and
``max_anchors``).  The JAX test's read aligns at 94% identity, above the
80% below which the pass runs, so here random substitutions at 15% are
added on top (the pass then runs and keeps the same alignment).  The same
run goes through the card in chip_smoke.py (card == CPU)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from blasr_tpu.io.fasta import FastaRecord  # noqa: E402
from blasr_tpu.params import MappingParams, ShapeConfig  # noqa: E402
from torch_options import map_both  # noqa: E402
from torch_shared import TORCH_THREADS  # noqa: E402

torch.set_num_threads(TORCH_THREADS)

CFG = ShapeConfig(buckets=(1024,), batch_size=1, occ_per_pos=1,
                  max_anchors=64)


def weak_read(genome):
    """test_sensitive_search_rescues_weak_read's read, with 15% random
    substitutions on top."""
    frag = genome[3000:4000].copy()
    frag[::16] = (frag[::16] + 1) % 4
    rng = np.random.default_rng(1)
    m = rng.random(len(frag)) < 0.15
    frag[m] = (frag[m] + rng.integers(1, 4, int(m.sum()))) % 4
    return FastaRecord("weak/1/0_1000", frag)


def test_sensitive_search_matches_jax(small_index, small_genome):
    read = weak_read(small_genome[0].seq)
    got, args, _ = map_both(small_index,
                            MappingParams(do_sensitive_search=True), [read],
                            CFG)
    assert got[0] and max(a.pct_similarity for a in got[0]) < 80.0
    assert [(a["O"], a["A"], a["advance_exact"]) for a in args] == \
        [(1, 64, 0), (2, 128, 0)]

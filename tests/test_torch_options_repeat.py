"""``--minExpand`` (tests/test_flags.py:159) and emit-all,
``--maxAnchorsPerPosition 64`` (tests/test_repetitive.py:115), through
the JAX Mapper and the PyTorch port's on the CPU, on test_flags.py's
``repeat_genome_world`` (a 1.5 kb segment at four loci of a 40 kb genome)
with its read and its ``occ_per_pos`` 1: every alignment field identical
in the two packages, and each option's effect shown.

* ``--minExpand 2`` starts the mapping pass at expansion level 2: a
  deeper ``occ_per_pos`` (K5) in the first call, and more placements of
  the repeat read than the default run reports.
* emit-all makes 64 the Mapper's ``occ_per_pos`` in both packages (K5's
  deeper ``[2B, L, O]``); the read then reports more placements too.

The default run takes the ambiguity rescue's deep pass on this read
(its second call).  The same options run on the card in chip_smoke.py
(card == CPU)."""

import pytest

torch = pytest.importorskip("torch")

from blasr_tpu.index import build_genome_index  # noqa: E402
from blasr_tpu.io.fasta import FastaRecord  # noqa: E402
from blasr_tpu.params import MappingParams, ShapeConfig  # noqa: E402
from blasr_tpu.sim import random_genome  # noqa: E402
from torch_options import changed, map_both  # noqa: E402
from torch_shared import TORCH_THREADS, shared  # noqa: E402

torch.set_num_threads(TORCH_THREADS)

CFG = ShapeConfig(buckets=(2048,), batch_size=1, occ_per_pos=1)
# test_min_expand_starts_loose's hit policy: every placement reported
POLICY = dict(hit_policy="all", n_best=10)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """``build_world``, once per test run (tests/torch_shared.py)."""
    return shared(tmp_path_factory, __file__, "world", build_world)


def build_world(_):
    """(index, the repeat read, the default run's port alignments and
    call arguments), as tests/test_flags.py::repeat_genome_world and
    test_min_expand_starts_loose build them."""
    contigs = random_genome(40_000, seed=31)
    g = contigs[0].seq.copy()
    seg = g[5000:6500].copy()
    for pos in (15000, 25000, 35000):
        g[pos:pos + 1500] = seg
    gi = build_genome_index([FastaRecord("contig0", g)], k=12)
    read = FastaRecord("rep/9/0_1300", seg[100:1400].copy())
    base, base_args, _ = map_both(gi, MappingParams(**POLICY), [read], CFG)
    assert base[0]
    return gi, read, base, base_args


def test_min_expand_matches_jax(world):
    gi, read, base, base_args = world
    got, args, _ = map_both(gi, MappingParams(min_expand=2, max_expand=2,
                                              **POLICY), [read], CFG)
    assert changed(args, base_args).get("O", 1) > 1
    assert len(got[0]) > len(base[0])


def test_emit_all_matches_jax(world):
    gi, read, base, base_args = world
    got, args, (jm, tm) = map_both(
        gi, MappingParams(max_anchors_per_position=64, **POLICY), [read],
        CFG)
    assert jm.cfg.occ_per_pos == tm.cfg.occ_per_pos == 64
    assert changed(args, base_args)["O"] == 64
    assert len(got[0]) > len(base[0])

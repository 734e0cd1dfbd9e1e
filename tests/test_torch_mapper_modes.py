"""A general ``--scoreMatrix`` through the PyTorch port's Mapper against
the JAX package's on the CPU (every alignment's coordinates, CIGAR,
score, counts and mapQV identical): tests/test_cli_features.py's matrix
(uneven mismatches, N row and column of their own) on the small golden
world, and with ``--useQuality`` on two reads of the hp-biased STR world
of tests/test_golden.py::make_hpstr.  The helpers serve the other Mapper
files: ``test_torch_mapper_affine_qv.py`` (``--affineAlign
--useQuality``), ``test_torch_mapper_rescue.py`` (a rescue Mapper) and
``test_torch_mapper_block.py`` (occ_block_sample).  The same runs go
through the card in chip_smoke.py (card == CPU)."""

import pytest

torch = pytest.importorskip("torch")

from blasr_tpu.index.genome import build_genome_index  # noqa: E402
from blasr_tpu.io.fasta import read_sequences  # noqa: E402
from blasr_tpu.params import MappingParams, ShapeConfig  # noqa: E402
from blasr_tpu.pipeline import map_read as jmr  # noqa: E402
from blasr_tpu_torch.pipeline import map_read as tmr  # noqa: E402
from test_golden import make_hpstr, make_small  # noqa: E402
from torch_shared import TORCH_THREADS  # noqa: E402

torch.set_num_threads(TORCH_THREADS)

# tests/test_cli_features.py::test_score_matrix_flag_forces_xla_kernel's
# matrix: -5 on the ACGT diagonal, 6 or 7 off it, N row and column 6 / 7
SCORE_MATRIX = [[-5 if i == j and i < 4 else 6 + (i + j) % 2
                 for j in range(5)] for i in range(5)]
CFG = ShapeConfig(buckets=(1024,), batch_size=8)


def fields(per_read):
    return [[(a.strand, a.tindex, a.tstart, a.tend, a.qstart, a.qend,
              list(a.cigar), a.score, a.n_match, a.n_mismatch, a.n_ins,
              a.n_del, a.map_qv) for a in alns] for alns in per_read]


def same_as_jax(gi, params, recs, cfg=CFG, jax_kw=None, port_kw=None):
    """Map ``recs`` with the JAX Mapper and the port's on the CPU, assert
    identical alignments; the port's alignments."""
    p = params.make_sane()
    want = jmr.Mapper(gi, p, cfg, **(jax_kw or {})).map_reads(recs)
    got = tmr.Mapper(gi, p, cfg, device="cpu",
                     **(port_kw or {})).map_reads(recs)
    assert fields(got) == fields(want)
    return got


def golden_world(d, make):
    """(k = 12 index, read records) of a tests/test_golden.py world."""
    reads, genome, _ = make(d)
    return (build_genome_index(list(read_sequences(genome)), k=12),
            list(read_sequences(reads)))


@pytest.mark.parametrize("world", ["small", "hpstr-qv"])
def test_score_matrix_matches_jax(tmp_path, world):
    gi, recs = golden_world(str(tmp_path),
                            make_small if world == "small" else make_hpstr)
    p = MappingParams(score_matrix=SCORE_MATRIX,
                      ignore_qualities=world == "small")
    # the hpstr world's reads over its planted homopolymer runs (the others
    # take the ambiguity rescue's deep pass, a minute each on the CPU)
    got = same_as_jax(gi, p, recs[:4] if world == "small" else recs[1:3])
    assert all(got)

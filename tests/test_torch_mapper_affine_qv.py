"""``--affineAlign --useQuality`` through the PyTorch port's Mapper
against the JAX package's on the CPU, on the two reads of the hp-biased
STR world (tests/test_golden.py::make_hpstr) over its planted 9- and
15-base homopolymer runs (its other reads take the ambiguity rescue's
deep pass, a minute of plain PyTorch each): the QV-steered DP with the
affine gap costs set and no hp band, as the JAX package runs it (K1-QV
on the card).  Every alignment identical."""

import pytest

torch = pytest.importorskip("torch")

from blasr_tpu.params import MappingParams  # noqa: E402
from test_golden import make_hpstr  # noqa: E402
from test_torch_mapper_modes import golden_world, same_as_jax  # noqa: E402
from torch_shared import TORCH_THREADS  # noqa: E402

torch.set_num_threads(TORCH_THREADS)


def test_affine_use_quality_matches_jax(tmp_path):
    gi, recs = golden_world(str(tmp_path), make_hpstr)
    p = MappingParams(affine_align=True, ignore_qualities=False)
    got = same_as_jax(gi, p, recs[1:3])
    assert all(got)

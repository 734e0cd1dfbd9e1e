"""The PyTorch port's CLI on the CPU (``--device cpu``: the plain DP with
the homopolymer-insertion band) reproduces ``golden.m4.affine`` byte for
byte: the small world mapped with ``--affineAlign --affineOpen 8
--affineExtend 1``.  ``golden.m4.hpstr.affine`` (the hp-biased STR world)
is in ``test_torch_golden_hpstr_affine.py``."""

import pytest

torch = pytest.importorskip("torch")

from test_torch_golden_qv import port_reproduces_golden_case  # noqa: E402
from torch_shared import TORCH_THREADS  # noqa: E402

torch.set_num_threads(TORCH_THREADS)


def test_port_cli_reproduces_affine_golden(tmp_path_factory):
    port_reproduces_golden_case(tmp_path_factory, "m4.affine")

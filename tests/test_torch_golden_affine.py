"""The PyTorch port's CLI on the CPU (``--device cpu``: the plain DP with
the homopolymer-insertion band) reproduces ``golden.m4.affine`` byte for
byte: the small world mapped with ``--affineAlign --affineOpen 8
--affineExtend 1``.  ``golden.m4.hpstr.affine`` (the hp-biased STR world)
is in ``test_torch_golden_hpstr_affine.py``, a file of its own so that
``--dist loadfile`` spreads the two over workers."""

import pytest

torch = pytest.importorskip("torch")

from test_torch_golden_qv import port_reproduces_golden_case  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return str(tmp_path_factory.mktemp("torch_golden_affine")), {}


def test_port_cli_reproduces_affine_golden(worlds):
    port_reproduces_golden_case(worlds, "m4.affine")

"""The PyTorch port's CLI on the CPU reproduces the JAX package's
small-world goldens whose flags change what is mapped, not only how it is
printed: --hitPolicy randombest, gap and match costs other than the
defaults (--insertion 6 --deletion 7) and the output filters.  The
format-only small-world goldens (m0-m3, m5, sam.hard, sam.subread) differ
from golden.m4 only in the host printers, copies held by the drift test;
the card's smoke holds them."""

import pytest

torch = pytest.importorskip("torch")

from test_torch_golden_qv import port_reproduces_golden_case  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return str(tmp_path_factory.mktemp("torch_golden_small")), {}


@pytest.mark.parametrize("name", ["m4.rb", "m4.scores", "m4.filter"])
def test_port_cli_reproduces_small_golden(worlds, name):
    port_reproduces_golden_case(worlds, name)

"""The PyTorch port's CLI on the CPU reproduces golden.m4.unal byte for
byte: the small world plus two unmappable reads, listed by --unaligned."""

import pytest

torch = pytest.importorskip("torch")

from test_torch_golden_qv import port_reproduces_golden_case  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return str(tmp_path_factory.mktemp("torch_golden_unal")), {}


@pytest.mark.parametrize("name", ["m4.unal"])
def test_port_cli_reproduces_unaligned_golden(worlds, name):
    port_reproduces_golden_case(worlds, name)

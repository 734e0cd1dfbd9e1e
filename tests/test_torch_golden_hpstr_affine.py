"""The PyTorch port's CLI on the CPU reproduces ``golden.m4.hpstr.affine``
byte for byte: homopolymer-insertion-biased reads over STR arrays mapped
with ``--affineAlign``, the workload the hp band is for (the plain DP
with the band; the FASTQ qualities are not used without
``--useQuality``)."""

import pytest

torch = pytest.importorskip("torch")

from test_torch_golden_qv import port_reproduces_golden_case  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return str(tmp_path_factory.mktemp("torch_golden_hpstr_affine")), {}


def test_port_cli_reproduces_hpstr_affine_golden(worlds):
    port_reproduces_golden_case(worlds, "m4.hpstr.affine")

"""The PyTorch port's CLI on the CPU reproduces ``golden.m4.hpstr.affine``
byte for byte: homopolymer-insertion-biased reads over STR arrays mapped
with ``--affineAlign``, the workload the hp band is for (the plain DP
with the band; the FASTQ qualities are not used without
``--useQuality``)."""

import pytest

torch = pytest.importorskip("torch")

from test_torch_golden_qv import port_reproduces_golden_case  # noqa: E402
from torch_shared import TORCH_THREADS  # noqa: E402

torch.set_num_threads(TORCH_THREADS)


def test_port_cli_reproduces_hpstr_affine_golden(tmp_path_factory):
    port_reproduces_golden_case(tmp_path_factory, "m4.hpstr.affine")

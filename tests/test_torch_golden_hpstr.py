"""The PyTorch port's CLI on the CPU reproduces ``golden.sam.hpstr.qv``
byte for byte: homopolymer-insertion-biased FASTQ reads over STR arrays,
mapped with ``--useQuality`` (the plain QV-steered DP)."""

import pytest

torch = pytest.importorskip("torch")

from test_golden import make_hpstr  # noqa: E402
from test_torch_golden_qv import port_output_equals_golden  # noqa: E402

torch.set_num_threads(2)


def test_port_cli_reproduces_hpstr_qv_golden(tmp_path):
    d = str(tmp_path)
    port_output_equals_golden(d, make_hpstr(d), "sam.hpstr.qv",
                              ["--sam", "--clipping", "soft",
                               "--useQuality"])

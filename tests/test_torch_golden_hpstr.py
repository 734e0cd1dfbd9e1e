"""The PyTorch port's CLI on the CPU reproduces ``golden.sam.hpstr.qv``
byte for byte: homopolymer-insertion-biased FASTQ reads over STR arrays,
mapped with ``--useQuality`` (the plain QV-steered DP)."""

import pytest

torch = pytest.importorskip("torch")

from test_torch_golden_qv import golden_world  # noqa: E402
from test_torch_golden_qv import port_output_equals_golden  # noqa: E402
from torch_shared import TORCH_THREADS  # noqa: E402

torch.set_num_threads(TORCH_THREADS)


def test_port_cli_reproduces_hpstr_qv_golden(tmp_path_factory):
    port_output_equals_golden(*golden_world(tmp_path_factory, "hpstr"),
                              "sam.hpstr.qv",
                              ["--sam", "--clipping", "soft",
                               "--useQuality"])

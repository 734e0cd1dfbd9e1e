"""The PyTorch port's CLI on the CPU reproduces the JAX package's ccs.h5
goldens byte for byte: --useccs (each consensus read the template, its
full passes re-aligned to the template's windows on a padded mini index),
--useccsall --bestn 1 (every pass), and the consensus reads mapped as
plain reads (the default, --useccsdenovo).  The ccs.h5 world needs h5py,
so the CPU holds these alone."""

import pytest

torch = pytest.importorskip("torch")

from test_torch_golden_qv import port_reproduces_golden_case  # noqa: E402
from torch_shared import TORCH_THREADS  # noqa: E402

torch.set_num_threads(TORCH_THREADS)


@pytest.mark.parametrize("name", ["m4.ccs", "m4.ccsall.b1", "m4.ccsdenovo"])
def test_port_cli_reproduces_ccs_golden(tmp_path_factory, name):
    port_reproduces_golden_case(tmp_path_factory, name)

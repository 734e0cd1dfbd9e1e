"""The PyTorch port's CLI on the CPU reproduces the JAX package's bax.h5
goldens byte for byte: region-table subread splitting, --noSplitSubreads
and --holeNumbers on one bax.h5 movie, and a multipart bas.h5 naming two
bax.h5 parts.  These worlds need h5py, which the card's machine lacks, so
the CPU holds them alone."""

import pytest

torch = pytest.importorskip("torch")

from test_torch_golden_qv import port_reproduces_golden_case  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return str(tmp_path_factory.mktemp("torch_golden_h5")), {}


@pytest.mark.parametrize("name", ["m4.bax", "m4.nosplit", "m4.holes",
                                  "m4.multipart"])
def test_port_cli_reproduces_h5_golden(worlds, name):
    port_reproduces_golden_case(worlds, name)

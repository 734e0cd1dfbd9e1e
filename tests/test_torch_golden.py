"""The PyTorch port's CLI on the CPU (``--device cpu``, the plain PyTorch
versions of every kernel) reproduces the JAX package's main-path goldens
byte for byte: golden.m4 and golden.sam of the small world."""

import os

import pytest

torch = pytest.importorskip("torch")

from test_golden import GOLDEN_DIR  # noqa: E402
from test_torch_golden_qv import golden_world  # noqa: E402
from torch_shared import TORCH_THREADS  # noqa: E402

torch.set_num_threads(TORCH_THREADS)


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """The small world's directory, reads and genome (built once per test
    run, ``golden_world``)."""
    d, (reads, genome, _) = golden_world(tmp_path_factory, "small")
    return d, reads, genome


@pytest.mark.parametrize("name,flags", [
    ("m4", ["-m", "4"]),
    ("sam", ["--sam", "--clipping", "soft"]),
])
def test_port_cli_reproduces_golden(small, name, flags):
    from blasr_tpu_torch.cli.blasr import run
    d, reads, genome = small
    out = os.path.join(d, f"out.{name}")
    assert run([reads, genome, "--out", out, "--device", "cpu"] + flags) == 0
    text = open(out).read()
    if name.startswith("sam"):
        # drop the @PG line (embeds the command line), as run_case does
        text = "\n".join(l for l in text.splitlines()
                         if not l.startswith("@PG")) + "\n"
    want = open(os.path.join(GOLDEN_DIR, f"golden.{name}")).read()
    assert text == want, f"port output for {name} differs from the golden"

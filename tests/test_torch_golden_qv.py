"""The PyTorch port's CLI on the CPU (``--device cpu``, the plain PyTorch
versions of every kernel) reproduces the JAX package's ``--useQuality``
goldens byte for byte: the FASTQ world (plain per-base qualities) and the
bax.h5 world with full IDS tracks, the latter with and without
``--useQuality``.  The hp-biased STR world is in
``test_torch_golden_hpstr.py``.  Each golden world's files are built once
per test run (``golden_world``), whichever files and workers use them."""

import os

import pytest

torch = pytest.importorskip("torch")

from test_golden import CASES as GOLDEN_CASES  # noqa: E402
from test_golden import GOLDEN_DIR  # noqa: E402
from test_golden import WORLDS as GOLDEN_WORLDS  # noqa: E402
from torch_shared import TORCH_THREADS, shared  # noqa: E402

torch.set_num_threads(TORCH_THREADS)


def port_output_equals_golden(d, world, name, flags):
    """Run the port's CLI on ``world`` (reads, genome, extra args) and
    compare its output with ``golden.<name>``, as tests/test_golden.py's
    run_case builds it (``@D@`` is ``d``; the --unaligned file is
    appended)."""
    from blasr_tpu_torch.cli.blasr import run
    reads, genome, extra = world
    out = os.path.join(d, f"out.{name}")
    flags = [f.replace("@D@", d) for f in flags]
    assert run([reads, genome, "--out", out, "--device", "cpu"]
               + extra + flags) == 0
    text = open(out).read()
    if "--unaligned" in flags:
        unal = flags[flags.index("--unaligned") + 1]
        text += "== unaligned ==\n" + open(unal).read()
    if name.startswith("sam"):
        # drop the @PG line (embeds the command line), as run_case does
        text = "\n".join(l for l in text.splitlines()
                         if not l.startswith("@PG")) + "\n"
    want = open(os.path.join(GOLDEN_DIR, f"golden.{name}")).read()
    assert text == want, f"port output for {name} differs from the golden"


CASES = {name: (world, flags) for name, world, flags in GOLDEN_CASES}


def golden_world(tmp_path_factory, world):
    """(the world's directory, tests/test_golden.py's ``WORLDS[world]`` of
    it: reads, genome, extra arguments), built once per test run into a
    directory of its own (tests/torch_shared.py); each case writes its
    outputs there under names of its own."""
    return shared(tmp_path_factory, "test_golden.py", world,
                  lambda d: (str(d), GOLDEN_WORLDS[world](str(d))))


def port_reproduces_golden_case(tmp_path_factory, name):
    """``port_output_equals_golden`` for tests/test_golden.py's case
    ``name``, on its world (``golden_world``)."""
    world, flags = CASES[name]
    port_output_equals_golden(*golden_world(tmp_path_factory, world), name,
                              flags)


@pytest.mark.parametrize("name,world,flags", [
    ("m4.fastq", "fastq", ["-m", "4", "--useQuality"]),
    ("sam.fastq", "fastq", ["--sam", "--clipping", "soft", "--useQuality"]),
    ("sam.qv", "qvsteer", ["--sam", "--clipping", "soft", "--useQuality"]),
    ("sam.qv.noqv", "qvsteer", ["--sam", "--clipping", "soft"]),
])
def test_port_cli_reproduces_qv_golden(tmp_path_factory, name, world, flags):
    port_output_equals_golden(*golden_world(tmp_path_factory, world), name,
                              flags)

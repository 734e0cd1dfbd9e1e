"""The port's pairwise tools against the JAX CLIs, byte for byte, on
``tests/test_sdp_sw.py::test_tools_cli``'s world (one read mutated from
300 bases of a 400-base target) plus an unrelated read and a second
target: ``sdpMatcher`` (the port runs with ``--device cpu``) and
``swMatcher`` under ``-printSimilarity``, ``-local``, ``-noRefine``,
``-showalign``, ``-fixedtarget`` and ``-printsw``, each alone and all
together (swMatcher takes ``-local``, ``-showalign`` and
``-fixedtarget``).  The same runs on the card against the CPU are in
``chip_smoke.py``'s phase 3."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from blasr_tpu.cli import sdp_matcher as jsdp_cli  # noqa: E402
from blasr_tpu.cli import sw_matcher as jsw_cli  # noqa: E402
from blasr_tpu.io.fasta import FastaRecord, write_fasta  # noqa: E402
from blasr_tpu_torch.cli import sdp_matcher as tsdp_cli  # noqa: E402
from blasr_tpu_torch.cli import sw_matcher as tsw_cli  # noqa: E402
from test_sdp_sw import mutate  # noqa: E402
from torch_shared import TORCH_THREADS  # noqa: E402

torch.set_num_threads(TORCH_THREADS)

SDP_FLAGS = ["-printSimilarity", "-local", "-noRefine", "-showalign",
             "-fixedtarget", "-printsw"]
SW_FLAGS = ["-local", "-showalign", "-fixedtarget"]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("pairwise")
    rng = np.random.default_rng(23)
    t = rng.integers(0, 4, 400).astype(np.int8)
    q = mutate(rng, t[50:350])
    other = np.random.default_rng(29)
    write_fasta(d / "q.fa", [FastaRecord("q0", q), FastaRecord(
        "q1", other.integers(0, 4, 250).astype(np.int8))])
    write_fasta(d / "t.fa", [FastaRecord("t0", t), FastaRecord(
        "t1", other.integers(0, 4, 380).astype(np.int8))])
    return str(d / "q.fa"), str(d / "t.fa")


def _out(capsys, run, argv):
    assert run(argv) == 0
    return capsys.readouterr().out


@pytest.mark.parametrize("flags", [[f] for f in SDP_FLAGS] + [SDP_FLAGS],
                         ids=SDP_FLAGS + ["all"])
def test_sdp_matcher_matches_jax(world, capsys, flags):
    argv = [*world, "11", *flags]
    want = _out(capsys, jsdp_cli.run, argv)
    got = _out(capsys, tsdp_cli.run, argv + ["--device", "cpu"])
    assert want.startswith("qid,tid,qstart") and want.count("\n") >= 3
    assert got == want


@pytest.mark.parametrize("flags", [[f] for f in SW_FLAGS] + [SW_FLAGS],
                         ids=SW_FLAGS + ["all"])
def test_sw_matcher_matches_jax(world, capsys, flags):
    argv = [*world, *flags]
    want = _out(capsys, jsw_cli.run, argv)
    got = _out(capsys, tsw_cli.run, argv)
    assert want.startswith("qlen tlen score") and want.count("\n") >= 5
    assert got == want


def test_sdp_matcher_cuda_without_card_raises(world, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsdp_cli.run([*world, "11"])

"""``--noStoreMapQV`` and ``--printOnlyBest`` (tests/test_mapqv_parity.py
:186) through the JAX CLI and the PyTorch port's (``--device cpu``) on
the CPU, on that test's world (a 30 kb genome with one 1.5 kb segment at
two loci) and a read from inside the repeat: byte-identical m4 in the
two packages, with one line for the read (``--printOnlyBest``; without
it the read reports both copies) and mapQV 254 (``--noStoreMapQV``;
without it the two copies make the mapQV ambiguous)."""

import pytest

torch = pytest.importorskip("torch")

from blasr_tpu.io.fasta import FastaRecord, write_fasta  # noqa: E402
from blasr_tpu.sim import random_genome  # noqa: E402
from torch_options import cli_both  # noqa: E402
from torch_shared import TORCH_THREADS  # noqa: E402

torch.set_num_threads(TORCH_THREADS)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("opt_mapqv")
    contigs = random_genome(30_000, seed=55)
    g = contigs[0].seq.copy()
    g[20000:21500] = g[5000:6500]  # two-copy repeat
    write_fasta(d / "g.fa", [FastaRecord("contig0", g)])
    write_fasta(d / "r.fa", [FastaRecord("rep/1/0_450",
                                         g[5100:5550].copy())])
    return d


def test_no_store_mapqv_print_only_best_match_jax(world):
    d = world
    text = cli_both([str(d / "r.fa"), str(d / "g.fa"), "-m", "4",
                     "--noStoreMapQV", "--printOnlyBest"], d / "o.m4")
    lines = text.splitlines()
    assert len(lines) == 1 and int(lines[0].split()[-1]) == 254

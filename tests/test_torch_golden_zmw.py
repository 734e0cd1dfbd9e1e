"""Concordant mapping through the PyTorch port on the CPU: golden.m4.concordant
byte for byte through the CLI (each ZMW's median interior subread mapped
as the template, the other subreads re-aligned to its flanked windows on
a padded mini index that the port's Mapper uploads to its own device),
and the mini index's power-of-two tiers identical to the JAX package's
(tests/test_zmw.py's tiering case)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from blasr_tpu.index.genome import build_genome_index  # noqa: E402
from blasr_tpu.io.fasta import FastaRecord  # noqa: E402
from blasr_tpu.pipeline.zmw import _pad_mini_index  # noqa: E402
from blasr_tpu_torch.pipeline import zmw as tzmw  # noqa: E402
from test_torch_golden_qv import port_reproduces_golden_case  # noqa: E402
from torch_shared import TORCH_THREADS  # noqa: E402

torch.set_num_threads(TORCH_THREADS)


def test_port_cli_reproduces_concordant_golden(tmp_path_factory):
    port_reproduces_golden_case(tmp_path_factory, "m4.concordant")


def test_mini_index_tiers_match_jax():
    from blasr_tpu_torch.index.genome import \
        build_genome_index as port_build_genome_index
    rng = np.random.default_rng(3)

    def windows(total, n):
        return [FastaRecord(f"w{i}", rng.integers(0, 4, total // n,
                                                  dtype=np.int8))
                for i in range(n)]

    tiers = set()
    for total, n in ((5000, 3), (7000, 5), (9000, 9)):
        recs = windows(total, n)
        want = _pad_mini_index(build_genome_index(recs, k=12))
        got = tzmw._pad_mini_index(port_build_genome_index(recs, k=12))
        for f in ("genome", "keys_sorted", "pos_sorted", "bucket_starts"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
        assert got.synthetic_kmer_rows and want.synthetic_kmer_rows
        assert got.seqdb.names == want.seqdb.names
        np.testing.assert_array_equal(got.seqdb.starts, want.seqdb.starts)
        np.testing.assert_array_equal(got.seqdb.lengths, want.seqdb.lengths)
        tiers.add((len(got.genome), len(got.keys_sorted),
                   got.seqdb.n_contigs))
    # the first two window sets share one tier, the third needs the next
    assert len(tiers) == 2

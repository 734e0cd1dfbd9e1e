"""Host-only CLI flags of tests/test_cli_features.py and
tests/test_mapqv_parity.py:152 through the JAX CLI and the PyTorch
port's (``--device cpu``) on the CPU, on test_cli_features.py's world
(60 kb, two contigs, its title table): one run per output format and
input, byte-identical in the two packages (SAM without its @PG line),
and each flag's mark asserted in that output.

* m4, FASTQ (test_min_avg_qual_gate's two reads, QV 30 and QV 5):
  ``--minAvgQual 10`` drops the QV 5 read, ``--titleTable`` prints the
  target as its index in the table.
* SAM, a bax.h5 ZMW with QV tracks (test_samqv_subset_tags', its read
  given ten substitutions): ``--printSAMQV`` prints the iq/dq tags,
  ``--cigarUseSeqMatch`` writes '='/'X' and no 'M'; then ``--samQV
  InsertionQV`` prints iq and no dq, and ``--useQuality --scoreType 1``
  (test_score_type_1_reports_qv_sum_score) reports the QV DP's own score
  as AS, not the distance rescore of its path that ``--scoreType 0``
  reports (computed here from the CIGAR and NM)."""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("h5py")

from blasr_tpu.io.fasta import FastaRecord, write_fasta  # noqa: E402
from blasr_tpu.io.hdf import ZmwRead, write_bax  # noqa: E402
from blasr_tpu.sim import random_genome  # noqa: E402
from torch_options import cli_both  # noqa: E402
from torch_shared import TORCH_THREADS  # noqa: E402

torch.set_num_threads(TORCH_THREADS)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """test_cli_features.py's genome and title table, the two FASTQ reads
    of test_min_avg_qual_gate and the bax.h5 of test_samqv_subset_tags."""
    d = tmp_path_factory.mktemp("opt_cli")
    contigs = random_genome(60_000, seed=61, n_contigs=2)
    write_fasta(d / "genome.fa", contigs)
    (d / "titles.txt").write_text(
        "\n".join(c.name for c in contigs) + "\n")
    g = contigs[0].seq
    recs = [FastaRecord("m/0/0_400", g[1000:1400].copy(),
                        np.full(400, 30, np.int32)),
            FastaRecord("m/1/0_400", g[3000:3400].copy(),
                        np.full(400, 5, np.int32))]
    with open(d / "r.fq", "w") as f:
        for r in recs:
            f.write(f"@{r.name}\n" + "".join("ACGTN"[c] for c in r.seq)
                    + "\n+\n" + "".join(chr(q + 33) for q in r.qual) + "\n")
    rng = np.random.default_rng(5)
    seq = g[2000:2500].copy()
    seq[25::50] = (seq[25::50] + 1) % 4
    tracks = {n: rng.integers(5, 40, len(seq)).astype(np.uint8)
              for n in ("QualityValue", "InsertionQV", "DeletionQV",
                        "SubstitutionQV")}
    regions = [[7, 1, 0, len(seq), 900], [7, 2, 0, len(seq), 900]]
    write_bax(str(d / "m1.bax.h5"), "m1", [ZmwRead(7, seq, tracks)],
              np.asarray(regions, np.int32))
    return d


def test_m4_host_flags_match_jax(world):
    d = world
    text = cli_both([str(d / "r.fq"), str(d / "genome.fa"), "-m", "4",
                     "--minAvgQual", "10", "--titleTable",
                     str(d / "titles.txt")], d / "o.m4")
    lines = [line.split() for line in text.splitlines()]
    assert lines and {f[0].split("/")[1] for f in lines} == {"0"}
    assert {f[1] for f in lines} <= {"0", "1"}


@pytest.mark.parametrize("flags,tags,no_tags", [
    (["--printSAMQV", "--cigarUseSeqMatch", "--clipping", "soft"],
     ["iq:Z:", "dq:Z:"], []),
    (["--samQV", "InsertionQV", "--useQuality", "--scoreType", "1"],
     ["iq:Z:"], ["dq:Z:"]),
], ids=["printSAMQV-cigarUseSeqMatch", "samQV-scoreType1"])
def test_sam_host_flags_match_jax(world, flags, tags, no_tags):
    d = world
    text = cli_both([str(d / "m1.bax.h5"), str(d / "genome.fa"), "--sam",
                     "--minReadLength", "50"] + flags, d / "o.sam")
    recs = [line for line in text.splitlines() if not line.startswith("@")]
    assert recs
    for rec in recs:
        assert all(t in rec for t in tags)
        assert not any(t in rec for t in no_tags)
        f = rec.split("\t")
        if "--cigarUseSeqMatch" in flags:
            assert "M" not in f[5] and "=" in f[5] and "X" in f[5]
        if "--scoreType" in flags:
            assert int(tag(f, "AS:i:")) != distance_score(f[5],
                                                          int(tag(f, "NM:i:")))


def tag(fields, name):
    return next(x[len(name):] for x in fields if x.startswith(name))


def distance_score(cigar, nm):
    """The default matrix's score of a SAM record's path (-5 a match, 6 a
    mismatch, --indel 5 a gap base): what --scoreType 0 reports."""
    ops = re.findall(r"(\d+)([MIDS=X])", cigar)
    n = {op: sum(int(k) for k, o in ops if o == op) for op in "MID"}
    n_mm = nm - n["I"] - n["D"]
    return -5 * (n["M"] - n_mm) + 6 * n_mm + 5 * (n["I"] + n["D"])

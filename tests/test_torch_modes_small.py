"""--bam and the debug dumps (--anchors, --clusters, --printDotPlots)
through the PyTorch port's CLI on the CPU against the JAX package's, on
tests/test_golden.py's small world, in one run of each CLI: the BAM
files, decoded by the port's io/bam.py, carry the same header without
@PG and the same records; the port's records decode to golden.sam (the
port's own SAM output of the same flags, which test_torch_golden.py holds
to that golden); every dump file is identical."""

import os

import pytest

torch = pytest.importorskip("torch")

from blasr_tpu.cli.blasr import run as jax_run  # noqa: E402
from blasr_tpu_torch.cli.blasr import run as port_run  # noqa: E402
from blasr_tpu_torch.io.bam import read_bam  # noqa: E402
from blasr_tpu_torch.io.fasta import decode  # noqa: E402
from test_golden import GOLDEN_DIR, make_small  # noqa: E402

torch.set_num_threads(2)

DUMPS = ("anchors.txt", "clusters.txt")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"jax": dir, "port": dir}: each CLI's outputs (out.bam, the two
    dump files and the per-read .anchors files of --printDotPlots, which
    the CLI writes to its working directory)."""
    root = tmp_path_factory.mktemp("torch_modes_small")
    reads, genome, _ = make_small(str(root))
    out = {}
    cwd = os.getcwd()
    for side, run, extra in (("jax", jax_run, []),
                             ("port", port_run, ["--device", "cpu"])):
        d = root / side
        d.mkdir()
        os.chdir(d)
        try:
            assert run([reads, genome, "--bam", "--clipping", "soft",
                        "--out", "out.bam", "--anchors", DUMPS[0],
                        "--clusters", DUMPS[1], "--printDotPlots"]
                       + extra) == 0
        finally:
            os.chdir(cwd)
        out[side] = d
    return out


def test_port_bam_matches_jax(runs):
    jtext, jnames, jlens, jrecs = read_bam(str(runs["jax"] / "out.bam"))
    ptext, pnames, plens, precs = read_bam(str(runs["port"] / "out.bam"))

    def no_pg(text):
        return [l for l in text.splitlines() if not l.startswith("@PG")]

    assert no_pg(ptext) == no_pg(jtext)
    assert any(l.startswith("@RG") for l in no_pg(ptext))
    assert (pnames, plens) == (jnames, jlens)
    assert len(precs) == len(jrecs) > 0
    for p, j in zip(precs, jrecs):
        for f in ("qname", "flag", "ref_id", "pos", "mapq", "cigar", "tags",
                  "next_ref_id", "next_pos"):
            assert getattr(p, f) == getattr(j, f), (p.qname, f)
        assert decode(p.seq) == decode(j.seq)
        assert (p.qual is None) == (j.qual is None)
        if p.qual is not None:
            assert list(p.qual) == list(j.qual)


def test_port_bam_decodes_to_sam(runs):
    _, names, _, recs = read_bam(str(runs["port"] / "out.bam"))
    sam = [l.rstrip("\n").split("\t")
           for l in open(os.path.join(GOLDEN_DIR, "golden.sam"))
           if not l.startswith("@")]
    assert len(recs) == len(sam)
    for b, s in zip(recs, sam):
        assert b.qname == s[0] and b.flag == int(s[1])
        assert names[b.ref_id] == s[2] and b.pos + 1 == int(s[3])
        assert b.mapq == int(s[4])
        assert "".join(f"{n}{op}" for op, n in b.cigar) == s[5]
        assert decode(b.seq) == s[9]


@pytest.mark.parametrize("dump", ["anchors", "clusters", "printDotPlots"])
def test_port_dumps_match_jax(runs, dump):
    if dump == "printDotPlots":
        names = sorted(f for f in os.listdir(runs["jax"])
                       if f.endswith(".anchors"))
        assert len(names) == 12
        assert sorted(f for f in os.listdir(runs["port"])
                      if f.endswith(".anchors")) == names
    else:
        names = [f"{dump}.txt"]
    for name in names:
        want = (runs["jax"] / name).read_text()
        assert want.count("\n") > 1
        assert (runs["port"] / name).read_text() == want, name

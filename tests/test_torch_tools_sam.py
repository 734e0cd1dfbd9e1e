"""The PyTorch port's SAM tools (``blasr_tpu_torch/cli/sam_to_m4.py``,
``cli/sam_filter.py`` and ``io/samparse.py``) against the JAX package's
on the CPU.

The inputs are the checked-in goldens: golden.sam and golden.sam.subread
(tests/test_golden.py's small world, whose genome the fixture writes) and
golden.sam.fastq (the FASTQ world's genome), plus ``merged.sam``:
golden.sam's records, each followed by a second hit of the same read
5 kb further along its contig, its AS score 100 better for odd hole
numbers and 500 worse for even ones, so that the hit policies and
``--bestn`` have two hits of different scores to choose between.  No
mapping runs.
Each tool of both packages reads the same bytes; the output files and the
stdout must be byte-identical, and the parsed alignments equal field by
field."""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_golden import GOLDEN_DIR, make_fastq, make_small  # noqa: E402

PACKAGES = ("blasr_tpu", "blasr_tpu_torch")


def tool(package, name):
    import importlib
    return importlib.import_module(f"{package}.cli.{name}").run


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The genomes of the golden SAM files and the merged SAM."""
    d = tmp_path_factory.mktemp("tools_sam")
    make_small(str(d))
    make_fastq(str(d))
    merged = []
    for ln in open(os.path.join(GOLDEN_DIR, "golden.sam")).read().splitlines():
        merged.append(ln)
        if ln.startswith("@"):
            continue
        f = ln.split("\t")
        f[3] = str(int(f[3]) + 5000)
        hole = int(f[0].split("/")[1])
        f = [f"AS:i:{int(x[5:]) + (-100 if hole % 2 else 500)}"
             if x.startswith("AS:i:") else x for x in f]
        merged.append("\t".join(f))
    (d / "merged.sam").write_text("\n".join(merged) + "\n")
    return d


def sam_path(world, name):
    return (str(world / name) if name == "merged.sam"
            else os.path.join(GOLDEN_DIR, name))


GENOME = {"golden.sam": "genome.fa", "golden.sam.subread": "genome.fa",
          "golden.sam.fastq": "genome_fq.fa", "merged.sam": "genome.fa"}

# (id, tool, input SAM, argv after the inputs with {out} the package's
# output file)
CASES = [
    ("m4", "sam_to_m4", "golden.sam", ["{out}"]),
    ("m4-subread", "sam_to_m4", "golden.sam.subread", ["{out}"]),
    ("m4-fastq", "sam_to_m4", "golden.sam.fastq", ["{out}", "--header"]),
    ("m4-merged-short", "sam_to_m4", "merged.sam",
     ["{out}", "--useShortRefName"]),
    ("filter", "sam_filter", "golden.sam", ["{out}"]),
    ("filter-ref-form", "sam_filter", "golden.sam.fastq",
     ["{genome}", "{out}", "--minAccuracy", "85"]),
    ("filter-allbest", "sam_filter", "merged.sam",
     ["{out}", "--hitPolicy", "allbest"]),
    ("filter-bestn", "sam_filter", "merged.sam", ["{out}", "--bestn", "1"]),
    ("filter-randombest", "sam_filter", "merged.sam",
     ["{out}", "--hitPolicy", "randombest", "--seed", "3", "-smrtTitle"]),
    ("filter-leftmost", "sam_filter", "merged.sam",
     ["{out}", "--hitPolicy", "leftmost", "--minLength", "300"]),
    ("filter-holes", "sam_filter", "merged.sam",
     ["{out}", "-holeNumbers", "1,3-6,10"]),
    ("filter-holes-subread", "sam_filter", "golden.sam.subread",
     ["{out}", "-holeNumbers", "0-4", "--minPctSimilarity", "80",
      "--scoreCutoff", "-1000"]),
    ("filter-titles", "sam_filter", "golden.sam",
     ["{out}", "-titleTable", "{titles}", "-v"]),
]


@pytest.mark.parametrize("name,fn,sam,argv", CASES,
                         ids=[c[0] for c in CASES])
def test_sam_tool_matches_jax(world, capsys, name, fn, sam, argv):
    (world / "titles.txt").write_text("contig1\ncontig0\n")
    outs = {}
    for package in PACKAGES:
        out = str(world / f"{name}.{package}.out")
        genome = str(world / GENOME[sam])
        args = [a.format(out=out, genome=genome,
                         titles=world / "titles.txt") for a in argv]
        first = [sam_path(world, sam)]
        if fn == "sam_to_m4":
            first.append(genome)
        capsys.readouterr()
        assert tool(package, fn)(first + args) == 0
        io = capsys.readouterr()
        outs[package] = (open(out, "rb").read(), io.out, io.err)
    assert outs["blasr_tpu"][0]
    assert outs["blasr_tpu_torch"] == outs["blasr_tpu"]


def same_alignment(a, b):
    assert type(a).__name__ == type(b).__name__ == "Alignment"
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y), f.name
        else:
            assert x == y, f.name


@pytest.mark.parametrize("sam", sorted(GENOME))
def test_read_and_iter_sam_match_jax(world, sam):
    import importlib
    path = sam_path(world, sam)
    got = {}
    for package in PACKAGES:
        sp = importlib.import_module(f"{package}.io.samparse")
        header, alns = sp.read_sam(path)
        lengths = {"contig0": 7}
        with open(path) as f:
            streamed = list(sp.iter_sam(f, lengths))
        got[package] = (header, alns, streamed, lengths)
    (h0, a0, s0, l0), (h1, a1, s1, l1) = (got[p] for p in PACKAGES)
    assert h1 == h0 and l1 == l0 and len(a0) > 0
    assert len(a1) == len(a0) and len(s1) == len(s0) == len(a0)
    for x, y in zip(a0 + s0, a1 + s1):
        same_alignment(x, y)

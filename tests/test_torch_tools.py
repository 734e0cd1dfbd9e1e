"""The PyTorch port's index and FASTA tools (``blasr_tpu_torch/cli/``
sawriter, sa2bwt, bwt2sa and small_tools) against the JAX package's on
the CPU, then the mapper on the port's own indexes.

* On tests/test_small_tools.py's world (8 kb, two contigs, seed 81) each
  tool of both packages runs on the same input files (the JAX tools'
  outputs where a tool reads an index): every output file and the
  stdout are byte-identical; ``.npz`` outputs are compared array by
  array, by name (the zip members carry their write times).
* On tests/test_tools.py's world (60 kb, eight reads) the port's
  ``sawriter --fullSuffixArray`` index feeds the port's CLI through
  ``--sa``, and the port's sawriter -> sa2bwt pair feeds it through
  ``--bwt``; each m4 is byte-identical to the JAX CLI's on the JAX tools'
  index.
* On the small golden world the port's sawriter -> sa2bwt index,
  mapped by the port's CLI through ``--bwt``, reproduces
  golden.m4.bwt, as tests/test_golden.py::make_small_bwt builds it with
  the JAX tools."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from blasr_tpu.io.fasta import write_fasta  # noqa: E402
from blasr_tpu.sim import random_genome, simulate_reads  # noqa: E402
from test_golden import GOLDEN_DIR, make_small  # noqa: E402
from torch_shared import TORCH_THREADS  # noqa: E402

torch.set_num_threads(TORCH_THREADS)

PACKAGES = ("blasr_tpu", "blasr_tpu_torch")


def tool(package, name):
    """``run`` of cli/<name>.py, or small_tools.<name>, of ``package``."""
    import importlib
    if name.startswith("run_"):
        return getattr(importlib.import_module(
            f"{package}.cli.small_tools"), name)
    return importlib.import_module(f"{package}.cli.{name}").run


def same_output(a, b):
    if a.endswith(".npz"):
        za, zb = np.load(a), np.load(b)
        assert sorted(za.files) == sorted(zb.files)
        for k in za.files:
            assert za[k].dtype == zb[k].dtype, k
            assert np.array_equal(za[k], zb[k]), k
    else:
        assert open(a, "rb").read() == open(b, "rb").read(), a


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """test_small_tools.py's genome, a RepeatMasker .out over it, and the
    JAX tools' indexes that the other tools read."""
    d = tmp_path_factory.mktemp("tools_small")
    write_fasta(d / "g.fa", random_genome(8000, seed=81, n_contigs=2))
    (d / "rep.out").write_text(
        "header\nheader\n\n"
        "100 1.0 0.0 0.0 contig0 100 200 x + rep cls 1 2 3 1\n"
        "100 1.0 0.0 0.0 contig0 500 600 x + rep cls 1 2 3 2\n")
    g = str(d / "g.fa")
    run = {name: tool("blasr_tpu", name)
           for name in ("sawriter", "sa2bwt")}
    assert run["sawriter"]([str(d / "in.sa"), g, "--fullSuffixArray"]) == 0
    assert run["sawriter"]([str(d / "in.ref.sa"), g, "--saFormat", "ref",
                            "-blt", "6"]) == 0
    assert run["sa2bwt"]([g, str(d / "in.sa.npz"),
                          str(d / "in.bwt.npz")]) == 0
    assert run["sa2bwt"]([g, str(d / "in.ref.sa"), str(d / "in.bwt")]) == 0
    return d


# (id, tool, argv with {g} the genome, {in} the input folder and {out}
# the package's output folder, the outputs written under {out})
CASES = [
    ("sawriter", "sawriter", ["{out}/g.sa", "{g}"], ["g.sa.npz"]),
    ("sawriter-full", "sawriter", ["{out}/g.sa", "{g}",
                                   "--fullSuffixArray", "-kmer", "10"],
     ["g.sa.npz"]),
    ("sawriter-ref", "sawriter", ["{out}/g.sa", "{g}", "--saFormat", "ref",
                                  "-blt", "6"], ["g.sa"]),
    ("sa2bwt", "sa2bwt", ["{g}", "{in}/in.sa.npz", "{out}/g.bwt.npz"],
     ["g.bwt.npz"]),
    ("sa2bwt-ref", "sa2bwt", ["{g}", "{in}/in.ref.sa", "{out}/g.bwt"],
     ["g.bwt"]),
    ("bwt2sa", "bwt2sa", ["{in}/in.bwt.npz", "{out}/g.sa.npz"],
     ["g.sa.npz"]),
    ("bwt2sa-ref", "bwt2sa", ["{in}/in.bwt", "{out}/g.sa"], ["g.sa"]),
    ("toAfg", "run_to_afg", ["{g}", "{out}/g.afg", "-uniformQV", "15"],
     ["g.afg"]),
    ("toAfg-stdout", "run_to_afg", ["{g}", "-"], []),
    ("printTupleCountTable", "run_print_tuple_count_table",
     ["{out}/g.ctab", "{g}", "-wordsize", "6"], ["g.ctab"]),
    ("printTupleCountTable-npz", "run_print_tuple_count_table",
     ["{out}/g.ctab.npz", "{g}", "-wordsize", "6"], ["g.ctab.npz"]),
    ("sals", "run_sals", ["{in}/in.sa.npz"], []),
    ("sals-ref", "run_sals", ["{in}/in.ref.sa"], []),
    ("samodify", "run_samodify", ["{in}/in.sa.npz", "{g}", "{out}/m.sa",
                                  "-blt", "10"], ["m.sa.npz"]),
    ("samodify-ref", "run_samodify", ["{in}/in.ref.sa", "{g}",
                                      "{out}/m.sa", "-blt", "8"], ["m.sa"]),
    ("evolve", "run_evolve", ["{g}", "{out}/mut.fa", "-sub", "0.02", "-ins",
                              "0.01", "-del", "0.01", "-gff",
                              "{out}/vars.gff", "-seed", "3"],
     ["mut.fa", "vars.gff"]),
    ("exciseRepeats", "run_excise_repeats",
     ["{g}", "{in}/rep.out", "{out}/ex.fa"], ["ex.fa"]),
    ("simpleShredder", "run_simple_shredder",
     ["{g}", "-readsFile", "{out}/shred.fq", "-readLength", "150",
      "-nReads", "20", "-fastq", "-nonRandInit"], ["shred.fq"]),
    ("simpleShredder-stratify", "run_simple_shredder",
     ["{g}", "-readsFile", "{out}/strat.fa", "-readLength", "100",
      "-stratify", "1000", "-nonRandInit"], ["strat.fa"]),
    ("bsdb", "run_bsdb", ["{g}", "{out}/db"], ["db.npz"]),
]


@pytest.mark.parametrize("name,fn,argv,outputs", CASES,
                         ids=[c[0] for c in CASES])
def test_tool_matches_jax(small, capsys, name, fn, argv, outputs):
    stdout = {}
    for package in PACKAGES:
        out = small / name / package
        out.mkdir(parents=True)
        args = [a.format(g=small / "g.fa", out=out, **{"in": small})
                for a in argv]
        capsys.readouterr()
        assert tool(package, fn)(args) == 0
        stdout[package] = capsys.readouterr().out
    assert stdout["blasr_tpu_torch"] == stdout["blasr_tpu"]
    if not outputs:
        assert stdout["blasr_tpu"]
    for f in outputs:
        same_output(str(small / name / "blasr_tpu" / f),
                    str(small / name / "blasr_tpu_torch" / f))


def build_index(package, d, genome, kind):
    """``--sa`` or ``--bwt`` and the index that ``package``'s sawriter
    (then sa2bwt) build from ``genome`` into folder ``d``."""
    d.mkdir(exist_ok=True)
    sa = str(d / "genome.sa.npz")
    assert tool(package, "sawriter")([sa, genome, "--fullSuffixArray"]) == 0
    if kind == "--sa":
        return [kind, sa]
    bwt = str(d / "genome.bwt.npz")
    assert tool(package, "sa2bwt")([genome, sa, bwt]) == 0
    return [kind, bwt]


@pytest.fixture(scope="module")
def mapped(tmp_path_factory):
    """test_tools.py's world."""
    d = tmp_path_factory.mktemp("tools_map")
    contigs = random_genome(60_000, seed=51, n_contigs=2)
    sims = simulate_reads(contigs, 8, read_len=(300, 700), accuracy=0.88,
                          seed=52)
    write_fasta(d / "genome.fa", contigs)
    write_fasta(d / "reads.fa", [s.rec for s in sims])
    return d


@pytest.mark.parametrize("kind", ["--sa", "--bwt"])
def test_port_index_maps_as_jax(mapped, kind):
    from blasr_tpu.cli.blasr import run as jax_run
    from blasr_tpu_torch.cli.blasr import run as port_run
    d = mapped
    genome, reads = str(d / "genome.fa"), str(d / "reads.fa")
    out = {}
    for package, run, dev in (("blasr_tpu", jax_run, []),
                              ("blasr_tpu_torch", port_run,
                               ["--device", "cpu"])):
        idx = build_index(package, d / f"{package}{kind}", genome, kind)
        path = str(d / f"{package}{kind}.m4")
        assert run([reads, genome, "-m", "4", "--out", path]
                   + idx + dev) == 0
        out[package] = open(path).read()
    assert out["blasr_tpu"] and out["blasr_tpu_torch"] == out["blasr_tpu"]


def test_port_bwt_reproduces_golden(tmp_path):
    from blasr_tpu_torch.cli.blasr import run
    reads, genome, _ = make_small(str(tmp_path))
    idx = build_index("blasr_tpu_torch", tmp_path / "idx", genome, "--bwt")
    out = str(tmp_path / "out.m4")
    assert run([reads, genome, "-m", "4", "--out", out, "--device", "cpu"]
               + idx) == 0
    assert open(out).read() == \
        open(os.path.join(GOLDEN_DIR, "golden.m4.bwt")).read()

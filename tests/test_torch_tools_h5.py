"""The PyTorch port's HDF5 and BAM tools (``blasr_tpu_torch/cli/``
pls2fasta, bax2bam, bam2bax, sam_to_h5, load_pulses and
cmph5_store_quality_by_context, on ``io/cmph5.py``) against the JAX
package's on the CPU.

tests/test_hdf.py's bax world (three ZMWs of two subreads each) is built
once per test run, with the SAM of its subreads mapped once by the JAX CLI
(test_hdf.py:186's command); tests/test_hdf.py:254's one-ZMW movie with
adapter and low-quality scraps beside it.  Each tool of both packages runs
on the same input files: FASTA/FASTQ and text outputs and the BAM files
byte for byte, the bax.h5 and cmp.h5 outputs dataset by dataset and
attribute by attribute (an HDF5 file's bytes carry its write times)."""

import shutil
from pathlib import Path

import numpy as np
import pytest

h5py = pytest.importorskip("h5py")
torch = pytest.importorskip("torch")

from blasr_tpu.io.hdf import REGION_TYPES, ZmwRead, write_bax  # noqa: E402
from test_hdf import bax_world  # noqa: E402,F401  (the module fixture)
from torch_shared import shared  # noqa: E402

PACKAGES = ("blasr_tpu", "blasr_tpu_torch")


def tool(package, name):
    import importlib
    return importlib.import_module(f"{package}.cli.{name}").run


def h5_tree(path) -> dict:
    """Every dataset's array and every attribute of a file, by path."""
    out = {}
    with h5py.File(path, "r") as f:
        def visit(name, obj):
            for k, v in obj.attrs.items():
                out[f"{name}@{k}"] = np.asarray(v)
            if isinstance(obj, h5py.Dataset):
                out[name] = np.asarray(obj[()])
        for k, v in f.attrs.items():
            out[f"@{k}"] = np.asarray(v)
        f.visititems(visit)
    return out


def same_h5(a, b):
    ta, tb = h5_tree(a), h5_tree(b)
    assert sorted(ta) == sorted(tb)
    assert ta
    for k in ta:
        assert ta[k].dtype == tb[k].dtype, k
        assert ta[k].shape == tb[k].shape, k
        assert np.array_equal(ta[k], tb[k]), k


def same_bytes(a, b):
    x, y = open(a, "rb").read(), open(b, "rb").read()
    assert x and x == y, a


@pytest.fixture(scope="module")
def world(bax_world, tmp_path_factory):
    """``build_world`` on this worker's bax_world, built once per test run
    (tests/torch_shared.py; bax_world is the same files on every
    worker)."""
    return shared(tmp_path_factory, __file__, "world",
                  lambda d: build_world(d, bax_world))


def build_world(d, bax_world):
    """bax_world's movie and genome copied into ``d``, the JAX CLI's SAM
    of it, and the scraps movie."""
    from blasr_tpu.cli.blasr import run as blasr_run
    src, path, _, _ = bax_world
    shutil.copy(src / "genome.fa", d / "genome.fa")
    path = Path(shutil.copy(path, d / path.name))
    sam = d / "out.sam"
    assert blasr_run([str(path), str(d / "genome.fa"), "--sam",
                      "--clipping", "soft", "--minReadLength", "50",
                      "--out", str(sam)]) == 0
    e = d / "scraps"
    e.mkdir()
    ins, ada, hq = (REGION_TYPES.index(x)
                    for x in ("Insert", "Adapter", "HQRegion"))
    rng = np.random.default_rng(81)
    parts = [rng.integers(0, 4, n).astype(np.int8)
             for n in (30, 180, 45, 220, 25)]
    seq = np.concatenate(parts)
    n = len(seq)
    a0 = 30 + 180
    rows = [[12, ins, 30, a0, -1], [12, ada, a0, a0 + 45, -1],
            [12, ins, a0 + 45, a0 + 45 + 220, -1], [12, hq, 30, n - 25, 760]]
    tracks = {
        "QualityValue": rng.integers(10, 40, n).astype(np.uint8),
        "InsertionQV": rng.integers(5, 30, n).astype(np.uint8),
        "DeletionTag": np.full(n, ord("N"), np.uint8),
    }
    scraps = e / "m_scr.bax.h5"
    write_bax(str(scraps), "m_scr", [ZmwRead(12, seq, tracks)],
              np.asarray(rows, np.int32))
    return d, path, sam, scraps


PLS_CASES = [
    ("fastq", ["-trimByRegion", "-fastq"], "reads.fq"),
    ("hole", ["-trimByRegion", "-holeNumber", "17"], "r.fa"),
    ("mask", ["-maskByRegion"], "m.fa"),
    ("nosplit", ["-noSplitSubreads", "-minSubreadLength", "300"], "n.fa"),
]


@pytest.mark.parametrize("name,flags,out", PLS_CASES,
                         ids=[c[0] for c in PLS_CASES])
def test_pls2fasta_matches_jax(world, tmp_path, name, flags, out):
    d, path, _, _ = world
    for package in PACKAGES:
        (tmp_path / package).mkdir()
        assert tool(package, "pls2fasta")(
            [str(path), str(tmp_path / package / out)] + flags) == 0
    same_bytes(tmp_path / "blasr_tpu" / out,
               tmp_path / "blasr_tpu_torch" / out)


@pytest.mark.parametrize("movie", ["bax", "scraps"])
def test_bax2bam_bam2bax_match_jax(world, tmp_path, movie):
    """bax2bam of the movie (subreads, and scraps where the movie has
    them), then bam2bax of every BAM written, by each package."""
    d, path, _, scraps = world
    src = path if movie == "bax" else scraps
    bams = {}
    for package in PACKAGES:
        pre = str(tmp_path / package / "rt")
        (tmp_path / package).mkdir()
        assert tool(package, "bax2bam")([str(src), "-o", pre]) == 0
        outs = [pre + ".subreads.bam"]
        if movie == "scraps":
            outs.append(pre + ".scraps.bam")
        assert tool(package, "bam2bax")(outs + ["-o", pre]) == 0
        bams[package] = outs + [pre + ".bax.h5"]
    for a, b in zip(bams["blasr_tpu"], bams["blasr_tpu_torch"]):
        if a.endswith(".h5"):
            same_h5(a, b)
        else:
            same_bytes(a, b)


def test_samtoh5_loadpulses_context_match_jax(world, tmp_path):
    """test_hdf.py:186 and :216 through each package: samtoh5 (-smrtTitle
    and -useShortRefName), loadPulses with its default metrics and with
    the frame and pulse metrics, the refused metric, and
    cmpH5StoreQualityByContext at context lengths 3 and 1."""
    d, path, sam, _ = world
    genome = str(d / "genome.fa")
    metrics = "QualityValue,PulseWidth,IPD,StartFrame,pkmid,WidthInFrames"
    files = {}
    for package in PACKAGES:
        o = tmp_path / package
        o.mkdir()
        run = {n: tool(package, n) for n in (
            "sam_to_h5", "load_pulses", "cmph5_store_quality_by_context")}
        a, b = str(o / "a.cmp.h5"), str(o / "b.cmp.h5")
        assert run["sam_to_h5"]([str(sam), genome, a, "-smrtTitle"]) == 0
        assert run["sam_to_h5"]([str(sam), genome, b, "-smrtTitle",
                                 "-useShortRefName"]) == 0
        assert run["load_pulses"]([str(path), a]) == 0
        assert run["load_pulses"]([str(path), b, "-metrics", metrics]) == 0
        assert run["load_pulses"]([str(path), b,
                                   "-metrics", "NotAMetric"]) == 1
        t3, t1 = str(o / "ctx3.txt"), str(o / "ctx1.txt")
        run_ctx = run["cmph5_store_quality_by_context"]
        assert run_ctx([a, t3]) == 0
        assert run_ctx([b, t1, "-contextLength", "1"]) == 0
        files[package] = (a, b, t3, t1)
    for x, y in zip(files["blasr_tpu"], files["blasr_tpu_torch"]):
        if x.endswith(".h5"):
            same_h5(x, y)
        else:
            same_bytes(x, y)

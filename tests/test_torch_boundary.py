"""Guards on the PyTorch port's import boundary.

* With JAX and the JAX package ``blasr_tpu`` blocked (the port imports
  neither), every ``blasr_tpu_torch`` module imports and the CLI maps a
  tiny world on the CPU, with and without ``--useQuality``.
* Every module, function and class the port copied from ``blasr_tpu``
  (params, sim, the io and index modules, the native helpers, the host
  half of map_read, metrics, scoring, select, longread, extend, onegap,
  zmw, the multihost helpers, formats) matches its original by
  ``ast.dump``, module names normalized; the differences the port needs
  are listed below.
* Flags outside the ported slice (``--affineAlign``) are refused, never
  run on another path; the other mapping modes' flags are accepted.
"""

import ast
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (port module, original module, names copied from it); "module" compares
# the whole module, None every top-level function and class
COPIES = [
    ("params.py", "params.py", "module"),
    ("sim.py", "sim.py", "module"),
    ("io/fasta.py", "io/fasta.py", "module"),
    ("io/fofn.py", "io/fofn.py", "module"),
    ("io/bam.py", "io/bam.py", "module"),
    ("io/bgzf.py", "io/bgzf.py", "module"),
    ("io/hdf.py", "io/hdf.py", "module"),
    ("io/dataset.py", "io/dataset.py", "module"),
    ("io/refsa.py", "io/refsa.py", "module"),
    ("io/refbin.py", "io/refbin.py", "module"),
    ("index/genome.py", "index/genome.py", "module"),
    ("index/suffix_array.py", "index/suffix_array.py", "module"),
    ("index/bwt.py", "index/bwt.py", "module"),
    # the build differs (get_lib / _build): into build/blasr_tpu_torch/
    ("native/__init__.py", "native/__init__.py",
     ["sais_native", "cigar_native", "cigar_native_batch", "runs_to_list",
      "bwt_invert_native"]),
    ("cli/bwt2sa.py", "cli/bwt2sa.py", ["contigs_from_concat"]),
    ("cli/small_tools.py", "cli/small_tools.py", ["load_ctab"]),
    ("pipeline/map_read.py", "pipeline/map_read.py",
     ["Alignment", "LazyCigar", "unpack_pairs", "pairs_to_cigar",
      "split_match_runs", "merge_adjacent_indels", "Mapper"]),
    ("pipeline/metrics.py", "pipeline/metrics.py", ["MappingMetrics"]),
    ("pipeline/scoring.py", "pipeline/scoring.py", None),
    ("pipeline/select.py", "pipeline/select.py", None),
    ("pipeline/zmw.py", "pipeline/zmw.py", None),
    ("pipeline/longread.py", "pipeline/longread.py", "module"),
    ("pipeline/extend.py", "pipeline/extend.py", "module"),
    ("pipeline/onegap.py", "pipeline/onegap.py", "module"),
    ("io/formats.py", "io/formats.py", None),
    ("dist/multihost.py", "dist/multihost.py",
     ["shard_reads", "shard_path"]),
]

# methods of the copied Mapper, and functions of the other copies, that
# differ on purpose:
ALLOWED = {
    # device seam: torch device + index upload, refuses the unported
    # affine / rescue-index / occ_block_sample paths
    "Mapper.__init__",
    # no use_hp / occ_block_sample kwargs
    "Mapper._batch_call_args",
    # builds the CUDA kernels instead of compiling XLA executables
    "Mapper.warmup",
    # torch uploads, no async device_put pipeline
    "Mapper._run_bucket",
    # type(self)(...) instead of Mapper(...) (sub-mappers stay on the port)
    "Mapper._expanded",
    # type(self)(...) instead of Mapper(...) (sub-mappers stay on the port)
    "Mapper.map_reads",
    # torch tensors on the Mapper's device (K5, K3), K5's pos_records, and
    # one host copy of the anchors and of the candidates per read
    "Mapper.dump_debug",
    # zmw.py: the mini-index Mapper is type(mapper)(..., device=mapper.device)
    "_map_to_template_windows",
}


def _tree(path):
    return ast.parse(open(path).read().replace("blasr_tpu_torch",
                                               "blasr_tpu"))


def _defs(path):
    out = {}
    for node in _tree(path).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out[node.name] = node
    return out


def _members(cls):
    out = {}
    for node in cls.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[f"{cls.name}.{node.name}"] = node
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            tgt = node.targets[0] if isinstance(node, ast.Assign) \
                else node.target
            out[f"{cls.name}.{ast.unparse(tgt)}"] = node
    return out


@pytest.mark.parametrize("port,orig,names", COPIES,
                         ids=[c[0] for c in COPIES])
def test_copied_code_has_not_drifted(port, orig, names):
    pp = os.path.join(ROOT, "blasr_tpu_torch", port)
    op = os.path.join(ROOT, "blasr_tpu", orig)
    if names == "module":
        assert ast.dump(_tree(pp)) == ast.dump(_tree(op)), \
            f"{port} drifted from blasr_tpu"
        return
    p, o = _defs(pp), _defs(op)
    for name in (names or list(o)):
        assert name in p, f"{name} missing from the port's {port}"
        a, b = p[name], o[name]
        if isinstance(b, ast.ClassDef) and name == "Mapper":
            pm, om = _members(a), _members(b)
            for m, node in om.items():
                assert m in pm, f"{m} missing from the port"
                same = ast.dump(pm[m]) == ast.dump(node)
                assert same or m in ALLOWED, f"{m} drifted from blasr_tpu"
            continue
        assert ast.dump(a) == ast.dump(b) or name in ALLOWED, \
            f"{name} drifted from blasr_tpu"


def test_port_runs_without_jax(tmp_path):
    """Subprocess with ``sys.modules['jax'] = sys.modules['blasr_tpu'] =
    None``: import every port module, then map a tiny world with the CLI
    on the CPU, FASTA and FASTQ ``--useQuality``."""
    code = textwrap.dedent(f"""
        import importlib, os, pkgutil, sys
        sys.modules["jax"] = None
        sys.modules["blasr_tpu"] = None
        sys.path.insert(0, {ROOT!r})
        import numpy as np
        import torch
        torch.set_num_threads(2)
        import blasr_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(
            blasr_tpu_torch.__path__, "blasr_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        from blasr_tpu_torch import native
        assert native.library_path().parent.name == "blasr_tpu_torch"
        assert native.library_path().parent.parent.name == "build"
        from blasr_tpu_torch.io.fasta import FastaRecord, decode, write_fasta
        from blasr_tpu_torch.sim import random_genome, simulate_reads
        contigs = random_genome(20_000, seed=5)
        sims = simulate_reads(contigs, 3, read_len=(300, 450),
                              accuracy=0.9, seed=6)
        d = {str(tmp_path)!r}
        write_fasta(os.path.join(d, "g.fa"), contigs)
        write_fasta(os.path.join(d, "r.fa"),
                    [FastaRecord(f"m/{{i}}/0_1", s.rec.seq)
                     for i, s in enumerate(sims)])
        rng = np.random.default_rng(7)
        with open(os.path.join(d, "r.fastq"), "w") as f:
            for i, s in enumerate(sims):
                q = rng.integers(8, 40, len(s.rec.seq))
                f.write(f"@m/{{i}}/0_1\\n{{decode(s.rec.seq)}}\\n+\\n"
                        + "".join(chr(int(x) + 33) for x in q) + "\\n")
        from blasr_tpu_torch.cli.blasr import run
        for reads, out, flags in (("r.fa", "o.m4", []),
                                  ("r.fastq", "q.m4", ["--useQuality"])):
            rc = run([os.path.join(d, reads), os.path.join(d, "g.fa"),
                      "-m", "4", "--out", os.path.join(d, out),
                      "--device", "cpu"] + flags)
            assert rc == 0, rc
        assert "jax" not in sys.modules or sys.modules["jax"] is None
        assert not [m for m in sys.modules if m.startswith("blasr_tpu.")]
        print(len(names), open(os.path.join(d, "o.m4")).read()
              + open(os.path.join(d, "q.m4")).read())
    """)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    lines = res.stdout.strip().splitlines()
    assert int(lines[0].split()[0]) >= 30          # every module imported
    assert len(lines) >= 5 and all(len(l.split()) == 13 for l in lines[1:])


@pytest.mark.parametrize("flag", [
    ["--affineAlign", "--useQuality"], ["--affineAlign"],
])
def test_unported_flags_are_refused(tmp_path, flag, capsys):
    from blasr_tpu_torch.cli.blasr import run
    assert run(["r.fa", "g.fa", "--device", "cpu"] + flag) == 1
    assert "not supported by blasr_tpu_torch" in capsys.readouterr().err


def test_use_quality_with_fasta_is_refused(tmp_path, capsys):
    """As the JAX CLI (MakeSane): --useQuality needs reads with QVs."""
    from blasr_tpu_torch.cli.blasr import run
    reads = tmp_path / "r.fa"
    reads.write_text(">m/1/0_8\nACGTACGT\n")
    assert run([str(reads), "g.fa", "--useQuality", "--device", "cpu"]) == 1
    assert "can not use -useQuality" in capsys.readouterr().err


@pytest.mark.parametrize("flag", [
    ["--bam"], ["--concordant"], ["--useccs"], ["--useccsall"],
    ["--useccsdenovo"], ["--onegap"], ["--extend"], ["--anchors", "a.txt"],
    ["--clusters", "c.txt"], ["--printDotPlots"],
])
def test_mode_flags_are_accepted(tmp_path, monkeypatch, flag):
    """The CLI's other mapping modes are accepted and run to their end on
    the port.  The read is shorter than --minReadLength, so nothing is
    aligned and the run is quick; the dumps still cover it.  The modes'
    outputs are held to the JAX package's in the test_torch_golden_* and
    test_torch_modes* files."""
    from blasr_tpu_torch.cli.blasr import run
    from blasr_tpu_torch.io.fasta import FastaRecord, write_fasta
    from blasr_tpu_torch.sim import random_genome
    contigs = random_genome(8_000, seed=8)
    monkeypatch.chdir(tmp_path)        # --printDotPlots writes here
    write_fasta("g.fa", contigs)
    write_fasta("r.fa", [FastaRecord("m/1/0_300",
                                     contigs[0].seq[1000:1300].copy())])
    assert run(["r.fa", "g.fa", "--out", "out", "--device", "cpu",
                "--minReadLength", "500"] + flag) == 0
    made = sorted(set(os.listdir(tmp_path)) - {"g.fa", "r.fa", "out"})
    want = {"--anchors": ["a.txt"], "--clusters": ["c.txt"],
            "--printDotPlots": ["m_1_0_300.anchors"]}.get(flag[0], [])
    assert made == want
    if flag == ["--bam"]:
        from blasr_tpu_torch.io.bam import read_bam
        assert read_bam("out")[3] == []
    for name in want:
        assert open(name).read().strip(), name


def test_cuda_device_without_card_raises(monkeypatch):
    from blasr_tpu_torch.cli.blasr import run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run(["r.fa", "g.fa", "-m", "4"])


def test_mapper_refuses_unported_modes():
    from blasr_tpu.index.genome import build_genome_index
    from blasr_tpu.params import MappingParams
    from blasr_tpu.sim import random_genome
    from blasr_tpu_torch.pipeline.map_read import Mapper
    gi = build_genome_index(random_genome(5_000, seed=1), k=12)
    for p in (MappingParams(affine_align=True, ignore_qualities=False),
              MappingParams(affine_align=True)):
        with pytest.raises(NotImplementedError):
            Mapper(gi, p, device="cpu")


def test_native_source_is_a_copy():
    """The port builds its host library from its own copy of sais.cpp:
    the original below a one-line header comment."""
    port = open(os.path.join(ROOT, "blasr_tpu_torch", "native",
                             "sais.cpp")).read()
    orig = open(os.path.join(ROOT, "blasr_tpu", "native", "sais.cpp")).read()
    head, body = port.split("\n", 1)
    assert head.startswith("// Copied from blasr_tpu/native/sais.cpp")
    assert body == orig

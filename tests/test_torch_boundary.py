"""Guards on the PyTorch port's import boundary.

* With JAX blocked (as on the GPU machine, which has no JAX), every
  ``blasr_tpu_torch`` module imports and the CLI maps a tiny world on the
  CPU.
* Every function and class the port copied from ``blasr_tpu`` (the host
  half of map_read, metrics, scoring, select, the zmw and multihost
  helpers, formats) matches its original by ``ast.dump``, module names
  normalized; the differences the port needs are listed below.
* Flags outside the ported slice are refused, never run on another path.
"""

import ast
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (port module, original module, names copied from it)
COPIES = [
    ("pipeline/map_read.py", "pipeline/map_read.py",
     ["Alignment", "LazyCigar", "unpack_pairs", "pairs_to_cigar",
      "split_match_runs", "merge_adjacent_indels", "Mapper"]),
    ("pipeline/metrics.py", "pipeline/metrics.py", ["MappingMetrics"]),
    ("pipeline/scoring.py", "pipeline/scoring.py", None),
    ("pipeline/select.py", "pipeline/select.py", None),
    ("pipeline/zmw.py", "pipeline/zmw.py",
     ["zmw_key", "subread_interval", "group_by_zmw"]),
    ("io/formats.py", "io/formats.py", None),
    ("dist/multihost.py", "dist/multihost.py",
     ["shard_reads", "shard_path"]),
]

# methods of the copied Mapper that differ on purpose:
ALLOWED = {
    # device seam: torch device + index upload, refuses the unported
    # QV / affine / rescue-index / occ_block_sample paths
    "Mapper.__init__",
    # no use_hp / use_qv / occ_block_sample kwargs
    "Mapper._batch_call_args",
    # builds the CUDA kernels instead of compiling XLA executables
    "Mapper.warmup",
    # torch uploads, no async device_put pipeline
    "Mapper._run_bucket",
    # type(self)(...) instead of Mapper(...) (sub-mappers stay on the port)
    "Mapper._expanded",
    # type(self)(...), and long reads / --extend raise NotImplementedError
    "Mapper.map_reads",
}
# not copied: QV packing (QV mode not ported) and the --anchors/--clusters
# debug dump
SKIPPED = {"Mapper._TAG_CODE", "Mapper._tag_codes", "Mapper.pack_qv_rows",
           "Mapper.dump_debug"}


def _defs(path):
    src = open(path).read().replace("blasr_tpu_torch", "blasr_tpu")
    out = {}
    for node in ast.parse(src).body:
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
    p = _defs(os.path.join(ROOT, "blasr_tpu_torch", port))
    o = _defs(os.path.join(ROOT, "blasr_tpu", orig))
    for name in (names or list(o)):
        assert name in p, f"{name} missing from the port's {port}"
        a, b = p[name], o[name]
        if isinstance(b, ast.ClassDef) and name == "Mapper":
            pm, om = _members(a), _members(b)
            for m, node in om.items():
                if m in SKIPPED:
                    assert m not in pm
                    continue
                assert m in pm, f"{m} missing from the port"
                same = ast.dump(pm[m]) == ast.dump(node)
                assert same or m in ALLOWED, f"{m} drifted from blasr_tpu"
            continue
        assert ast.dump(a) == ast.dump(b), f"{name} drifted from blasr_tpu"


def test_port_runs_without_jax(tmp_path):
    """Subprocess with ``sys.modules['jax'] = None``: import every port
    module, then map a tiny world with the CLI on the CPU."""
    code = textwrap.dedent(f"""
        import importlib, os, pkgutil, sys
        sys.modules["jax"] = None
        sys.path.insert(0, {ROOT!r})
        import torch
        torch.set_num_threads(2)
        import blasr_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(
            blasr_tpu_torch.__path__, "blasr_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        from blasr_tpu.io.fasta import FastaRecord, write_fasta
        from blasr_tpu.sim import random_genome, simulate_reads
        contigs = random_genome(20_000, seed=5)
        sims = simulate_reads(contigs, 3, read_len=(300, 450),
                              accuracy=0.9, seed=6)
        d = {str(tmp_path)!r}
        write_fasta(os.path.join(d, "g.fa"), contigs)
        write_fasta(os.path.join(d, "r.fa"),
                    [FastaRecord(f"m/{{i}}/0_1", s.rec.seq)
                     for i, s in enumerate(sims)])
        from blasr_tpu_torch.cli.blasr import run
        rc = run([os.path.join(d, "r.fa"), os.path.join(d, "g.fa"),
                  "-m", "4", "--out", os.path.join(d, "o.m4"),
                  "--device", "cpu"])
        assert rc == 0, rc
        assert "jax" not in sys.modules or sys.modules["jax"] is None
        print(len(names), open(os.path.join(d, "o.m4")).read())
    """)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    lines = res.stdout.strip().splitlines()
    assert int(lines[0].split()[0]) >= 15          # every module imported
    assert len(lines) >= 3 and all(len(l.split()) == 13 for l in lines[1:])


@pytest.mark.parametrize("flag", [
    ["--bam"], ["--concordant"], ["--useccs"], ["--onegap"], ["--extend"],
    ["--useQuality"], ["--affineAlign"], ["--printDotPlots"],
])
def test_unported_flags_are_refused(tmp_path, flag, capsys):
    from blasr_tpu_torch.cli.blasr import run
    assert run(["r.fa", "g.fa", "--device", "cpu"] + flag) == 1
    assert "not supported by blasr_tpu_torch" in capsys.readouterr().err


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
    for p in (MappingParams(ignore_qualities=False),
              MappingParams(affine_align=True)):
        with pytest.raises(NotImplementedError):
            Mapper(gi, p, device="cpu")

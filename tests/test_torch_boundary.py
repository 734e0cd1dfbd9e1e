"""Guards on the PyTorch port's import boundary.

* With JAX and the JAX package ``blasr_tpu`` blocked (the port imports
  neither), every ``blasr_tpu_torch`` module imports and the CLI maps a
  tiny world on the CPU, with and without ``--useQuality``.
* Every module, function and class the port copied from ``blasr_tpu``
  (params, sim, the io and index modules, the native helpers, the host
  half of map_read, metrics, scoring, select, longread, extend, onegap,
  zmw, the multihost helpers, formats, the full SW and swMatcher, the
  index and FASTA tools)
  matches its original by
  ``ast.dump``, module names normalized; the differences the port needs
  are listed below.  The copies that time their work in spans
  (``pipeline/metrics.py``) match once each span block is replaced by
  its body.
* Every mapping flag of the JAX CLI is accepted and runs to its end on
  the port, ``--affineAlign`` (with and without ``--useQuality``)
  included; the Mapper takes every option of the JAX Mapper.
"""

import ast
import os
import re
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

from torch_shared import TORCH_THREADS  # noqa: E402

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
    ("index/__init__.py", "index/__init__.py", "module"),
    ("index/genome.py", "index/genome.py", "module"),
    ("index/suffix_array.py", "index/suffix_array.py", "module"),
    ("index/bwt.py", "index/bwt.py", "module"),
    # the build differs (get_lib / _build): into build/blasr_tpu_torch/
    ("native/__init__.py", "native/__init__.py",
     ["sais_native", "cigar_native", "cigar_native_batch", "runs_to_list",
      "bwt_invert_native"]),
    ("cli/sawriter.py", "cli/sawriter.py", "module"),
    ("cli/sa2bwt.py", "cli/sa2bwt.py", "module"),
    ("cli/bwt2sa.py", "cli/bwt2sa.py", "module"),
    ("cli/small_tools.py", "cli/small_tools.py", "module"),
    ("io/samparse.py", "io/samparse.py", "module"),
    ("io/cmph5.py", "io/cmph5.py", "module"),
    ("cli/sam_filter.py", "cli/sam_filter.py", "module"),
    ("cli/sam_to_m4.py", "cli/sam_to_m4.py", "module"),
    ("cli/sam_to_h5.py", "cli/sam_to_h5.py", "module"),
    ("cli/load_pulses.py", "cli/load_pulses.py", "module"),
    ("cli/pls2fasta.py", "cli/pls2fasta.py", "module"),
    ("cli/bax2bam.py", "cli/bax2bam.py", "module"),
    ("cli/bam2bax.py", "cli/bam2bax.py", "module"),
    ("cli/cmph5_store_quality_by_context.py",
     "cli/cmph5_store_quality_by_context.py", "module"),
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
    # the two that differ are held to their seams by
    # test_multihost_differs_only_at_its_seams
    ("dist/multihost.py", "dist/multihost.py",
     ["shard_reads", "shard_path", "merge_outputs", "_out_path_of",
      "init_distributed", "run_sharded"]),
    # the host pieces of the mesh; the rest is torch.distributed
    ("dist/mesh.py", "dist/mesh.py", ["shard_index", "globalize_sharded"]),
    ("kernels/sw.py", "kernels/sw.py", "module"),
    ("cli/sw_matcher.py", "cli/sw_matcher.py", "module"),
    # every top-level function; the two that differ are held to their
    # seams by test_cli_differs_only_at_its_seams
    ("cli/blasr.py", "cli/blasr.py", None),
]

# methods of the copied Mapper, and functions of the other copies, that
# differ on purpose:
ALLOWED = {
    # device seam: torch device + index upload, the host matrix and gap
    # costs as Python values, K1 (use_pallas) in every mode at band 128
    # (K1-W at any other width on CUDA), the rescue Mapper on the same
    # device
    "Mapper.__init__",
    # builds the CUDA kernels and captures each bucket's CUDA graph
    # (pipeline/graphs.py) instead of compiling XLA executables
    "Mapper.warmup",
    # torch tensors: pinned non-blocking uploads and start_fetch in place
    # of device_put and copy_to_host_async (same lookahead of 4), each
    # batch through graphs.dispatch (a graph replay on CUDA)
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
    # cli/blasr.py: the --device option, the torch.profiler help and the
    # port's description
    "build_arg_parser",
    # cli/blasr.py: the torch device (checked, handed to the Mapper), the
    # torch.profiler trace, no JAX compile cache, contextlib imported at
    # the top
    "run",
    # dist/multihost.py: a torch.distributed launch (WORLD_SIZE, RANK
    # beside MASTER_ADDR, or an initialised default group) in place of
    # jax.distributed; no process group is started
    "init_distributed",
    # dist/multihost.py: the docstring only (the port's CLI, a barrier
    # that needs no process group)
    "run_sharded",
}

# copies that differ from their originals only by span blocks (``with
# span(...)`` / ``with timeline(...)``, pipeline/metrics.py, or a clock of
# a dotted span name, ``with self.metrics.clock("collect.survey")``)
# around some of their statements:
# test_spanned_copy_is_its_original_in_spans
SPANNED = {
    # cli/blasr.py: emit.map_qv, emit.select (per read), emit.write
    "emit",
    # pipeline/select.py: emit.rescore around the likelihood rescore
    "store_map_qvs",
    # pipeline/map_read.py: collect.survey, collect.cigars
    "Mapper._collect_batch",
    # pipeline/metrics.py: the clock's timeline range
    "MappingMetrics",
}

# what the port's cli/blasr.py changes in the functions ALLOWED names: a
# statement that mentions one of these (the JAX compile cache and profiler,
# the torch device and profiler) and a call's ``device=`` / ``description=``
_CLI_SEAM = re.compile(r"\b(jax|torch|contextlib|_torch_trace)\b")


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
                assert same or m in ALLOWED or m in SPANNED, \
                    f"{m} drifted from blasr_tpu"
            continue
        assert ast.dump(a) == ast.dump(b) or name in ALLOWED \
            or name in SPANNED, f"{name} drifted from blasr_tpu"


_SPAN_CALLS = ("span", "timeline")


def _is_span_call(call):
    """span(...), timeline(...), or ``<metrics>.clock("<a>.<b>")``: the
    JAX package's clock names have no dot, the port's span names one."""
    if not isinstance(call, ast.Call):
        return False
    f = call.func
    if isinstance(f, ast.Name):
        return f.id in _SPAN_CALLS
    return (isinstance(f, ast.Attribute) and f.attr == "clock"
            and len(call.args) == 1 and isinstance(call.args[0], ast.Constant)
            and "." in str(call.args[0].value))


def _is_span(stmt):
    """A ``with`` whose every item is a span (:func:`_is_span_call`)."""
    return isinstance(stmt, ast.With) and all(
        _is_span_call(it.context_expr) and it.optional_vars is None
        for it in stmt.items)


def _unwrap_spans(node):
    """``node`` (changed in place) with each span block, at any depth,
    replaced by its statements."""
    for sub in ast.walk(node):
        for field in ("body", "orelse", "finalbody"):
            stmts = getattr(sub, field, None)
            if not isinstance(stmts, list):
                continue
            while any(_is_span(s) for s in stmts):
                stmts = [t for s in stmts
                         for t in (s.body if _is_span(s) else [s])]
            setattr(sub, field, stmts)
    return node


def _spanned_pair(name):
    """(the port's node, the original's) of a SPANNED name, from the
    COPIES module that holds it."""
    for port, orig, names in COPIES:
        if names == "module":
            continue
        pp = os.path.join(ROOT, "blasr_tpu_torch", port)
        op = os.path.join(ROOT, "blasr_tpu", orig)
        p, o = _defs(pp), _defs(op)
        if "." in name:
            cls, _ = name.split(".", 1)
            if cls in o and cls in p and (names is None or cls in names):
                return _members(p[cls])[name], _members(o[cls])[name]
        elif name in o and name in p and (names is None or name in names):
            return p[name], o[name]
    raise KeyError(name)


@pytest.mark.parametrize("name", sorted(SPANNED))
def test_spanned_copy_is_its_original_in_spans(name):
    """Each SPANNED copy has a span block, and equals its JAX original
    once every span block is replaced by its body (nothing dropped)."""
    port, orig = _spanned_pair(name)
    assert any(_is_span(s) for s in ast.walk(port)), name
    assert ast.dump(port) != ast.dump(orig)
    assert ast.dump(_unwrap_spans(port)) == ast.dump(orig), \
        f"{name} drifted from blasr_tpu outside its spans"


@pytest.mark.parametrize("name", sorted(SPANNED))
def test_spanned_copy_change_inside_a_span_is_caught(name):
    """A statement changed inside a span block (here its first, turned
    into ``pass``) makes the copy differ from its original: the spans
    hide nothing they hold."""
    port, orig = _spanned_pair(name)
    block = next(s for s in ast.walk(port) if _is_span(s))
    assert not isinstance(block.body[0], ast.Pass)
    block.body[0] = ast.Pass()
    assert ast.dump(_unwrap_spans(port)) != ast.dump(orig)


# modules of the JAX package with no counterpart in the port: hostcache.py
# keys the JAX compile cache on the host's CPU, which the port, compiling
# no XLA programs, has no use for (its CUDA kernels build once per
# checkout, cuda_ops.library_path)
NOT_PORTED = {"hostcache.py"}


def test_every_jax_module_has_a_counterpart():
    """Each ``.py`` module of ``blasr_tpu/`` has one at the same path in
    ``blasr_tpu_torch/``, but the modules NOT_PORTED names."""
    def modules(pkg):
        root = os.path.join(ROOT, pkg)
        return {os.path.relpath(os.path.join(dp, f), root)
                for dp, _, files in os.walk(root) for f in files
                if f.endswith(".py")}
    jax_mods, port_mods = modules("blasr_tpu"), modules("blasr_tpu_torch")
    assert NOT_PORTED <= jax_mods
    missing = sorted(jax_mods - port_mods - NOT_PORTED)
    assert not missing, f"modules of blasr_tpu with no counterpart: {missing}"
    assert not NOT_PORTED & port_mods


def _strip_cli_seams(node):
    """``node`` without the statements (at any depth) that mention a
    :data:`_CLI_SEAM` name and without ``device=`` and ``description=``
    keyword arguments."""
    for field in ("body", "orelse", "finalbody"):
        stmts = getattr(node, field, None)
        if isinstance(stmts, list):
            setattr(node, field, [
                _strip_cli_seams(s) for s in stmts
                if not _CLI_SEAM.search(ast.unparse(s))])
    for call in ast.walk(node):
        if isinstance(call, ast.Call):
            call.keywords = [k for k in call.keywords
                             if k.arg not in ("device", "description")]
    return node


@pytest.mark.parametrize("name", ["build_arg_parser", "run"])
def test_cli_differs_only_at_its_seams(name):
    """The two CLI functions ALLOWED names equal their JAX originals once
    the seams are taken out of both: the torch device, the profiler
    (jax.profiler there, torch.profiler here), the JAX compile cache and
    the parser's description; and each seam really differs."""
    pp = os.path.join(ROOT, "blasr_tpu_torch", "cli", "blasr.py")
    op = os.path.join(ROOT, "blasr_tpu", "cli", "blasr.py")
    port, orig = _defs(pp)[name], _defs(op)[name]
    assert ast.dump(port) != ast.dump(orig)
    assert ast.dump(_strip_cli_seams(port)) == \
        ast.dump(_strip_cli_seams(orig)), f"cli/blasr.py {name} drifted"


def _body(node):
    """A function's statements after its docstring."""
    return [ast.dump(s) for s in node.body[1:]]


def test_multihost_differs_only_at_its_seams():
    """dist/multihost.py's two ALLOWED functions: run_sharded is its JAX
    original but for the docstring; init_distributed keeps the original's
    BLASR_TPU_* overrides first and its (0, 1) last, and differs only
    between them."""
    port = _defs(os.path.join(ROOT, "blasr_tpu_torch", "dist",
                              "multihost.py"))
    orig = _defs(os.path.join(ROOT, "blasr_tpu", "dist", "multihost.py"))
    for name in ("run_sharded", "init_distributed"):
        assert ast.dump(port[name]) != ast.dump(orig[name])
        assert ast.dump(port[name].args) == ast.dump(orig[name].args)
    assert _body(port["run_sharded"]) == _body(orig["run_sharded"])
    p, o = _body(port["init_distributed"]), _body(orig["init_distributed"])
    assert p[0] == o[0] and p[-1] == o[-1] and p[1:-1] != o[1:-1]


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
        torch.set_num_threads({TORCH_THREADS})
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
def test_unported_flags_are_refused(tmp_path, monkeypatch, flag):
    """The two flag sets this test once saw refused now run: the affine
    path (the hp band) and its --useQuality form (the QV-steered DP) are
    accepted and run to their end, on a FASTQ read shorter than
    --minReadLength as in test_mode_flags_are_accepted.  Their outputs are
    held to the goldens (m4.affine, m4.hpstr.affine) in
    test_torch_golden_affine*.py and to the JAX package in
    test_torch_mapper_modes.py."""
    from blasr_tpu_torch.cli.blasr import run
    from blasr_tpu_torch.io.fasta import decode, write_fasta
    from blasr_tpu_torch.sim import random_genome
    contigs = random_genome(8_000, seed=8)
    monkeypatch.chdir(tmp_path)
    write_fasta("g.fa", contigs)
    seq = decode(contigs[0].seq[1000:1300])
    with open("r.fastq", "w") as f:
        f.write(f"@m/1/0_300\n{seq}\n+\n{'5' * len(seq)}\n")
    assert run(["r.fastq", "g.fa", "--out", "out", "--device", "cpu",
                "--minReadLength", "500"] + flag) == 0
    assert open("out").read() == ""


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
    """The Mapper options once refused are taken on the CPU (the affine
    path with and without QVs, a rescue Mapper, occ_block_sample, a band
    width other than 128: K1-W's on the card, the plain DP here, with
    use_pallas false and the width in every batch's arguments); what it
    still refuses is a rescue Mapper on another device."""
    import dataclasses
    from blasr_tpu_torch.index.genome import build_genome_index
    from blasr_tpu_torch.params import MappingParams, ShapeConfig
    from blasr_tpu_torch.sim import random_genome
    from blasr_tpu_torch.pipeline.map_read import Mapper
    gi = build_genome_index(random_genome(5_000, seed=1), k=12)
    for p in (MappingParams(affine_align=True, ignore_qualities=False),
              MappingParams(affine_align=True)):
        m = Mapper(gi, p, device="cpu")
        assert len(m.gap_costs) == 6 and m.use_pallas
    pos, kw = m._batch_call_args(1024)
    assert kw["use_hp"] and m.gap_costs == [14.0, 1.0, 15.0, 1.0, 7.0, 2.0]
    rescue = Mapper(gi, MappingParams(), device="cpu")
    assert Mapper(gi, MappingParams(), rescue=rescue,
                  device="cpu").rescue is rescue
    block = Mapper(gi, MappingParams(),
                   ShapeConfig(occ_block_sample=True), device="cpu")
    assert block._batch_call_args(1024)[1]["occ_block_sample"]
    narrow = ShapeConfig(band_width=64)
    m64 = Mapper(gi, MappingParams(), narrow, device="cpu")
    assert not m64.use_pallas
    kw64 = m64._batch_call_args(1024)[1]
    kw128 = rescue._batch_call_args(1024)[1]
    W64 = narrow.window_len(1024)
    assert kw64 == dict(kw128, w_b=64, use_pallas=False, W=W64,
                        T=1024 + W64)
    assert kw128["w_b"] == 128 and kw128["use_pallas"]
    with pytest.raises(ValueError):
        Mapper(gi, MappingParams(), dataclasses.replace(narrow,
                                                        band_width=128),
               rescue=rescue, device="cuda")


def test_native_source_is_a_copy():
    """The port builds its host library from its own copy of sais.cpp:
    the original below a one-line header comment."""
    port = open(os.path.join(ROOT, "blasr_tpu_torch", "native",
                             "sais.cpp")).read()
    orig = open(os.path.join(ROOT, "blasr_tpu", "native", "sais.cpp")).read()
    head, body = port.split("\n", 1)
    assert head.startswith("// Copied from blasr_tpu/native/sais.cpp")
    assert body == orig

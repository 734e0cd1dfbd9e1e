"""The reference agrees with the port on a tiny world on the CPU; the
lower-precision control and the planted faults fail the check; a run
without a card prints nothing."""

import io
import json

import pytest
import torch

from benchmark import check, inputs, run
from benchmark.tests import tiny


def port_answers(inp, device="cpu"):
    """The port's answers as a run takes them: ``map_reads``, the CLI's
    emit into a stream that keeps nothing, the hit policy's choice taken
    again from the stored mapQVs."""
    from blasr_tpu_torch.cli.blasr import emit
    from blasr_tpu_torch.index.genome import build_genome_index
    from blasr_tpu_torch.io.fasta import FastaRecord
    from blasr_tpu_torch.params import MappingParams
    from blasr_tpu_torch.pipeline import select
    from blasr_tpu_torch.pipeline.map_read import Mapper
    from blasr_tpu_torch.pipeline.zmw import zmw_key
    p = MappingParams(**inp.mapper).make_sane()
    gi = build_genome_index([FastaRecord(c.title, c.seq)
                             for c in inp.contigs], k=12)
    recs = [FastaRecord(r.name, r.seq) for r in inp.pool]
    per_read = Mapper(gi, p, device=device).map_reads(recs)
    emit(run.Discard(), None, recs, per_read, gi, p)
    return check.finish_reads(per_read, recs, p, gi, select, zmw_key,
                              store=False)


@pytest.mark.parametrize("seed", [2**31 + 3, 40])
def test_reference_equals_the_port(seed):
    inp = inputs.make(tiny.CONFIG, tiny.MIX, seed=seed)
    ref = check.run_reference(inp, seed, "cpu", rows=1 << 30)
    assert all(r is not None for r in ref.reads)      # every batch
    program = port_answers(inp)
    numbers = check.compare(program, ref)
    assert numbers["reads_compared"] + numbers["deep_reads"] == 6
    assert numbers["reads_differ"] == 0
    assert numbers["rescued_not_better"] == 0
    assert numbers["rescued_inconsistent"] == 0
    # every alignment of both sides agrees with the sequences
    for side in (program, ref.reads):
        for j, c in enumerate(side):
            assert check.inconsistent(c, inp.pool[j].seq, inp.contigs,
                                      ref.scoring) == 0


def test_inconsistent_answer_is_caught():
    """A rescued read's answer that is moved along the contig, or whose
    CIGAR is altered, or whose score is lowered, disagrees with the
    sequences."""
    inp = inputs.make(tiny.CONFIG, tiny.MIX, seed=40)
    ref = check.run_reference(inp, 40, "cpu", rows=1 << 30)
    j = next(k for k, c in enumerate(ref.reads) if c[0])
    alns, chosen = ref.reads[j]
    a = alns[0]
    moved = a[:4] + (a[4] + 1, a[5] + 1) + a[6:]
    cig = list(a[12])
    k = next(i for i, (op, n) in enumerate(cig) if op == "M" and n > 1)
    cig[k:k + 1] = [("M", cig[k][1] - 1), ("I", 1), ("D", 1)]
    recut = a[:12] + (tuple(cig),)
    lower = a[:6] + (a[6] - 1,) + a[7:]
    for bad in (moved, recut, lower):
        c = ((bad,) + alns[1:], chosen)
        assert check.inconsistent(c, inp.pool[j].seq, inp.contigs,
                                  ref.scoring) == 1
    # in the comparison: read j sent to the rescue, with an answer of a
    # strictly lower score that is moved
    ref.deep = {j}
    program = list(ref.reads)
    program[j] = ((lower[:4] + (a[4] + 1, a[5] + 1) + lower[6:],)
                  + alns[1:], chosen)
    numbers = check.compare(program, ref)
    assert numbers["rescued_inconsistent"] == 1
    assert numbers["rescued_not_better"] == 0
    assert not check.verdict(numbers)[0]


def test_lower_precision_control_fails():
    inp = inputs.make(tiny.CONFIG, tiny.MIX, seed=5)
    ref = check.run_reference(inp, 5, "cpu", rows=1 << 30)
    low = check.run_reference(inp, 5, "cpu", dtype=torch.bfloat16,
                              rows=1 << 30)
    numbers = check.compare(low.reads, ref)
    assert not check.verdict(numbers)[0]
    assert numbers["reads_differ"] >= 3


def shift_read0(res):
    """An answer altered where it is produced: read 0's candidates one
    base further along the contig."""
    res.t_start[0] += 1
    res.t_end[0] += 1
    return res


def drop_half(res):
    """Half of the batch left out: every other read of it gets no
    candidate (the rest mapped as before)."""
    B = res.valid.shape[0] // 2
    res.valid[1:B:2] = False
    res.valid[B + 1::2] = False
    return res


def run_tiny(tmp_path, monkeypatch, cell, fault=None, seed=11):
    bench, root = tiny.world(tmp_path)
    if fault is not None:
        from blasr_tpu_torch.pipeline import map_read
        inner = map_read.unpack_batch
        monkeypatch.setattr(map_read, "unpack_batch",
                            lambda pb: fault(inner(pb)))
    out = io.StringIO()
    rc = run.run_cell(cell, seed, 0.1, False, bench=bench, root=root,
                      device="cpu", out=out)
    assert rc == 0
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics",
            "device"} <= set(line)
    return line


@pytest.mark.parametrize("fault", [None, shift_read0, drop_half],
                         ids=["sound", "altered_answer", "half_left_out"])
def test_faults_fail_the_check(tmp_path, monkeypatch, fault):
    line = run_tiny(tmp_path, monkeypatch, "tiny.fasta", fault)
    assert line["correct"] is (fault is None)
    # the card's busy time has no reading on the CPU
    assert set(line["metrics"]) == {"setup_s"}
    assert line["metrics"]["setup_s"]["value"] > 0


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    assert run.run_cell("ecoli_k12.clr_fasta", 1, 1.0, False) == 2
    assert capsys.readouterr().out == ""


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["tiny.fasta"])
def test_tiny_cell_on_the_card(tmp_path, card, cell):
    """The port's kernels and graphs on the card against the reference,
    and a traced run's per-layer metrics."""
    bench, root = tiny.world(tmp_path)
    for trace in (False, True):
        out = io.StringIO()
        assert run.run_cell(cell, 13, 1.0, trace, bench=bench, root=root,
                            out=out) == 0
        line = json.loads(out.getvalue().strip().splitlines()[-1])
        assert line["correct"] is True
        assert line["device"]["platform"] == "gpu"
        if not trace:
            assert line["metrics"]["device_s_per_gbase"]["value"] > 0
    assert line["device"]["busy_s"] > 0
    assert "banded_dp_ms_per_mbase" in line["metrics"]


def test_control_script_at_a_tiny_size(tmp_path):
    """``control.py``'s reading on the tiny cell: the bfloat16 reference
    in the program's place fails the check."""
    from benchmark import control
    bench, root = tiny.world(tmp_path)
    got = control.control("tiny.fasta", 21, "cpu", bench, root)
    assert got["correct"] is False
    assert got["reads_differ"] + got["rescued_not_better"] > 0

"""The port's spans and counters (``pipeline/metrics.py``): ``span`` and
``MappingMetrics.clock`` enter no profiler range while no profiler
records; under torch.profiler a CLI run records ``emit``'s and the
collection's spans nested in its own range, ``emit``'s per-read spans on
their clocks only; their seconds and counts,
and K1's rows stored and needed, land in the Mapper's ``MappingMetrics``,
which ``--metrics`` prints; ``StageTimer`` splits a stage into parts that
sum to it and leaves the stages' own intervals as they were."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from blasr_tpu_torch.pipeline import map_read as tmr  # noqa: E402
from blasr_tpu_torch.pipeline import metrics  # noqa: E402
from torch_shared import TORCH_THREADS, shared  # noqa: E402

OUTER = "test.cli_run"
EMIT_SPANS = ("emit.map_qv", "emit.select", "emit.write")
# emit's ranges: its first pass as one, the writers'; the spans taken once
# a read or more often are on their clocks only
EMIT_RANGES = ("emit.pass1", "emit.write")
PER_READ = ("emit.map_qv", "emit.select", "emit.rescore")
COLLECT_SPANS = ("collect.survey", "collect.cigars", "collect.unpack")
# the marks map_batch makes, in order, with the SDP pass on (k_sdp > 0):
# a stage's own mark also ends its last part
MARKS = ("start", "anchors", "chain", "guide_sdp.compact",
         "guide_sdp.gather", "guide_sdp.fragments",
         ("guide_sdp.sdp", "guide_sdp"), "banded_dp", "traceback.rank",
         "traceback.gather", ("traceback.k2", "traceback"), "pack")


def _build(d):
    """The CLI on a 30 kb genome and four reads, on the CPU, in this
    process under torch.profiler (CPU activity) inside the range OUTER,
    with map_batch's stage marks recorded by name; returns the profiler's
    ranges, the sink's clocks and counters after the run, the --metrics
    file and the marks."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from blasr_tpu_torch.cli.blasr import run
    from blasr_tpu_torch.io.fasta import write_fasta
    from blasr_tpu_torch.sim import random_genome, simulate_reads
    torch.set_num_threads(TORCH_THREADS)
    contigs = random_genome(30_000, seed=61, n_contigs=2)
    sims = simulate_reads(contigs, 4, read_len=(400, 700), accuracy=0.88,
                          seed=62)
    genome, reads = str(d / "genome.fa"), str(d / "reads.fa")
    write_fasta(genome, contigs)
    write_fasta(reads, [s.rec for s in sims])
    marks, words = [], []
    mark, unpack = tmr._mark, tmr._unpack

    def recount(pb):
        # the rows-used word against qb - qa over the valid candidates
        # (those without a DP row hold qa = qb = 0)
        res = unpack(pb)
        words.append((int(pb.host[-2]), int(
            ((res.q_end - res.q_start) * res.chain_valid).sum()),
            pb.dp_rows))
        return res

    tmr._mark = lambda name, dev: marks.append(name)
    tmr._unpack = recount
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with record_function(OUTER):
                rc = run([reads, genome, "-m", "4", "--device", "cpu",
                          "--out", str(d / "out.m4"),
                          "--metrics", str(d / "metrics.txt")])
    finally:
        tmr._mark, tmr._unpack = mark, unpack
    assert rc == 0
    names = set(EMIT_SPANS + EMIT_RANGES + COLLECT_SPANS + PER_READ) | {
        OUTER, "collect.wait", "map.stage", "collectAlignments",
        "mapToGenome"}
    ranges = []
    for ev in prof.profiler.kineto_results.events():
        if ev.name() in names:
            ranges.append((ev.name(), ev.start_ns(),
                           ev.start_ns() + ev.duration_ns()))
    sink = metrics._sink
    return dict(ranges=ranges, clocks=dict(sink.clocks),
                counters=dict(sink.counters), marks=marks, words=words,
                n_reads=len(sims),
                metrics_txt=open(d / "metrics.txt").read(),
                out=open(d / "out.m4").read())


@pytest.fixture
def world(tmp_path_factory):
    return shared(tmp_path_factory, __file__, "cli_run", _build)


def test_span_enters_no_range_without_a_profiler(monkeypatch):
    """With no profiler recording, span() and MappingMetrics.clock call
    no record_function; each adds its seconds and count to the sink."""
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")

    monkeypatch.setattr(metrics._profiler, "record_function", refuse)
    m = metrics.MappingMetrics()
    monkeypatch.setattr(metrics, "_sink", m)
    assert not metrics._profiler._is_profiler_enabled
    for _ in range(3):
        with metrics.span("t.block", 5):
            pass
    with m.clock("t.clock"):
        pass
    metrics.count("t.counter", 7)
    assert m.counters["t.block"] == 15 and m.clocks["t.block"] >= 0.0
    assert "t.clock" in m.clocks and m.counters["t.counter"] == 7


def test_span_without_a_sink_records_nothing(monkeypatch):
    monkeypatch.setattr(metrics, "_sink", None)
    with metrics.span("t.nowhere"):
        pass
    metrics.count("t.nowhere", 1)


def test_span_opens_a_range_under_the_profiler():
    """Under torch.profiler a span and a clock are ranges of their own
    name, the span's nested in the clock's."""
    from torch.profiler import ProfilerActivity, profile
    m = metrics.MappingMetrics()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with m.clock("t.outer"):
            with metrics.span("t.inner"):
                pass
    got = {ev.name(): (ev.start_ns(), ev.start_ns() + ev.duration_ns())
           for ev in prof.profiler.kineto_results.events()
           if ev.name() in ("t.outer", "t.inner")}
    assert set(got) == {"t.outer", "t.inner"}
    assert got["t.outer"][0] <= got["t.inner"][0] \
        <= got["t.inner"][1] <= got["t.outer"][1]


@pytest.mark.parametrize("name", EMIT_RANGES + COLLECT_SPANS
                         + ("map.stage", "collectAlignments"))
def test_cli_run_records_span_on_the_timeline(world, name):
    """emit's two ranges and each span of the collection (and the clocks)
    are profiler ranges inside the run's own range."""
    ranges = world["ranges"]
    outer = [r for r in ranges if r[0] == OUTER]
    assert len(outer) == 1
    _, o0, o1 = outer[0]
    mine = [r for r in ranges if r[0] == name]
    assert mine, f"no range {name}"
    assert all(o0 <= s <= e <= o1 for _, s, e in mine)


def test_per_read_spans_stay_off_the_timeline(world):
    """The spans taken once a read or more often open no range, yet keep
    their clocks."""
    names = {n for n, _, _ in world["ranges"]}
    for name in PER_READ:
        assert name not in names, name
    # this world's reads have one placement each: no group to rescore
    for name in PER_READ[:2]:
        assert world["clocks"][name] > 0.0, name


def test_collect_spans_nest_in_the_collection_clock(world):
    """collect.* run inside collectAlignments, emit.* after every one."""
    ranges = world["ranges"]
    coll = [(s, e) for n, s, e in ranges if n == "collectAlignments"]
    for n, s, e in ranges:
        if n in COLLECT_SPANS:
            assert any(c0 <= s <= e <= c1 for c0, c1 in coll), n
    last = max(e for _, e in coll)
    assert all(s >= last for n, s, _ in ranges if n in EMIT_RANGES)


def test_spans_and_counters_land_in_the_mapper_metrics(world):
    """The CLI's Mapper's MappingMetrics holds each span's seconds and
    count (per read for emit's pass 1), K1's rows stored and needed, and
    --metrics prints them."""
    clocks, counters = world["clocks"], world["counters"]
    n = world["n_reads"]
    assert counters["emit.select"] == n and counters["emit.map_qv"] == n
    assert counters["emit.write"] == 1
    for name in EMIT_SPANS + COLLECT_SPANS + ("map.stage",):
        assert clocks[name] > 0.0, name
    assert counters["collect.unpack"] >= 1
    assert 0 < counters["dp_rows_used"] <= counters["dp_rows_stored"]
    lines = dict(ln.split(" ", 1)
                 for ln in world["metrics_txt"].splitlines())
    for name in EMIT_SPANS + COLLECT_SPANS + ("dp_rows_used",
                                              "dp_rows_stored"):
        assert name in lines, name
    assert int(lines["dp_rows_used"]) == counters["dp_rows_used"]
    assert len(world["out"].splitlines()) >= n - 1


def test_rows_used_word_is_a_recount_of_the_batch(world):
    """Each batch's rows-used word is the sum of qb - qa over its valid
    DP items, at most the n_dp x L rows stored, and the counters are the
    sums over the batches."""
    words = world["words"]
    assert words
    for used, recount, stored in words:
        assert used == recount and 0 < used <= stored
    assert world["counters"]["dp_rows_used"] == sum(w[0] for w in words)
    assert world["counters"]["dp_rows_stored"] == sum(w[2] for w in words)


def test_map_batch_marks_partition_its_stages(world):
    """map_batch marks every part of guide_sdp and traceback between the
    stage before and the stage itself, whose mark ends the last part."""
    marks = world["marks"]
    assert len(marks) % len(MARKS) == 0 and marks
    for j in range(0, len(marks), len(MARKS)):
        assert tuple(marks[j:j + len(MARKS)]) == MARKS


class _Ev:
    def __init__(self, t):
        self.t = t

    def elapsed_time(self, other):
        return other.t - self.t


def _stage_names(m):
    return [n for n in ((m,) if isinstance(m, str) else m) if "." not in n]


@pytest.mark.parametrize("sdp", [True, False])
def test_stage_timer_parts_sum_to_their_stage(sdp):
    """Two passes with parts give each stage the total it has with its
    stage marks alone, and parts that sum to their stage exactly."""
    rng = np.random.default_rng(5)
    marks = [m for m in MARKS if sdp or m != "guide_sdp.fragments"]
    if not sdp:
        marks[marks.index(("guide_sdp.sdp", "guide_sdp"))] = (
            "guide_sdp.fragments", "guide_sdp")
    split, plain = [], []
    for _ in range(2):
        for m, t in zip(marks, np.cumsum(rng.uniform(0.1, 2.0,
                                                     len(marks)))):
            split.append((m, _Ev(t)))
            plain += [(n, _Ev(t)) for n in _stage_names(m)]
    a = tmr.StageTimer.spans(plain)
    b = tmr.StageTimer.spans(split)
    assert set(a) == {"anchors", "chain", "guide_sdp", "banded_dp",
                      "traceback", "pack"}
    for k in a:
        assert b[k] == pytest.approx(a[k])
    for stage in ("guide_sdp", "traceback"):
        parts = [k for k in b if k.startswith(stage + ".")]
        assert len(parts) == (4 if stage == "guide_sdp" and sdp else 3)
        assert sum(b[k] for k in parts) == pytest.approx(b[stage])
    assert ("guide_sdp.sdp" in b) == sdp

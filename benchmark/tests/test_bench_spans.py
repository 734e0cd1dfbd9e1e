"""The readers of the program's spans and counters inside the port: each
on numbers made up here, and each silent, never 0 or a raise, on a run
of a program that has no such span or counter (its parent's)."""

import pytest

from benchmark import devtrace, registry
from benchmark.roofline import banded_dp

H100 = banded_dp.peaks("NVIDIA H100 80GB HBM3")
STAGES = {"anchors": 20.0, "chain": 40.0, "guide_sdp": 60.0,
          "banded_dp": 100.0, "traceback": 30.0, "pack": 10.0}


def make_ctx(**over):
    ctx = dict(
        device_name="NVIDIA H100 80GB HBM3", peaks=H100, mode="distance",
        band_width=128, pool_bases=2_000_000, setup={"index": 1.25},
        captures=[{"ms": 30.0, "warmup_ms": 900.0},
                  {"ms": 20.0, "warmup_ms": 600.0}],
        trace=devtrace.TraceSummary(window_s=10.0, busy_s=6.0,
                                    runtime_calls=900),
        profiled={"dispatches": {"batches": 100, "dense_reruns": 25,
                                 "captures": 0, "replays": 125,
                                 "waited": 5},
                  "calls": 4, "bases_per_s": 1.5e6},
        staged={"stages_ms": dict(STAGES, **{
            "guide_sdp.compact": 5.0, "guide_sdp.gather": 25.0,
            "guide_sdp.fragments": 20.0, "guide_sdp.sdp": 10.0,
            "traceback.rank": 3.0, "traceback.gather": 7.0,
            "traceback.k2": 20.0}),
            "clocks": {"collectAlignments": 2.0, "emit.map_qv": 3.0,
                       "emit.select": 0.5, "emit.write": 1.0,
                       "emit.rescore": 2.4, "collect.survey": 1.2,
                       "collect.cigars": 0.4, "map.stage": 0.1},
            "counters": {"cells": 10_000_000, "emit.rescore": 12_000,
                         "dp_rows_stored": 4_000_000,
                         "dp_rows_used": 1_000_000},
            "dispatches": {"batches": 80, "dense_reruns": 20,
                           "captures": 0, "replays": 100, "waited": 0},
            "calls": 5, "bases": 10_000_000, "emit_s": 4.6})
    ctx.update(over)
    return ctx


# 10 Mbase in the StageTimer half
EXPECTED = {
    "emit_map_qv_ms_per_mbase": 300.0,
    "emit_select_ms_per_mbase": 50.0,
    "emit_write_ms_per_mbase": 100.0,
    "map_qv_rescore_us": 200.0,
    "collect_survey_ms_per_mbase": 120.0,
    "collect_cigar_ms_per_mbase": 40.0,
    "stage_ms_per_mbase": 10.0,
    # 5 of 125 passes, in the profiled half
    "collect_waited_pct": 4.0,
    "capture_warmup_s": 1.5,
    "guide_compact_ms_per_mbase": 0.5,
    "guide_gather_ms_per_mbase": 2.5,
    "guide_fragments_ms_per_mbase": 2.0,
    "sdp_pass_ms_per_mbase": 1.0,
    "tb_rank_ms_per_mbase": 0.3,
    "tb_gather_ms_per_mbase": 0.7,
    "k2_ms_per_mbase": 2.0,
    "dp_rows_used_pct": 25.0,
}


def test_every_new_metric_is_declared_twice():
    """Each new reader has its BENCHMARK.json entry and a ``.repeats``
    twin (the set-up's warm-up one entry in both cells)."""
    entries = {m["name"]: m for m in registry.load_benchmark()["per_layer"]}
    for name in EXPECTED:
        assert name in entries, name
        if name == "capture_warmup_s":
            assert entries[name]["moves"] == "setup_s"
            assert len(entries[name]["workloads"]) == 2
            continue
        twin = entries[name + ".repeats"]
        assert entries[name]["workloads"] == ["ecoli_k12.clr_fasta"]
        assert twin["workloads"] == ["scer_s288c.clr_fasta"]
        assert twin["moves"] == "device_s_per_gbase.repeats"
        assert registry.base_name(name + ".repeats") == name


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader(name):
    got = registry.metric_reader(name).read(make_ctx())
    assert got == pytest.approx(EXPECTED[name])


def test_parts_sum_to_their_stage_in_the_made_up_run():
    st = make_ctx()["staged"]["stages_ms"]
    for stage in ("guide_sdp", "traceback"):
        assert sum(v for k, v in st.items()
                   if k.startswith(stage + ".")) == pytest.approx(st[stage])


def parent_ctx():
    """A traced run of a program without the spans: the six stages, the
    clocks and counters it had, no ``waited``, no ``warmup_ms``."""
    return make_ctx(
        captures=[{"ms": 30.0}],
        profiled={"dispatches": {"batches": 100, "dense_reruns": 0,
                                 "captures": 0, "replays": 100},
                  "calls": 4, "bases_per_s": 1.5e6},
        staged={"stages_ms": dict(STAGES),
                "clocks": {"collectAlignments": 2.0},
                "counters": {"cells": 10_000_000},
                "dispatches": {"batches": 80, "dense_reruns": 0,
                               "captures": 0, "replays": 80},
                "calls": 5, "bases": 10_000_000, "emit_s": 4.6})


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_on_a_program_without_spans(name):
    assert registry.metric_reader(name).read(parent_ctx()) is None


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_on_a_cpu_run(name):
    """A CPU run: no captures and no stage times; the host spans read
    (the CPU runs the same host code), the card's numbers do not."""
    ctx = make_ctx(captures=[], trace=devtrace.TraceSummary(
        window_s=3.0, busy_s=0.0), peaks=None)
    ctx["staged"] = dict(ctx["staged"], stages_ms={})
    ctx["profiled"] = dict(ctx["profiled"], dispatches={
        "batches": 4, "dense_reruns": 0, "captures": 0, "replays": 0,
        "waited": 0})
    got = registry.metric_reader(name).read(ctx)
    device = name.startswith(("guide_", "sdp_", "tb_", "k2_",
                              "capture_"))
    if device:
        assert got is None
    else:
        assert got is not None and got >= 0

"""The end-to-end arithmetic, the per-layer readers, the roofline counts on
hand-worked cases and the trace reduction, on numbers made up here."""

import pytest

from benchmark import devtrace, registry
from benchmark.roofline import banded_dp
from benchmark.run import bases_per_s, end_to_end_values

H100 = banded_dp.peaks("NVIDIA H100 80GB HBM3")


def test_bases_per_s_ends_at_the_last_completed_call():
    # three calls of 1,000 bases; the window opened at 10.0 and the last
    # call ended at 12.5, past the window's nominal end: 3000 / 2.5
    assert bases_per_s(10.0, [11.0, 11.9, 12.5], 1000) == pytest.approx(
        1200.0)
    assert bases_per_s(0.0, [4.0], 10) == pytest.approx(2.5)


def test_qualified_end_to_end_reads_its_base():
    entries = [{"name": "device_s_per_gbase", "unit": "s/Gbase"},
               {"name": "device_s_per_gbase.repeats", "unit": "s/Gbase"},
               {"name": "setup_s", "unit": "s"}]
    got = end_to_end_values(entries, {"device_s_per_gbase": 75.0,
                                      "setup_s": 15.0})
    assert got["device_s_per_gbase.repeats"] == {"value": 75.0,
                                                 "unit": "s/Gbase"}
    assert got["setup_s"]["value"] == 15.0
    # no reading (a CPU run's card time): left out, never 0
    assert set(end_to_end_values(entries, {"device_s_per_gbase": None,
                                           "setup_s": 1.0})) == {"setup_s"}


def test_roofline_counts_by_hand():
    # 1,000 query rows of one candidate at band 128: 128,000 cells
    cells = 128_000
    assert banded_dp.ops(cells, "distance") == 1_280_000
    assert banded_dp.ops(cells, "hp") == 1_920_000
    assert banded_dp.nbytes(cells, "distance") == 2_500
    assert banded_dp.nbytes(cells, "qv") == 10_500
    t, by = banded_dp.least_time(cells, "distance", H100)
    # 1.28e6 / 67e12 = 19.1 ns against 2,500 / 3.35e12 = 0.75 ns
    assert by == "operations"
    assert t == pytest.approx(1.28e6 / 67e12)
    # that work in 1 us of DP time is 1.91% of the roofline
    assert banded_dp.roofline_pct(cells, "distance", 1e-6, H100) == \
        pytest.approx(100 * 1.28e6 / 67e12 / 1e-6)
    assert banded_dp.roofline_pct(0, "distance", 1e-6, H100) is None
    assert banded_dp.peaks("some other card") is None


def make_ctx(**over):
    ctx = dict(
        device_name="NVIDIA H100 80GB HBM3", peaks=H100, mode="qv",
        band_width=128, pool_bases=2_000_000,
        setup={"index": 1.25},
        captures=[{"ms": 30.0}, {"ms": 20.0}],
        trace=devtrace.TraceSummary(window_s=10.0, busy_s=6.0,
                                    runtime_calls=900),
        profiled={"dispatches": {"batches": 100, "dense_reruns": 50,
                                 "captures": 0, "replays": 150},
                  "calls": 4, "bases_per_s": 1.5e6},
        staged={"stages_ms": {"anchors": 20.0, "chain": 40.0,
                              "guide_sdp": 60.0, "banded_dp": 100.0,
                              "traceback": 30.0, "pack": 10.0},
                "clocks": {"collectAlignments": 2.0},
                "counters": {"cells": 10_000_000},
                "dispatches": {"batches": 80, "dense_reruns": 20,
                               "captures": 0, "replays": 100},
                "calls": 5, "bases": 10_000_000, "emit_s": 1.5})
    ctx.update(over)
    return ctx


EXPECTED = {
    "read_bases_per_s.profiled": 1.5e6,
    "index_build_s": 1.25,
    "capture_s": 0.05,
    "launch_calls_per_batch": 900 / 150,
    "collect_ms_per_mbase": 2000.0 / 10,
    "emit_ms_per_mbase": 1500.0 / 10,
    "dense_rerun_pct": 25.0,
    "anchors_ms_per_mbase": 2.0,
    "chain_ms_per_mbase": 4.0,
    "guide_sdp_ms_per_mbase": 6.0,
    "banded_dp_ms_per_mbase": 10.0,
    "traceback_ms_per_mbase": 3.0,
    "pack_ms_per_mbase": 1.0,
    # 1e7 cells x 10 ops / 67e12 over 0.1 s
    "banded_dp_roofline": 100 * 1e8 / 67e12 / 0.1,
    "device_idle_pct": 40.0,
}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader(name):
    assert {registry.base_name(m["name"])
            for m in registry.load_benchmark()["per_layer"]} == set(EXPECTED)
    got = registry.metric_reader(name).read(make_ctx())
    assert got == pytest.approx(EXPECTED[name])


@pytest.mark.parametrize("name", sorted(set(EXPECTED) - {
    "index_build_s", "emit_ms_per_mbase", "read_bases_per_s.profiled"}))
def test_reader_with_nothing_to_read(name):
    """A CPU run has no captures, trace or stage times: every reader but
    the host clock's returns nothing, and none returns 0 for a share."""
    ctx = make_ctx(captures=[], trace=devtrace.TraceSummary(
        window_s=3.0, busy_s=0.0), peaks=None, staged={
            "stages_ms": {}, "clocks": {}, "counters": {},
            "dispatches": {"batches": 0, "dense_reruns": 0}, "calls": 1,
            "bases": 100})
    assert registry.metric_reader(name).read(ctx) is None


def ev(name, kind, device, start, end):
    return devtrace.Event(name, kind, device, int(start * 1e9),
                          int(end * 1e9))


def test_trace_summary():
    events = [
        ev(devtrace.WINDOW_SPAN, "user_annotation", False, 0.0, 10.0),
        ev(devtrace.CALL_SPAN, "user_annotation", False, 0.0, 6.0),
        ev(devtrace.CALL_SPAN, "user_annotation", False, 6.0, 10.0),
        ev("aten::copy_", "cpu_op", False, 2.0, 3.5),
        ev("cudaGraphLaunch", "cuda_runtime", False, 1.0, 1.01),
        ev("cudaMemcpyAsync", "cuda_runtime", False, 1.5, 1.51),
        ev("cudaEventQuery", "cuda_runtime", False, 1.6, 1.61),
        ev("k1", "kernel", True, 1.0, 2.0),
        ev("k1", "kernel", True, 1.5, 2.5),      # overlaps the first
        ev("k2", "kernel", True, 4.0, 5.0),
        ev("Memcpy DtoH", "gpu_memcpy", True, 7.0, 7.5),
        ev(devtrace.CALL_SPAN, "gpu_user_annotation", True, 0.0, 10.0),
        ev("k3", "kernel", True, 11.0, 12.0),    # after the window
    ]
    s = devtrace.summarize(events)
    assert s.window_s == pytest.approx(10.0)
    assert s.busy_s == pytest.approx(1.5 + 1.0 + 0.5)
    assert s.runtime_calls == 2
    assert s.device_ops[0] == ("k1", pytest.approx(2.0))
    assert dict(s.device_ops)["k2"] == pytest.approx(1.0)
    # gaps: 2.5-4.0 (the copy_ running), 0-1, 5-7 (between spans at 6),
    # 7.5-10
    assert s.idle_gaps[0] == (f"{devtrace.CALL_SPAN}/host_code",
                              pytest.approx(2.5))
    gaps = dict((round(d, 3), n) for n, d in s.idle_gaps)
    assert gaps[1.5] == f"{devtrace.CALL_SPAN}/aten::copy_"
    assert len(s.idle_gaps) == 4
    assert devtrace.summarize(events[1:]) is None
    # the untraced run's trace covers the window alone: every device
    # interval counts, the annotation mirrored on the device does not
    assert devtrace.device_busy_s(events) == pytest.approx(
        1.5 + 1.0 + 0.5 + 1.0)

"""The benchmark's files are found by the names BENCHMARK.json gives them,
and BENCHMARK.json keeps to the benchmark's contract."""

import json
import re
import shutil

import pytest

from benchmark import inputs, registry

BENCH = registry.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_found_by_name(cfg):
    assert cfg["file"] == f"benchmark/configs/{cfg['name']}.json"
    data = registry.config(cfg["name"])
    assert data["name"] == cfg["name"]
    assert data["reduced"] == cfg["reduced"]
    assert {"source", "genome", "mapper", "assumed", "chips"} <= set(data)
    assert len(cfg["source"]) <= 200 and len(cfg["why"]) <= 200


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_cell_parts_found_by_name(cell):
    assert NAME.match(cell["name"])
    assert cell["chips"] == 1
    assert len(cell["why"]) <= 200
    assert cell["name"] == f"{cell['config']}.{cell['traffic']}"
    assert registry.config(cell["config"])["chips"] == cell["chips"]
    mix = registry.traffic(cell["traffic"])
    assert mix["name"] == cell["traffic"]
    # the card's time a Gbase under a bound of each cell's own: the
    # repetitive genome's seeds change the work by a few %
    device = ("device_s_per_gbase.repeats" if cell["config"] == "scer_s288c"
              else "device_s_per_gbase")
    assert {m["name"] for m in registry.end_to_end(BENCH, cell["name"])} \
        == {device, "setup_s"}
    assert len(registry.per_layer(BENCH, cell["name"])) == 15


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_reader_found_by_name(metric):
    mod = registry.metric_reader(metric["name"])
    assert mod.UNIT == metric["unit"]
    assert mod.LAYER == metric["layer"]
    assert mod.MOVES == metric["moves"].split(".")[0]
    assert callable(mod.read)


def test_qualified_name_reads_its_base():
    """``<base>.<qualifier>`` with no file of its own is ``<base>``'s
    reader; a dotted name with a file of its own is its own."""
    assert registry.base_name("emit_ms_per_mbase.repeats") == \
        "emit_ms_per_mbase"
    assert registry.base_name("read_bases_per_s.profiled") == \
        "read_bases_per_s.profiled"
    assert registry.base_name("read_bases_per_s.profiled.repeats") == \
        "read_bases_per_s.profiled"
    assert registry.metric_reader("dense_rerun_pct.repeats").UNIT == "%"


def test_names_units_and_bounds():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
    # metrics of one layer name it letter for letter alike
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert len(layers) == 12
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_dummy_mix_is_picked_up(tmp_path):
    """A new mix is a data file: dropped beside the others, it is found by
    its name and read by the one generator, with no other edit."""
    root = tmp_path / "bench"
    shutil.copytree(registry.ROOT / "configs", root / "configs")
    (root / "traffic").mkdir()
    mix = dict(registry.traffic("clr_fasta"), name="dummy", n_reads=5)
    mix["length"] = dict(mix["length"], mean=700, sd=100, max=900)
    (root / "traffic" / "dummy.json").write_text(json.dumps(mix))
    bench = dict(BENCH, workloads=[{"name": "ecoli_k12.dummy",
                                    "config": "ecoli_k12",
                                    "traffic": "dummy", "chips": 1,
                                    "why": "a test's"}])
    cell = registry.workload(bench, "ecoli_k12.dummy")
    got = registry.traffic(cell["traffic"], root)
    assert got["n_reads"] == 5
    small = dict(registry.config("ecoli_k12", root))
    small["genome"] = {"contigs": [["c", 20000]], "repeat_families": []}
    inp = inputs.make(small, got, seed=3)
    assert len(inp.pool) == 5
    assert all(len(r.seq) > 0 for r in inp.pool)

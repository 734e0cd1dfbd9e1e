"""A cell small enough for a test run on the CPU: two contigs (60 kb)
with one planted repeat family, six reads of 0.5-1.9 kb."""

import json
from pathlib import Path

from benchmark import registry

CONFIG = {
    "name": "tiny", "genome_seed": 17, "source": "a test's", "chips": 1,
    "mapper": {},
    "reduced": [], "assumed": {},
    "genome": {"contigs": [["c0", 40000], ["c1", 20000]],
               "repeat_families": [{
                   "name": "T", "element_len": 1500, "ltr_len": 200,
                   "n_full": 3, "n_solo": 4, "full_identity": [0.99, 1.0],
                   "solo_identity": [0.9, 1.0]}]}}

MIX = {"name": "fasta", "n_reads": 6,
       "length": {"kind": "lognormal_quantiles", "mean": 1000, "sd": 400,
                  "min": 500, "max": 1900},
       "accuracy": {"kind": "normal_quantiles", "mean": 0.8, "sd": 0.02,
                    "min": 0.75},
       "error_split": {"ins": 0.6, "del": 0.3, "sub": 0.1},
       "both_strands": True, "mapper": {}}


def world(tmp_path: Path):
    """(bench, root): a BENCHMARK.json with the cell ``tiny.fasta``, and a
    folder holding its configuration and mix."""
    root = tmp_path / "bench"
    (root / "configs").mkdir(parents=True)
    (root / "traffic").mkdir()
    (root / "configs" / "tiny.json").write_text(json.dumps(CONFIG))
    (root / "traffic" / "fasta.json").write_text(json.dumps(MIX))
    bench = registry.load_benchmark()
    cells = [{"name": "tiny.fasta", "config": "tiny", "traffic": "fasta",
              "chips": 1, "why": "a test's"}]
    bench = dict(bench, workloads=cells, end_to_end=[
        dict(m, workloads=[c["name"] for c in cells]) if "workloads" in m
        else m for m in bench["end_to_end"]], per_layer=[
        dict(m, workloads=[c["name"] for c in cells])
        for m in bench["per_layer"]])
    return bench, root

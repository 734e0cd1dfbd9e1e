"""Where the benchmark finds its parts, by the names ``BENCHMARK.json``
gives them: a configuration in ``configs/<name>.json``, a traffic mix in
``traffic/<name>.json``, a per-layer metric's reader in
``metrics/<name>.py``.  A metric ``<base>.<qualifier>`` that has no file
of its own is ``<base>``'s quantity, held in the cells it lists apart
from ``<base>``'s (its reader, or its end-to-end value, is ``<base>``'s).
Adding a cell, a mix or a metric adds files and entries; no file here
changes."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import List

ROOT = Path(__file__).resolve().parent          # the benchmark's folder
REPO = ROOT.parent                              # the checkout


def load_benchmark(path: Path = REPO / "BENCHMARK.json") -> dict:
    return json.loads(Path(path).read_text())


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str, root: Path = ROOT) -> dict:
    return json.loads((root / "configs" / f"{name}.json").read_text())


def traffic(name: str, root: Path = ROOT) -> dict:
    return json.loads((root / "traffic" / f"{name}.json").read_text())


def base_name(name: str, root: Path = ROOT) -> str:
    """The name whose file reads metric ``name``: its own where
    ``metrics/<name>.py`` exists, else the name less its last dotted
    qualifier."""
    if (root / "metrics" / f"{name}.py").exists() or "." not in name:
        return name
    return name.rsplit(".", 1)[0]


def metric_reader(name: str, root: Path = ROOT) -> ModuleType:
    """The module ``metrics/<name>.py`` (see :func:`base_name`):
    ``UNIT``, ``LAYER``, ``MOVES`` and ``read(ctx)``, which returns the
    metric or None where the run has nothing for it to read."""
    name = base_name(name, root)
    path = root / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def end_to_end(bench: dict, cell: str) -> List[dict]:
    """The end-to-end metrics a cell reports: those without a
    ``workloads`` key, and those that list it."""
    return [m for m in bench["end_to_end"]
            if cell in m.get("workloads", [cell])]


def per_layer(bench: dict, cell: str) -> List[dict]:
    """The per-layer metrics a cell's traced run reports: those that list
    it, and those without a ``workloads`` key whose end-to-end metric the
    cell reports."""
    e2e = {m["name"] for m in end_to_end(bench, cell)}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in e2e
                             else [])]

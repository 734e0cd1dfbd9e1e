"""A cell's inputs from its configuration, its traffic mix and the seed:
the genome and the pool of reads, made by the benchmark's generator
(``sim.py``) and handed alike to the program and to the reference."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

from benchmark import sim


@dataclass
class Inputs:
    contigs: List[sim.FastaRecord]   # the genome, one record a contig
    pool: List[sim.PoolRead]         # the reads every call maps
    mapper: dict                     # MappingParams overrides of the cell

    @property
    def pool_bases(self) -> int:
        return sum(len(r.seq) for r in self.pool)


def sub_seeds(seed: int, n: int = 2) -> List[int]:
    """``n`` independent seeds from the run's ``--seed`` (any integer)."""
    ss = np.random.SeedSequence(int(seed) % (1 << 64))
    return [int(x) for x in ss.generate_state(n, dtype=np.uint64)]


def make(cfg: dict, mix: dict, seed: int) -> Inputs:
    """The genome from the configuration's ``genome_seed`` (a deployment
    maps against one reference), the reads from ``seed``: where each read
    lies, its strand, its errors and which length goes with which
    accuracy.  The lengths and the accuracies are the same sets for every
    seed (the mix's distributions at fixed quantiles), so every seed maps
    the same amount of work, in the same buckets."""
    contigs, _ = sim.recipe_genome(
        [(n, int(ln)) for n, ln in cfg["genome"]["contigs"]],
        cfg["genome_seed"], cfg["genome"].get("repeat_families", ()))
    ln, acc = mix["length"], mix["accuracy"]
    if ln["kind"] != "lognormal_quantiles":
        raise ValueError(f"unknown length kind {ln['kind']!r}")
    if acc["kind"] != "normal_quantiles":
        raise ValueError(f"unknown accuracy kind {acc['kind']!r}")
    n = mix["n_reads"]
    lens = sim.quantile_lengths(n, ln["mean"], ln["sd"], ln["min"],
                                ln["max"])
    accs = sim.quantile_accuracies(n, acc["mean"], acc["sd"], acc["min"])
    split = tuple(mix["error_split"][k] for k in ("ins", "del", "sub"))
    pool = sim.simulate_pool(contigs, lens, accs, sub_seeds(seed, 1)[0],
                             split, both_strands=mix.get("both_strands",
                                                         True))
    return Inputs(contigs, pool,
                  {**cfg.get("mapper", {}), **mix.get("mapper", {})})

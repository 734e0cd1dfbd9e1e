"""The benchmark's generator: deterministic for a seed, its mutate the
port's, its lengths, QVs and planted repeats as the data files say."""

import numpy as np
import pytest

from benchmark import inputs, registry, sim


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5])
def test_mutate_is_the_ports(seed):
    from blasr_tpu_torch.sim import mutate as port_mutate
    g = np.random.default_rng(seed % 1000).integers(0, 4, 5000,
                                                    dtype=np.int8)
    a = sim.mutate(g, np.random.default_rng(seed), 0.03, 0.075, 0.045)
    b = port_mutate(g, np.random.default_rng(seed), 0.03, 0.075, 0.045)
    assert np.array_equal(a, b)


def small_config(name="ecoli_k12"):
    cfg = dict(registry.config(name))
    fams = cfg["genome"]["repeat_families"][:2]
    cfg["genome"] = {
        "contigs": [["a", 300_000], ["b", 200_000], ["m", 40_000]],
        "repeat_families": [dict(f, n_full=3, n_solo=5) for f in fams]}
    return cfg


def test_inputs_deterministic_for_a_seed():
    mix = dict(registry.traffic("clr_fasta"), n_reads=40)
    mix["length"] = dict(mix["length"], max=20_000)
    a = inputs.make(small_config("scer_s288c"), mix, 2**31 + 11)
    b = inputs.make(small_config("scer_s288c"), mix, 2**31 + 11)
    c = inputs.make(small_config("scer_s288c"), mix, 12)
    for x, y in zip(a.contigs, b.contigs):
        assert np.array_equal(x.seq, y.seq)
    for x, y in zip(a.pool, b.pool):
        assert x.name == y.name and np.array_equal(x.seq, y.seq)
        assert (x.contig, x.tstart, x.strand) == (y.contig, y.tstart,
                                                  y.strand)
    # another seed maps other reads on the same genome: the same lengths
    # in another order, from other places
    for x, y in zip(a.contigs, c.contigs):
        assert np.array_equal(x.seq, y.seq)
    assert sorted(len(r.seq) for r in a.pool) == \
        sorted(len(r.seq) for r in c.pool)
    assert [len(r.seq) for r in a.pool] != [len(r.seq) for r in c.pool]
    assert not any((x.contig, x.tstart) == (y.contig, y.tstart)
                   for x, y in zip(a.pool, c.pool))
    assert a.mapper == {}


def test_lengths_and_accuracies_follow_the_mix():
    mix = registry.traffic("clr_fasta")
    ln, acc = mix["length"], mix["accuracy"]
    lens = sim.quantile_lengths(mix["n_reads"], ln["mean"], ln["sd"],
                                ln["min"], ln["max"])
    assert len(lens) == 2048
    assert lens.min() >= ln["min"] and lens.max() <= ln["max"]
    # the lognormal's mean and SD, a little under them where it is
    # clipped
    assert abs(lens.mean() - ln["mean"]) <= 0.01 * ln["mean"]
    assert abs(lens.std() - ln["sd"]) <= 0.02 * ln["sd"]
    assert int((lens > 16384).sum()) == 5
    accs = sim.quantile_accuracies(mix["n_reads"], acc["mean"], acc["sd"],
                                   acc["min"])
    assert accs.min() == acc["min"]
    assert abs(np.median(accs) - acc["mean"]) < 1e-3
    assert abs(accs.mean() - acc["mean"]) < 2e-3
    contigs = sim.random_genome(2_000_000, seed=1)
    pool = sim.simulate_pool(contigs, lens[:200], accs[:200], 5,
                             (0.6, 0.3, 0.1))
    assert {r.strand for r in pool} == {0, 1}
    # every seed maps reads of the same lengths, in another order
    other = sim.simulate_pool(contigs, lens[:200], accs[:200], 6,
                              (0.6, 0.3, 0.1))
    assert sorted(len(r.seq) for r in pool) == sorted(lens[:200].tolist())
    assert sorted(len(r.seq) for r in pool) == \
        sorted(len(r.seq) for r in other)
    assert [len(r.seq) for r in pool] != [len(r.seq) for r in other]


def test_reads_carry_the_error_profile():
    """85% accuracy: a 12-mer of a read is an exact copy of its template's
    with probability ~0.85^12 (each template base kept, unsubstituted and
    followed by no insertion with probability 0.85)."""
    g = sim.random_genome(200_000, seed=2)
    pool = sim.simulate_pool(g, np.full(40, 3000), np.full(40, 0.85), 9,
                             (0.5, 0.3, 0.2), both_strands=False)
    ident = []
    for r in pool:
        tmpl = g[0].seq[r.tstart:r.tstart + 3000]
        # the share of the read's 12-mers found in the template
        k = 12
        keys = {tmpl[i:i + k].tobytes() for i in range(len(tmpl) - k)}
        hits = sum(r.seq[i:i + k].tobytes() in keys
                   for i in range(0, len(r.seq) - k))
        ident.append(hits / (len(r.seq) - k))
    assert 0.08 < float(np.mean(ident)) < 0.25

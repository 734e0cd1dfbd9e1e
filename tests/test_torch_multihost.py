"""The port's multi-host launcher and merge (``blasr_tpu_torch/dist/
multihost.py``) on the CPU: per-host read shards of the port's CLI merged
by ``merge_outputs`` or ``run_sharded`` are byte-identical to one host's
output and to the JAX package's merged file (tests/test_multihost.py's
world); BAM parts stay per host.
"""

import os

import pytest

torch = pytest.importorskip("torch")

from blasr_tpu.dist import multihost as jhost  # noqa: E402
from blasr_tpu_torch.dist import multihost as thost  # noqa: E402
from blasr_tpu_torch.io.fasta import write_fasta  # noqa: E402
from blasr_tpu_torch.sim import random_genome, simulate_reads  # noqa: E402
from torch_shared import TORCH_THREADS, shared  # noqa: E402

torch.set_num_threads(TORCH_THREADS)

HOST_VARS = ("BLASR_TPU_NUM_HOSTS", "BLASR_TPU_HOST_ID", "WORLD_SIZE",
             "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


@pytest.fixture(autouse=True)
def no_host_vars(monkeypatch):
    for v in HOST_VARS:
        monkeypatch.delenv(v, raising=False)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """``build_world``, once per test run (tests/torch_shared.py)."""
    return shared(tmp_path_factory, __file__, "world", build_world)


def build_world(d):
    """tests/test_multihost.py's world (50 kb genome, 10 reads of 200-500
    bp), the port's single-host m4 of it, and the same run on two hosts
    through run_sharded: host 1 first, then host 0, which merges."""
    from blasr_tpu_torch.cli.blasr import run
    contigs = random_genome(50_000, seed=91)
    sims = simulate_reads(contigs, 10, read_len=(200, 500), accuracy=0.9,
                          seed=92)
    write_fasta(d / "g.fa", contigs)
    write_fasta(d / "r.fa", [s.rec for s in sims])
    base = [str(d / "r.fa"), str(d / "g.fa"), "-m", "4", "--hitPolicy",
            "randombest", "--randomSeed", "1"]
    with pytest.MonkeyPatch.context() as mp:
        for v in HOST_VARS:
            mp.delenv(v, raising=False)
        assert run(base + ["--out", str(d / "single.m4"), "--device",
                           "cpu"]) == 0
        on_hosts(mp, 2, lambda h: thost.run_sharded(
            base + ["--out", str(d / "merged.m4"), "--device", "cpu"],
            barrier_timeout=30))
    return d, base, (d / "single.m4").read_text()


def on_hosts(monkeypatch, n_hosts, call):
    """``call(host_id)`` for each host, host 1 first (it finishes before
    host 0 merges), under BLASR_TPU_NUM_HOSTS / BLASR_TPU_HOST_ID."""
    monkeypatch.setenv("BLASR_TPU_NUM_HOSTS", str(n_hosts))
    for h in list(range(1, n_hosts)) + [0]:
        monkeypatch.setenv("BLASR_TPU_HOST_ID", str(h))
        assert call(h) == 0


def test_shard_reads_partitions():
    assert sorted(i for h in range(3)
                  for i in thost.shard_reads(20, h, 3)) == list(range(20))
    s0 = thost.shard_reads(20, 0, 2, start=1, stride=2)
    s1 = thost.shard_reads(20, 1, 2, start=1, stride=2)
    assert sorted(s0 + s1) == list(range(1, 20, 2))
    assert not (set(s0) & set(s1))


def test_run_sharded_merges_and_cleans_up(world):
    """Two hosts of the port's CLI through run_sharded: host 0 waited for
    both sentinels and merged the parts into the single host's file byte
    for byte; parts and sentinels are gone."""
    d, _, single = world
    assert (d / "merged.m4").read_text() == single
    assert not list(d.glob("merged.m4.host*"))


def test_two_host_merge_equals_jax(world, monkeypatch):
    """The JAX package's CLI on the same two hosts, merged by its own
    merge_outputs, writes the port's merged file."""
    from blasr_tpu.cli.blasr import run as jax_run
    d, base, single = world
    jax_merged = str(d / "jax_merged.m4")
    on_hosts(monkeypatch, 2, lambda h: jax_run(base + ["--out", jax_merged]))
    jhost.merge_outputs(jax_merged, 2, [])
    assert open(jax_merged).read() == (d / "merged.m4").read_text() == single


@pytest.mark.parametrize("remove_parts", [True, False])
def test_merge_outputs_equals_jax(tmp_path, remove_parts):
    """merge_outputs on hand-written parts (host 0's header, record groups
    by '#@<read>' markers, a read with no records, out of order across
    hosts) writes JAX's merged file; parts are removed or kept as asked."""
    parts = {0: "@HD\tVN:1.5\n#@0\na 1\nb 1\n#@3\n#@4\nc 4\n",
             1: "@HD\tVN:1.5\n#@1\nd 2\n#@2\ne 3\nf 3\n#@5\ng 6\n"}
    out = {}
    for name, mod in (("port", thost), ("jax", jhost)):
        path = str(tmp_path / f"{name}.sam")
        for h, text in parts.items():
            with open(mod.shard_path(path, h, 2), "w") as f:
                f.write(text)
        mod.merge_outputs(path, 2, [], remove_parts=remove_parts)
        out[name] = open(path).read()
        assert all(os.path.exists(mod.shard_path(path, h, 2))
                   != remove_parts for h in parts)
    assert out["port"] == out["jax"] == \
        "@HD\tVN:1.5\na 1\nb 1\nd 2\ne 3\nf 3\nc 4\ng 6\n"


def test_run_sharded_leaves_bam_parts(world, monkeypatch):
    """With --bam each host's part stays a BAM of its own; no merged file
    and no sentinel is written.  (Every read is below --minReadLength:
    the rule, not the mapping, is under test.)"""
    from blasr_tpu_torch.io.bam import read_bam
    d, base, _ = world
    out = str(d / "out.bam")
    on_hosts(monkeypatch, 2, lambda h: thost.run_sharded(
        base + ["--bam", "--out", out, "--device", "cpu",
                "--minReadLength", "100000"]))
    assert not os.path.exists(out)
    for h in range(2):
        part = thost.shard_path(out, h, 2)
        assert not os.path.exists(part + ".done")
        assert "@HD" in read_bam(part)[0]


@pytest.mark.parametrize("env,want", [
    ({}, (0, 1)),
    ({"BLASR_TPU_NUM_HOSTS": "4", "BLASR_TPU_HOST_ID": "2"}, (2, 4)),
    ({"WORLD_SIZE": "3", "RANK": "1", "MASTER_ADDR": "localhost",
      "MASTER_PORT": "29500"}, (1, 3)),
    # the overrides come first, as the CLI reads them
    ({"BLASR_TPU_NUM_HOSTS": "2", "BLASR_TPU_HOST_ID": "1",
      "WORLD_SIZE": "8", "RANK": "5", "MASTER_ADDR": "localhost"}, (1, 2)),
    # WORLD_SIZE without a launcher's address is not a launch
    ({"WORLD_SIZE": "3", "RANK": "1"}, (0, 1)),
], ids=["none", "overrides", "torchrun", "overrides-first", "no-address"])
def test_init_distributed_reads_the_launcher(monkeypatch, env, want):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert thost.init_distributed() == want


@pytest.mark.parametrize("cuda", [True, False], ids=["card", "no-card"])
def test_init_distributed_picks_the_launchers_card(monkeypatch, cuda):
    """Under a torchrun launch with several processes on a host, each
    process's LOCAL_RANK becomes its ``cuda`` device (where CUDA is)."""
    import torch
    picked = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cuda)
    monkeypatch.setattr(torch.cuda, "set_device", picked.append)
    for k, v in {"WORLD_SIZE": "4", "RANK": "3", "LOCAL_RANK": "1",
                 "MASTER_ADDR": "localhost", "MASTER_PORT": "29500"}.items():
        monkeypatch.setenv(k, v)
    assert thost.init_distributed() == (3, 4)
    assert picked == ([1] if cuda else [])


@pytest.mark.parametrize("argv,want", [
    (["r.fa", "g.fa", "--out", "o.m4"], "o.m4"),
    (["r.fa", "g.fa", "-o", "o.sam", "--sam"], "o.sam"),
    (["r.fa", "g.fa", "--out=o.m4"], "o.m4"),
    (["r.fa", "g.fa", "-m", "4"], None),
])
def test_out_path_of_equals_jax(argv, want):
    assert thost._out_path_of(argv) == jhost._out_path_of(argv) == want

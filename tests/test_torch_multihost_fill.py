"""The host count changes lines where map_batch's SDP pass runs out of
rows, in the JAX package and in the PyTorch port alike, and the two
packages' two-host outputs are byte-identical (CPU).

map_batch gives the short-tuple SDP pass ``min(3 * n2, n_dp)`` rows of a
batch of ``n2`` strand rows: the top two candidates of each strand row,
then the rows with an anchor desert, then the rest in the batch's row
order (blasr_tpu/pipeline/map_read.py:659-675).  Where a batch holds more
candidates than that, which of them get the pass depends on the batch's
other reads, so a host that maps half the reads makes other choices than
one host mapping them all.  The reference behaves so; the port
reproduces it.

This world is chosen so that the fill binds, which is the aim here, not
a way to hide a defect: a 300 bp element planted twelve times into a
30 kb genome, each copy 4% diverged and every second copy 80 bp longer
in its middle, and 16 reads of ~450 bp at 85% accuracy over the copies,
one batch of the 512 bucket.  Each read has a candidate at most copies,
more than the pass's rows hold, and on the other subfamily's copies the
guide must cross the 80 bp gap, where the pass's fragments move the band.
No read takes the ambiguity rescue's deep pass.  Two hosts change three
reads' lines here (12 reads: one read).  The test fails if the world
stops binding.  With ``--sdpTupleSize 0`` (no SDP pass) one host and two
hosts agree."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from blasr_tpu.dist import multihost as jhost  # noqa: E402
from blasr_tpu_torch.dist import multihost as thost  # noqa: E402
from blasr_tpu_torch.io.fasta import FastaRecord, write_fasta  # noqa: E402
from blasr_tpu_torch.sim import mutate, random_genome  # noqa: E402
from test_torch_multihost import HOST_VARS, on_hosts  # noqa: E402
from torch_shared import TORCH_THREADS  # noqa: E402

torch.set_num_threads(TORCH_THREADS)


@pytest.fixture(autouse=True)
def no_host_vars(monkeypatch):
    for v in HOST_VARS:
        monkeypatch.delenv(v, raising=False)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("multihost_fill")
    rng = np.random.default_rng(6)
    g = random_genome(30_000, seed=93)[0].seq.copy()
    element = rng.integers(0, 4, 300).astype(np.int8)
    insert = rng.integers(0, 4, 80).astype(np.int8)
    starts = np.linspace(1000, 30_000 - 1000 - 380, 12).astype(int)
    for k, s in enumerate(starts):
        e = element.copy()
        m = rng.random(300) < 0.04
        e[m] = (e[m] + rng.integers(1, 4, int(m.sum()))) % 4
        if k % 2:  # the second subfamily: 80 bp more in the middle
            e = np.concatenate([e[:150], insert, e[150:]])
        g[s:s + len(e)] = e
    reads = []
    err = (1 - 0.85) / 3
    for i in range(16):
        a = starts[i % 12] - int(rng.integers(0, 150))
        seq = mutate(g[a:a + 450].copy(), rng, err, err, err)
        reads.append(FastaRecord(f"m/{i}/0_{len(seq)}", seq))
    write_fasta(d / "g.fa", [FastaRecord("contig0", g)])
    write_fasta(d / "r.fa", reads)
    return d


def one_and_two_hosts(d, monkeypatch, name, flags):
    """{package: (one host's m4, two hosts' merged m4)}: the JAX CLI's two
    hosts merged by its merge_outputs, the port's by run_sharded."""
    from blasr_tpu.cli.blasr import run as jax_run
    from blasr_tpu_torch.cli.blasr import run as port_run
    base = [str(d / "r.fa"), str(d / "g.fa"), "-m", "4"] + flags
    out = {k: str(d / f"{name}.{k}.m4")
           for k in ("jax1", "jax2", "port1", "port2")}
    assert jax_run(base + ["--out", out["jax1"]]) == 0
    assert port_run(base + ["--out", out["port1"], "--device", "cpu"]) == 0
    on_hosts(monkeypatch, 2, lambda h: jax_run(base + ["--out", out["jax2"]]))
    jhost.merge_outputs(out["jax2"], 2, [])
    on_hosts(monkeypatch, 2, lambda h: thost.run_sharded(
        base + ["--out", out["port2"], "--device", "cpu"],
        barrier_timeout=60))
    text = {k: open(p).read() for k, p in out.items()}
    return {"jax": (text["jax1"], text["jax2"]),
            "port": (text["port1"], text["port2"])}


def test_two_hosts_change_lines_as_in_jax(world, monkeypatch):
    got = one_and_two_hosts(world, monkeypatch, "sdp", [])
    assert got["port"] == got["jax"]
    one, two = got["port"]
    assert one and two and one != two


def test_without_sdp_pass_host_count_changes_nothing(world, monkeypatch):
    got = one_and_two_hosts(world, monkeypatch, "nosdp",
                            ["--sdpTupleSize", "0"])
    assert got["port"] == got["jax"]
    one, two = got["port"]
    assert one and one == two

"""The port's multi-device mapping (``blasr_tpu_torch/dist/mesh.py``) against
the JAX package's, on the CPU, exactly.

The worlds are tests/test_dist.py's (50 kb genome, B = 8, L = 256, k = 12,
and its shard-boundary world).  The port's collective paths run in two
and four spawned CPU ranks over gloo (``tests/torch_dist_rank.py``, no
JAX), the JAX package's on the 8 virtual CPU devices of
tests/conftest.py; every field is held with ``assert_array_equal``.
"""

import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import blasr_tpu.dist.mesh as jmesh  # noqa: E402
from blasr_tpu.index import build_genome_index  # noqa: E402
from blasr_tpu.params import MappingParams, ShapeConfig  # noqa: E402
from blasr_tpu.pipeline.map_read import DeviceIndex as JaxDeviceIndex  # noqa: E402
from blasr_tpu.pipeline.map_read import map_batch as jax_map_batch  # noqa: E402
from blasr_tpu.pipeline.map_read import unpack_batch as jax_unpack  # noqa: E402
from blasr_tpu.sim import random_genome  # noqa: E402
from blasr_tpu_torch.dist import mesh as tmesh  # noqa: E402
from blasr_tpu_torch.kernels.anchor import find_anchors  # noqa: E402
from blasr_tpu_torch.index.genome import \
    build_genome_index as t_build_genome_index  # noqa: E402
from blasr_tpu_torch.pipeline.map_read import (  # noqa: E402
    TAIL_WORDS, DeviceIndex, PackedBatch, map_batch, unpack_batch)
from test_dist import setup_world  # noqa: E402
from torch_dist_rank import finish_ranks, start_ranks  # noqa: E402
from torch_shared import TORCH_THREADS, shared  # noqa: E402

torch.set_num_threads(TORCH_THREADS)

B, L = 16, 256
FIELDS = ("score", "valid", "q_start", "q_end", "t_start", "t_end",
          "n_match", "n_mismatch", "n_ins", "n_del", "dp_slot",
          "chain_score", "chain_anchors", "n_anchors", "chain_valid",
          "cluster_bases", "cluster_valid", "overflow", "n_clipped")


def world():
    """tests/test_dist.py's world (50 kb genome, k = 12, L = 256): its eight
    simulated reads, then the eight reads of its boundary test, each
    across the overlap-free cut of two shards (B = 16).  Returns (gi,
    reads, lens, submat, gaps, static, the boundary reads' true starts)."""
    gi, _, reads, lens, submat, gaps, static = setup_world(8, L)
    cut = -(-len(gi.genome) // 2)
    rng = np.random.default_rng(5)
    reads = np.concatenate([reads, np.full((8, L), 4, dtype=np.int8)])
    lens = np.concatenate([lens, np.zeros(8, dtype=np.int32)])
    truth = []
    for i in range(8, B):
        start = cut - 100 - int(rng.integers(0, 60))
        seq = gi.genome[start:start + 220].copy()
        reads[i, : len(seq)] = seq
        lens[i] = len(seq)
        truth.append(start)
    return gi, reads, lens, submat, gaps, static, truth


INDEX_FIELDS = ("genome", "keys_sorted", "pos_sorted", "contig_starts",
                "contig_ends", "bucket_starts", "gwords", "gnwords",
                "pos_records")


def jax_ref_sharded(gi, reads, lens, submat, gaps, static):
    """JAX map_batch_ref_sharded on make_mesh(1, 2), with each shard's
    per_shard index and map_batch output captured (jax.debug.callback on
    the ref axis index)."""
    seen = {}

    def spy(idx, *a, **kw):
        res = jax_map_batch(idx, *a, **kw)

        def store(r, *arrs):
            seen[int(r)] = dict(zip(INDEX_FIELDS + ("ints", "ops",
                                                     "clusters"),
                                    [np.asarray(x) for x in arrs]))
        jax.debug.callback(store, jax.lax.axis_index("ref"),
                           *[getattr(idx, f) for f in INDEX_FIELDS],
                           res.ints, res.ops, res.clusters)
        return res

    real = jmesh.map_batch
    jmesh.map_batch = spy
    try:
        mesh = jmesh.make_mesh(1, 2)
        with mesh:
            out, offs, n_dp = jmesh.map_batch_ref_sharded(
                mesh, gi, reads, lens, submat, gaps, **static)
        jax.effects_barrier()
    finally:
        jmesh.map_batch = real
    return out, offs, n_dp, seen


def sdp_static(static):
    """The world's keywords with the SDP pass on (``--sdpTupleSize`` 11,
    as the CLI sets it): the pass takes three rows per strand row of the
    batch, filled in batch order, so a read's output depends on the reads
    batched with it."""
    return dict(static, k_sdp=11)


# how long each spawned rank may still run once the fixture's JAX runs are
# done (a hung rank fails the world here, not at the suite's clock)
RANKS_TIMEOUT = 300


@pytest.fixture(scope="module")
def dist_runs(tmp_path_factory):
    """The world's runs (``build_dist_runs``), built once per test run
    (tests/torch_shared.py)."""
    return shared(tmp_path_factory, __file__, "dist_runs", build_dist_runs)


def build_dist_runs(tmp):
    """The world's runs: the port's on two gloo ranks (ref-sharded on a
    (1, 2) mesh, data-parallel on (2, 1)) and on four (ref-sharded on
    (2, 2), data-parallel on (4, 1)), all ranks together, and meanwhile
    JAX's ref-sharded runs on make_mesh(1, 2) and make_mesh(2, 2), JAX's
    map_batch_data_parallel on make_mesh(2, 1) with the SDP pass on, and
    the port's shard_index(gi, 2, fast_path=True)."""
    w = world()
    gi, reads, lens, submat, gaps, static, _ = w
    inp = os.path.join(tmp, "world.npz")
    np.savez(inp, reads=reads, lens=lens, submat=np.asarray(submat),
             gaps=np.asarray(gaps))
    ref = dict(name="ref", kind="ref", n_data=1, n_ref=2, glen=50_000,
               gseed=21, inputs=inp, static=static)
    data = dict(ref, name="data", kind="data", n_data=2, n_ref=1,
                static=sdp_static(static))
    os.makedirs(tmp / "four")
    started = [start_ranks(tmp, [ref, data]),
               start_ranks(tmp / "four", [
                   dict(ref, name="ref22", n_data=2, n_ref=2),
                   dict(data, name="data4", n_data=4)], world=4)]
    try:
        jax_out = jax_ref_sharded(*w[:6])
        mesh = jmesh.make_mesh(2, 2)
        with mesh:
            jax22 = jmesh.map_batch_ref_sharded(mesh, *w[:5], **static)
        mesh = jmesh.make_mesh(2, 1)
        with mesh:
            jax_dp = jmesh.map_batch_data_parallel(
                mesh, JaxDeviceIndex.from_host(gi), jnp.asarray(reads),
                jnp.asarray(lens), submat, gaps, **sdp_static(static))
        shards = tmesh.shard_index(gi, 2, fast_path=True)
    finally:
        port = {}
        for s in started:
            port.update(finish_ranks(s, timeout=RANKS_TIMEOUT))
    return w, port, jax_out, shards, jax22, jax_dp


# ------------------------------------------------------------ host pieces

@pytest.mark.parametrize("n_shards,fast_path",
                         [(2, False), (2, True), (4, False), (4, True)])
def test_shard_index_equals_jax(n_shards, fast_path):
    gi = build_genome_index(random_genome(30_000, seed=3), k=12)
    want = jmesh.shard_index(gi, n_shards, overlap=500, fast_path=fast_path)
    got = tmesh.shard_index(t_build_genome_index(
        random_genome(30_000, seed=3), k=12), n_shards, overlap=500,
        fast_path=fast_path)
    assert len(got) == len(want)
    for a, b in zip(got[:4], want[:4]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    if fast_path:
        assert sorted(got[4]) == sorted(want[4])
        for f in want[4]:
            assert got[4][f].dtype == want[4][f].dtype
            np.testing.assert_array_equal(got[4][f], want[4][f])


def test_globalize_sharded_exact_past_int32():
    """tests/test_dist.py's >4 Gbp layout through the port's
    globalize_sharded: int64, exact past 2^31, equal to JAX's."""
    n_dp = 8
    offs = np.arange(8, dtype=np.int64) * 600_000_000
    slot = np.tile(np.arange(4, dtype=np.int32) * n_dp + 1, (2, 1))
    slot[1, 2] = -1
    ts_local = np.full((2, 4), 2_000_000, dtype=np.int32)
    res = SimpleNamespace(dp_slot=slot, t_start=ts_local,
                          t_end=ts_local + 1500)
    far = SimpleNamespace(dp_slot=np.full((1, 1), 7 * n_dp, np.int32),
                          t_start=np.full((1, 1), 3_000_000, np.int32),
                          t_end=np.full((1, 1), 3_001_500, np.int32))
    for r in (res, far):
        got = tmesh.globalize_sharded(r, offs, n_dp)
        want = jmesh.globalize_sharded(r, offs, n_dp)
        for a, b in zip(got, want):
            assert a.dtype == np.int64
            np.testing.assert_array_equal(a, b)
    ts, te = tmesh.globalize_sharded(far, offs, n_dp)
    assert int(ts[0, 0]) == 4_203_000_000 and int(te[0, 0]) == 4_203_001_500
    assert tmesh.globalize_sharded(res, offs, n_dp)[0][1, 2] == 2_000_000


# ------------------------------------------------------ the shard index

@pytest.mark.parametrize("s", [0, 1])
def test_shard_device_index_equals_jax_per_shard(dist_runs, s):
    """shard_device_index's arrays are the JAX per_shard index's (captured
    inside shard_map), as the port holds them: int64 keys and positions,
    the records' RECORDS_PAD tail, bucket_pairs from bucket_starts."""
    w, _, jax_out, shards = dist_runs[:4]
    want = jax_out[3][s]
    idx = tmesh.shard_device_index(w[0], shards, s, "cpu")
    for f in INDEX_FIELDS:
        got = getattr(idx, f).numpy()
        ref = want[f]
        if f == "pos_records":
            ref = ref.view(np.int32)
            tail = got[ref.shape[0]:]
            assert tail.shape == (DeviceIndex.RECORDS_PAD, 6)
            assert (tail[:, :2] == 0).all() and (tail[:, 2:] == -1).all()
            got = got[: ref.shape[0]]
        elif f in ("keys_sorted", "pos_sorted", "contig_starts",
                   "contig_ends", "gwords", "gnwords"):
            assert got.dtype == np.int64, f
            ref = ref.astype(np.int64)
        assert got.dtype == ref.dtype, f
        np.testing.assert_array_equal(got, ref, err_msg=f)
    bs = idx.bucket_starts
    assert torch.equal(idx.bucket_pairs[:, 0], bs[:-1])
    assert torch.equal(idx.bucket_pairs[:, 1], bs[1:])
    G = idx.genome.shape[0]
    assert torch.equal(idx.genome_pad[:G], idx.genome)
    assert idx.genome_pad.shape[0] == G + DeviceIndex.GENOME_PAD
    assert (idx.genome_pad[G:] == 4).all()


def test_shard_index_without_bucket_pairs_finds_the_same_anchors(dist_runs):
    """The JAX shard index has no bucket_pairs; the port derives them from
    bucket_starts.  find_anchors, map_batch's one reader of either, gives
    the same anchors with both LUT forms."""
    w, _, _, shards = dist_runs[:4]
    gi, reads, lens, _, _, static, _ = w
    idx = tmesh.shard_device_index(gi, shards, 1, "cpu")
    reads2 = torch.from_numpy(reads)
    rlen2 = torch.from_numpy(lens)
    kw = dict(k=12, occ_per_pos=static["O"], max_anchors=static["A"],
              anchor_ext=static["E"], min_match=static["min_match"],
              max_anchors_per_pos=static["max_anchors_per_pos"],
              max_lcp=static["max_lcp"], bucket_starts=idx.bucket_starts,
              gwords=idx.gwords, gnwords=idx.gnwords,
              pos_records=idx.pos_records)
    args = (idx.genome, idx.keys_sorted, idx.pos_sorted, reads2, rlen2)
    a = find_anchors(*args, bucket_pairs=idx.bucket_pairs, **kw)
    b = find_anchors(*args, bucket_pairs=None, **kw)
    assert int(a.n_total.sum()) > 0
    for x, y in zip(a, b):
        assert torch.equal(x, y)


# ------------------------------------------------------------- the merge

# two shards' seed-count words, all zero
NO_SEEDS = torch.zeros((2, TAIL_WORDS - 2), dtype=torch.int32)


def captured_stack(jax_out):
    seen = jax_out[3]
    return [torch.from_numpy(np.stack([seen[s][f] for s in (0, 1)]))
            for f in ("ints", "ops", "clusters")]


def test_merge_equals_jax_on_captured_shard_outputs(dist_runs):
    """merge_ref_shards alone, on the JAX shards' own map_batch outputs
    (captured inside shard_map), equals JAX's merged batch."""
    jax_out = dist_runs[2]
    got = tmesh.merge_ref_shards(*captured_stack(jax_out),
                                 torch.zeros(2, dtype=torch.int32),
                                 torch.zeros(2, dtype=torch.int32),
                                 NO_SEEDS)
    for f in ("ints", "ops", "clusters"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(jax_out[0], f)))
    assert got.flat[-1] == 0


def test_merge_carries_any_shards_fault(dist_runs):
    """A K1 slope fault in one shard is the merged flat's last word, so
    unpack_batch raises on it."""
    jax_out = dist_runs[2]
    stack = captured_stack(jax_out)
    used = torch.zeros(2, dtype=torch.int32)
    ok = tmesh.merge_ref_shards(*stack, torch.tensor([0, 0], dtype=torch.int32),
                                used, NO_SEEDS)
    unpack_batch(ok)
    bad = tmesh.merge_ref_shards(*stack, torch.tensor([0, 1], dtype=torch.int32),
                                 used, NO_SEEDS)
    assert torch.equal(bad.flat[:-1], ok.flat[:-1]) and bad.flat[-1] == 1
    with pytest.raises(ValueError):
        unpack_batch(bad)


# ---------------------------------------------------- the collective paths

@pytest.mark.parametrize("rank", [0, 1])
def test_ref_sharded_equals_jax(dist_runs, rank):
    """The port's map_batch_ref_sharded on each of two gloo ranks equals
    JAX's on make_mesh(1, 2): every array, the offsets and n_dp, every
    unpacked field and the globalized coordinates."""
    port, (out, offs, n_dp, _) = dist_runs[1:3]
    got = port["ref"][rank]
    for f in ("ints", "ops", "clusters"):
        np.testing.assert_array_equal(got[f], np.asarray(getattr(out, f)))
    assert got["flat"][-1] == 0
    assert got["offs"].dtype == np.int64 and int(got["n_dp"]) == n_dp
    np.testing.assert_array_equal(got["offs"], offs)
    res = unpack_batch(PackedBatch(*(torch.from_numpy(got[f]) for f in
                                     ("ints", "ops", "clusters", "flat"))))
    want = jax_unpack(out)
    for f in FIELDS + ("ops",):
        np.testing.assert_array_equal(getattr(res, f), getattr(want, f),
                                      err_msg=f)
    for a, b in zip(tmesh.globalize_sharded(res, got["offs"], n_dp),
                    jmesh.globalize_sharded(want, offs, n_dp)):
        assert a.dtype == np.int64
        np.testing.assert_array_equal(a, b)


def test_ref_sharded_places_boundary_reads(dist_runs):
    """tests/test_dist.py's boundary reads, through the port's two ranks:
    the overlap recovers them and globalize_sharded puts each best
    candidate at its true start (within 50 bp) on the forward strand."""
    w, port = dist_runs[:2]
    truth = w[6]
    got = port["ref"][0]
    res = unpack_batch(PackedBatch(*(torch.from_numpy(got[f]) for f in
                                     ("ints", "ops", "clusters", "flat"))))
    ts, _ = tmesh.globalize_sharded(res, got["offs"], int(got["n_dp"]))
    found = 0
    for i, start in enumerate(truth, 8):
        ok = res.valid[i] & (res.dp_slot[i] >= 0)
        if ok.any():
            best = int(np.argmin(np.where(ok, res.score[i], 1 << 30)))
            found += abs(int(ts[i][best]) - start) <= 50
    assert found >= int(len(truth) * 0.9), f"{found}/{len(truth)}"


def batch_of(got) -> PackedBatch:
    return PackedBatch(*(torch.from_numpy(got[f]) for f in
                         ("ints", "ops", "clusters", "flat")))


def test_data_parallel_equals_single_map_batch(dist_runs):
    """map_batch_data_parallel over two gloo ranks, with the SDP pass on:
    every rank returns the whole batch's output, equal array for array to
    JAX's map_batch_data_parallel on make_mesh(2, 1) and to the port's one
    map_batch over the whole batch.  The world binds map_batch's
    batch-level choices: a block mapped as a batch of its own gives other
    arrays for its reads."""
    w, port = dist_runs[:2]
    gi, reads, lens, submat, gaps, static, _ = w
    jax_dp = dist_runs[5]
    index = DeviceIndex.from_host(
        t_build_genome_index(random_genome(50_000, seed=21), k=12), "cpu")
    g6 = [4.0, 4.0, 5.0, 5.0, 0.0, 0.0]
    m = np.array(submat)
    kw = sdp_static(static)
    whole = map_batch(index, torch.from_numpy(reads), torch.from_numpy(lens),
                      m, g6, **kw)
    for f in ("ints", "ops", "clusters"):
        np.testing.assert_array_equal(getattr(whole, f).numpy(),
                                      np.asarray(getattr(jax_dp, f)),
                                      err_msg=f)
    b = B // 2
    block = map_batch(index, torch.from_numpy(reads[:b]),
                      torch.from_numpy(lens[:b]), m, g6, **kw)
    rows = np.r_[0:b, B:B + b]
    assert not np.array_equal(block.ints.numpy(), whole.ints.numpy()[rows])
    # so does the JAX package's: a read's output depends on its batch
    # mates there too, which is why hosts that batch other reads can write
    # other lines for it (run_sharded)
    jax_block = jax_map_batch(JaxDeviceIndex.from_host(gi),
                              jnp.asarray(reads[:b]), jnp.asarray(lens[:b]),
                              submat, gaps, **kw)
    np.testing.assert_array_equal(block.ints.numpy(),
                                  np.asarray(jax_block.ints))
    for got in port["data"]:
        for f in ("ints", "ops", "clusters", "flat"):
            np.testing.assert_array_equal(got[f], getattr(whole, f).numpy(),
                                          err_msg=f)
        res, want = unpack_batch(batch_of(got)), jax_unpack(jax_dp)
        for f in FIELDS + ("ops",):
            np.testing.assert_array_equal(getattr(res, f), getattr(want, f),
                                          err_msg=f)


@pytest.mark.parametrize("rank", [0, 1, 2, 3])
def test_data_parallel_four_ranks_equals_jax(dist_runs, rank):
    """map_batch_data_parallel over four gloo ranks (a (4, 1) mesh, blocks
    of four reads) returns JAX's data-parallel output on every rank."""
    got, jax_dp = dist_runs[1]["data4"][rank], dist_runs[5]
    for f in ("ints", "ops", "clusters"):
        np.testing.assert_array_equal(got[f], np.asarray(getattr(jax_dp, f)),
                                      err_msg=f)
    assert got["flat"][-1] == 0


@pytest.mark.parametrize("ref", [0, 1])
def test_ref_sharded_2x2_equals_jax(dist_runs, ref):
    """map_batch_ref_sharded on a (2, 2) mesh of four gloo ranks: the
    data blocks of the ranks at ref coordinate ``ref``, concatenated in
    data order, are JAX's output on make_mesh(2, 2) (rows per data block
    [fwd, rc], ops of a block at stride R * n_dp), with its offsets,
    n_dp and globalized coordinates."""
    out, offs, n_dp = dist_runs[4]
    ranks = [dist_runs[1]["ref22"][d * 2 + ref] for d in range(2)]
    for f in ("ints", "ops", "clusters"):
        np.testing.assert_array_equal(
            np.concatenate([g[f] for g in ranks]),
            np.asarray(getattr(out, f)), err_msg=f)
    for g in ranks:
        assert g["flat"][-1] == 0 and int(g["n_dp"]) == n_dp
        np.testing.assert_array_equal(g["offs"], offs)
    want = jax_unpack(out)
    got = [unpack_batch(batch_of(g)) for g in ranks]
    for f in FIELDS:
        np.testing.assert_array_equal(
            np.concatenate([getattr(r, f) for r in got]), getattr(want, f),
            err_msg=f)
    ts = [tmesh.globalize_sharded(r, offs, n_dp) for r in got]
    for i, a in enumerate(jmesh.globalize_sharded(want, offs, n_dp)):
        np.testing.assert_array_equal(np.concatenate([t[i] for t in ts]), a)

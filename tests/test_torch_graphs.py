"""The graph layer of the port's Mapper (``blasr_tpu_torch/pipeline/graphs.py``),
as far as it runs without a card, and the padded genome it gathers windows
from.

* The cache key of a map_batch call (:func:`graphs.graph_key`) differs
  whenever a static keyword of ``map_batch``, a value of its positional
  arguments, the batch size or the index differs, and is equal otherwise.
* The Mappers that ``Mapper._expanded`` builds for each retry share their
  index, so they share its graph cache, and a retry of the same level
  finds the graphs of the one before; the cache goes with the index.
* A replay copies its inputs into the graph's static buffers and adds the
  launches the graph holds to ``cuda_ops.LAUNCHES`` (a fake graph stands
  in for a captured one).
* ``eager_dispatch()`` restores its state after an exception.
* ``map_batch`` on an index from ``DeviceIndex.from_host``, whose windows
  come from the padded genome, equals the JAX ``map_batch`` exactly on a
  small world whose last contig is shorter than a window, so that its
  windows read past the genome's end.

Capture and replay on the card are tests/test_torch_cuda.py's.
"""

import gc

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from blasr_tpu.index.genome import build_genome_index  # noqa: E402
from blasr_tpu.io.fasta import FastaRecord  # noqa: E402
from blasr_tpu.params import MappingParams  # noqa: E402
from blasr_tpu.pipeline import map_read as jmr  # noqa: E402
from blasr_tpu.sim import random_genome  # noqa: E402
from blasr_tpu_torch.kernels import cuda_ops  # noqa: E402
from blasr_tpu_torch.pipeline import graphs  # noqa: E402
from blasr_tpu_torch.pipeline import map_read as tmr  # noqa: E402
from test_torch_stages import small_world  # noqa: E402
from torch_shared import TORCH_THREADS  # noqa: E402

torch.set_num_threads(TORCH_THREADS)

L = 512


@pytest.fixture(scope="module")
def mapper():
    gi = build_genome_index(random_genome(5_000, seed=1), k=12)
    return tmr.Mapper(gi, MappingParams().make_sane(), device="cpu")


def _key_args(mapper):
    pos, kw = mapper._batch_call_args(L)
    return mapper.dev, mapper.batch_size_for(L), pos, kw


def _changed(value):
    if isinstance(value, bool):
        return not value
    if isinstance(value, int):
        return value + 1
    return value + 0.5


STATIC = ["cfg_k", "L", "W", "w_b", "C", "A", "O", "E", "T", "max_chain",
          "min_match", "max_anchors_per_pos", "max_lcp", "indel_rate",
          "C_dp", "use_pallas", "p_value_type", "lookback", "global_chain",
          "aggressive_cut", "advance_exact", "k_sdp", "sdp_occ",
          "between_only", "use_hp", "use_qv", "qv_score_type",
          "occ_block_sample", "cand_drift", "full_widen", "tb_cap"]
CHANGES = (["same"] + [f"kw:{k}" for k in STATIC]
           + [f"pos:{i}" for i in range(5)] + ["batch", "index"])


def test_static_names_are_map_batchs_keywords(mapper):
    """STATIC lists every keyword _batch_call_args passes, and each is a
    keyword-only argument of map_batch."""
    import inspect
    _, _, _, kw = _key_args(mapper)
    assert sorted(kw) == sorted(STATIC)
    params = inspect.signature(tmr.map_batch).parameters
    assert all(params[k].kind == params[k].KEYWORD_ONLY for k in STATIC)


@pytest.mark.parametrize("change", CHANGES)
def test_graph_key_tracks_every_static_argument(mapper, change):
    index, batch, pos, kw = _key_args(mapper)
    key = graphs.graph_key(index, batch, pos, kw)
    # the same call rebuilt: new objects, equal values
    index2, batch2, pos2, kw2 = _key_args(mapper)
    pos2 = [np.array(pos2[0]), list(pos2[1]), *pos2[2:]]
    kw2 = dict(kw2)
    what, _, name = change.partition(":")
    if what == "kw":
        kw2[name] = _changed(kw2[name])
    elif what == "pos":
        i = int(name)
        if i == 0:
            pos2[0] = pos2[0].copy()
            pos2[0][3] += 1.0
        elif i == 1:
            pos2[1][2] += 1.0
        else:
            pos2[i] = np.float32(pos2[i] + 1.0)
    elif what == "batch":
        batch2 += 1
    elif what == "index":
        # the same arrays but another tensor in one field
        index2 = index2._replace(pos_sorted=index2.pos_sorted.clone())
    key2 = graphs.graph_key(index2, batch2, tuple(pos2), kw2)
    assert hash(key2) is not None
    assert (key2 == key) == (change == "same"), change


def test_expanded_mappers_share_the_cache(mapper):
    """A retry Mapper is a new object on the same index: one cache, and a
    retry of the same level gets the key of the one before (so it replays
    that graph); another level's shapes differ."""
    r1, r2 = mapper._expanded(1), mapper._expanded(1)
    assert r1.dev is mapper.dev and r2.dev is mapper.dev
    assert graphs.cache_for(r1.dev) is graphs.cache_for(mapper.dev)
    k1 = graphs.graph_key(*_key_args(r1))
    assert k1 == graphs.graph_key(*_key_args(r2))
    assert k1 != graphs.graph_key(*_key_args(mapper))


def test_cache_goes_with_the_index():
    gi = build_genome_index(random_genome(3_000, seed=2), k=12)
    ix = tmr.DeviceIndex.from_host(gi, "cpu")
    key = id(ix.genome)
    graphs.cache_for(ix)
    assert key in graphs._CACHES
    del ix
    gc.collect()
    assert key not in graphs._CACHES


class _FakeGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_replay_copies_inputs_and_counts_launches():
    B = 3
    fake = _FakeGraph()
    static = (torch.zeros((B, L), dtype=torch.int8),
              torch.zeros(B, dtype=torch.int32))
    qv = tuple(torch.zeros((B, L), dtype=torch.int32) for _ in range(2))
    rescore = torch.zeros(4)
    out = object()
    bg = graphs.BatchGraph(fake, *static, out,
                           {"chain_scan": 2, "band_offsets": 2,
                            "banded_dp_qv": 1, "banded_dp": 0},
                           qv=qv, qv_rescore=rescore)
    cuda_ops.reset_launch_counts()
    rng = np.random.default_rng(5)
    for n in range(1, 4):
        reads = torch.from_numpy(rng.integers(0, 5, (B, L)).astype(np.int8))
        lens = torch.tensor([L, n, 0], dtype=torch.int32)
        q = tuple(torch.full((B, L), n + j, dtype=torch.int32)
                  for j in range(2))
        assert bg.replay(reads, lens, q, torch.full((4,), float(n))) is out
        assert torch.equal(bg.reads, reads) and torch.equal(bg.lens, lens)
        assert all(torch.equal(s, x) for s, x in zip(bg.qv, q))
        assert torch.equal(bg.qv_rescore, torch.full((4,), float(n)))
        assert fake.replays == n
        assert cuda_ops.LAUNCHES["chain_scan"] == 2 * n
        assert cuda_ops.LAUNCHES["band_offsets"] == 2 * n
        assert cuda_ops.LAUNCHES["banded_dp_qv"] == n
        assert sum(cuda_ops.LAUNCHES.values()) == 5 * n
    cuda_ops.reset_launch_counts()


def test_replay_counts_member_paths():
    """A replay adds the K7 paths its capture took to MEMBER_PATHS, as it
    adds the launches, and a reset zeroes both."""
    B = 2
    static = (torch.zeros((B, L), dtype=torch.int8),
              torch.zeros(B, dtype=torch.int32))
    bg = graphs.BatchGraph(_FakeGraph(), *static, object(),
                           {"chain_members": 2},
                           member_paths={"lift": 1, "global": 1})
    cuda_ops.reset_launch_counts()
    for n in range(1, 3):
        bg.replay(*static)
        assert cuda_ops.LAUNCHES["chain_members"] == 2 * n
        assert cuda_ops.MEMBER_PATHS == {"lift": n, "chase": 0, "global": n}
    cuda_ops.reset_launch_counts()
    assert cuda_ops.MEMBER_PATHS == {"lift": 0, "chase": 0, "global": 0}


def test_eager_dispatch_restores_its_state():
    assert not graphs._eager
    with pytest.raises(RuntimeError, match="inside"):
        with graphs.eager_dispatch():
            assert graphs._eager
            with graphs.eager_dispatch():
                assert graphs._eager
            assert graphs._eager
            raise RuntimeError("inside")
    assert not graphs._eager


def test_cpu_dispatch_is_eager_and_counted(mapper):
    """On the CPU dispatch calls map_batch itself: no capture, no cache
    entry, one pass counted by its kind."""
    index, batch, pos, kw = _key_args(mapper)
    graphs.reset_counts()
    n_cached = len(graphs.cache_for(index).graphs)
    reads = torch.full((2, L), 4, dtype=torch.int8)
    lens = torch.zeros(2, dtype=torch.int32)
    pb = graphs.dispatch(index, reads, lens, pos, kw)
    assert pb.flat is not None and int(pb.flat[-1]) == 0
    assert graphs.DISPATCHES == {"batches": 1, "dense_reruns": 0,
                                 "captures": 0, "replays": 0, "waited": 0}
    assert len(graphs.cache_for(index).graphs) == n_cached
    mapper.warmup([L])                       # captures nothing on the CPU
    assert graphs.DISPATCHES["captures"] == 0


def test_padded_index_map_batch_matches_jax():
    contigs, recs = small_world()
    # a last contig shorter than the bucket's window, and a read from it:
    # its windows run past the end of the genome into the pad
    tail = random_genome(700, seed=5)[0]
    contigs = list(contigs) + [type(tail)("tail", tail.seq)]
    recs = [FastaRecord("tail/0/0_450", tail.seq[120:570])] + list(recs)
    gi = build_genome_index(contigs, k=12)
    params = MappingParams().make_sane()
    jm = jmr.Mapper(gi, params)
    batch = jm.batch_size_for(L)
    group = [r for r in recs if len(r.seq) <= L][:batch]
    arr = np.full((batch, L), 4, np.int8)
    lens = np.zeros(batch, np.int32)
    for i, r in enumerate(group):
        arr[i, :len(r.seq)] = r.seq
        lens[i] = len(r.seq)
    pos, kw = jm._batch_call_args(L)
    want = np.asarray(jmr.map_batch(jm.dev, jnp.asarray(arr),
                                    jnp.asarray(lens), *pos, **kw).flat)

    tm = tmr.Mapper(gi, params, device="cpu")
    ix = tm.dev
    G = gi.genome.shape[0] + 1
    assert ix.genome_pad.shape[0] >= G + kw["W"]
    assert ix.genome.data_ptr() == ix.genome_pad.data_ptr()
    assert (ix.genome_pad[G:] == 4).all()
    tpos, tkw = tm._batch_call_args(L)
    got = graphs.dispatch(ix, torch.from_numpy(arr), torch.from_numpy(lens),
                          tpos, tkw)
    res = tmr.unpack_batch(got)
    assert res.valid[0].any()                 # the tail read aligned
    ts = res.t_start[0][res.valid[0]]
    assert (ts >= G - 1 - 700).all()          # on the short last contig
    assert int(got.flat[-1]) == 0
    np.testing.assert_array_equal(want, got.flat.numpy()[:-tmr.TAIL_WORDS])

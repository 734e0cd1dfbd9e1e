"""map_batch of the PyTorch port against the JAX package: the packed
``flat`` result buffer (every column, the cluster list and the traceback
pairs) must be bit-identical for a bucket-512 batch of the golden small
world, fed the same device index arrays."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from blasr_tpu.index.genome import build_genome_index  # noqa: E402
from blasr_tpu.params import MappingParams  # noqa: E402
from blasr_tpu.pipeline import map_read as jmr  # noqa: E402
from blasr_tpu_torch.pipeline import map_read as tmr  # noqa: E402
from test_torch_stages import jax_index_arrays, small_world  # noqa: E402

torch.set_num_threads(2)


def test_map_batch_flat_matches_jax():
    contigs, recs = small_world()
    gi = build_genome_index(contigs, k=12)
    params = MappingParams().make_sane()
    jm = jmr.Mapper(gi, params)
    L = 512
    batch = jm.batch_size_for(L)
    group = [r for r in recs if len(r.seq) <= L][:batch]
    assert len(group) >= 3
    arr = np.full((batch, L), 4, np.int8)
    lens = np.zeros(batch, np.int32)
    for i, r in enumerate(group):
        arr[i, :len(r.seq)] = r.seq
        lens[i] = len(r.seq)
    pos, kw = jm._batch_call_args(L)
    want = jmr.map_batch(jm.dev, jnp.asarray(arr), jnp.asarray(lens),
                         *pos, **kw)

    tm = tmr.Mapper(gi, params, device="cpu",
                    dev=tmr.device_index_from_jax_arrays(
                        jax_index_arrays(jm.dev), "cpu"))
    tpos, tkw = tm._batch_call_args(L)
    got = tmr.map_batch(tm.dev, torch.from_numpy(arr),
                        torch.from_numpy(lens), *tpos, **tkw)
    w = np.asarray(want.flat)
    g = got.flat.numpy()
    assert w.dtype == g.dtype and w.shape == g.shape
    res = tmr.unpack_batch(got)
    assert res.valid.any() and (res.dp_slot >= 0).any()
    np.testing.assert_array_equal(w, g)


def _qv_reads(recs, rng):
    """The small world's reads with QVs in every flavour pack_qv_rows
    knows: FASTQ qualities 8-39 (most reads), one read with a constant
    quality string (flat costs), one with full IDS tracks and tags."""
    out = []
    for i, r in enumerate(recs):
        n = len(r.seq)
        qual = rng.integers(8, 40, n).astype(np.int32)
        tracks = None
        if i == 1:
            qual = np.full(n, 20, np.int32)
        elif i == 2:
            tags = np.frombuffer(b"ACGTN", np.uint8)
            tracks = {"InsertionQV": rng.integers(2, 30, n).astype(np.uint8),
                      "DeletionQV": rng.integers(2, 30, n).astype(np.uint8),
                      "SubstitutionQV": rng.integers(2, 30, n).astype(
                          np.uint8),
                      "DeletionTag": rng.choice(tags, n),
                      "SubstitutionTag": rng.choice(tags, n)}
        out.append(type(r)(r.title, r.seq, qual, tracks))
    return out


@pytest.mark.parametrize("score_type", [0, 1])
def test_map_batch_qv_flat_matches_jax(score_type):
    """--useQuality: the QV-steered DP on FASTQ-like reads (plus one
    constant-quality and one IDS-track read), both strands, and the
    distance rescore of the traced rows (scoreType 0) or the QV score
    (scoreType 1): the packed buffer equals the JAX map_batch's."""
    contigs, recs = small_world()
    recs = _qv_reads(recs, np.random.default_rng(90 + score_type))
    gi = build_genome_index(contigs, k=12)
    params = MappingParams(ignore_qualities=False,
                           score_type=score_type).make_sane()
    jm = jmr.Mapper(gi, params)
    L = 512
    batch = jm.batch_size_for(L)
    group = [r for r in recs if len(r.seq) <= L][:batch]
    assert len(group) >= 3
    arr = np.full((batch, L), 4, np.int8)
    lens = np.zeros(batch, np.int32)
    for i, r in enumerate(group):
        arr[i, :len(r.seq)] = r.seq
        lens[i] = len(r.seq)
    q1, q2 = jm.pack_qv_rows(group, batch, L)
    pos, kw = jm._batch_call_args(L)
    assert kw["use_qv"]
    want = jmr.map_batch(jm.dev, jnp.asarray(arr), jnp.asarray(lens), *pos,
                         qv1=jnp.asarray(q1), qv2=jnp.asarray(q2),
                         qv_rescore=jm.qv_rescore, **kw)

    tm = tmr.Mapper(gi, params, device="cpu",
                    dev=tmr.device_index_from_jax_arrays(
                        jax_index_arrays(jm.dev), "cpu"))
    t1, t2 = tm.pack_qv_rows(group, batch, L)
    np.testing.assert_array_equal(q1, t1)
    np.testing.assert_array_equal(q2, t2)
    tpos, tkw = tm._batch_call_args(L)
    got = tmr.map_batch(tm.dev, torch.from_numpy(arr),
                        torch.from_numpy(lens), *tpos,
                        qv1=torch.from_numpy(t1), qv2=torch.from_numpy(t2),
                        qv_rescore=tm.qv_rescore, **tkw)
    res = tmr.unpack_batch(got)
    assert res.valid.any() and (res.dp_slot >= 0).any()
    np.testing.assert_array_equal(np.asarray(want.flat), got.flat.numpy())


def test_revcomp_qv_matches_jax():
    rng = np.random.default_rng(3)
    B, L = 4, 64
    qv = rng.integers(0, 2**30, (B, L)).astype(np.int32)
    lens = np.array([64, 40, 1, 0], np.int32)
    for shifts in ((), (24, 27)):
        want = jmr._revcomp_qv(jnp.asarray(qv), jnp.asarray(lens),
                               tag_shifts=shifts)
        got = tmr._revcomp_qv(torch.from_numpy(qv), torch.from_numpy(lens),
                              tag_shifts=shifts)
        np.testing.assert_array_equal(np.asarray(want), got.numpy())

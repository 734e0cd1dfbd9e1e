"""Per-stage parity of the PyTorch port against the JAX package on the
golden small world (60 kb, 2 contigs, 12 reads): device index, reverse
complement, anchors, chaining, chain members and the SDP window pass.

Every comparison is exact, the float ones included: the port rounds the
anchor -log P (XLA's float32 log) and the chain significance (a fused
multiply-add) the way XLA's CPU build does (kernels/xla_math.py).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from blasr_tpu.index.genome import build_genome_index  # noqa: E402
from blasr_tpu.io.fasta import FastaRecord  # noqa: E402
from blasr_tpu.kernels import anchor as janchor  # noqa: E402
from blasr_tpu.kernels import chain as jchain  # noqa: E402
from blasr_tpu.kernels import sdp as jsdp  # noqa: E402
from blasr_tpu.pipeline import map_read as jmr  # noqa: E402
from blasr_tpu.sim import random_genome, simulate_reads  # noqa: E402
from blasr_tpu_torch.kernels import anchor as tanchor  # noqa: E402
from blasr_tpu_torch.kernels import chain as tchain  # noqa: E402
from blasr_tpu_torch.kernels import sdp as tsdp  # noqa: E402
from blasr_tpu_torch.kernels import xla_math  # noqa: E402
from blasr_tpu_torch.pipeline import map_read as tmr  # noqa: E402

torch.set_num_threads(2)

INDEX_FIELDS = ("genome", "keys_sorted", "pos_sorted", "contig_starts",
                "contig_ends", "bucket_starts", "bucket_pairs", "gwords",
                "gnwords", "pos_records")
L = 512


def small_world():
    """tests/test_golden.py::make_small's genome and reads, in memory."""
    contigs = random_genome(60_000, seed=777, n_contigs=2)
    sims = simulate_reads(contigs, 12, read_len=(250, 900), accuracy=0.87,
                          seed=778)
    recs = [FastaRecord(f"movie/{i}/0_{len(s.rec.seq)}", s.rec.seq)
            for i, s in enumerate(sims)]
    return contigs, recs


def jax_index_arrays(jdev):
    arrs = {f: np.asarray(getattr(jdev, f)) for f in INDEX_FIELDS
            if getattr(jdev, f) is not None}
    arrs["k"] = jdev.k
    return arrs


@pytest.fixture(scope="module")
def world():
    contigs, recs = small_world()
    gi = build_genome_index(contigs, k=12)
    jdev = jmr.DeviceIndex.from_host(gi)
    arrs = jax_index_arrays(jdev)
    B = len(recs)
    reads = np.full((B, L), 4, np.int8)
    lens = np.zeros(B, np.int32)
    for i, r in enumerate(recs):
        n = min(len(r.seq), L)
        reads[i, :n] = r.seq[:n]
        lens[i] = n
    jrc = jmr._revcomp_batch(jnp.asarray(reads), jnp.asarray(lens))
    reads2 = np.concatenate([reads, np.asarray(jrc)])
    lens2 = np.concatenate([lens, lens])
    return dict(gi=gi, jdev=jdev, arrs=arrs,
                tdev=tmr.device_index_from_jax_arrays(arrs, "cpu"),
                reads=reads, lens=lens, reads2=reads2, lens2=lens2)


def anchor_kw(dev):
    return dict(k=12, occ_per_pos=3, max_anchors=512, anchor_ext=20,
                min_match=12, max_anchors_per_pos=10000,
                bucket_starts=dev.bucket_starts,
                bucket_pairs=dev.bucket_pairs, gwords=dev.gwords,
                gnwords=dev.gnwords, pos_records=dev.pos_records)


@pytest.fixture(scope="module")
def anchors(world):
    jdev, tdev = world["jdev"], world["tdev"]
    ja = janchor.find_anchors(
        jdev.genome, jdev.keys_sorted, jdev.pos_sorted,
        jnp.asarray(world["reads2"]), jnp.asarray(world["lens2"]),
        **anchor_kw(jdev))
    ta = tanchor.find_anchors(
        tdev.genome, tdev.keys_sorted, tdev.pos_sorted,
        torch.from_numpy(world["reads2"]), torch.from_numpy(world["lens2"]),
        **anchor_kw(tdev))
    return ja, ta


def as_torch_anchors(ja):
    return tanchor.Anchors(**{
        f: torch.from_numpy(np.array(getattr(ja, f)))
        for f in tanchor.Anchors._fields})


def test_device_index_from_host_matches_jax(world):
    """The port's own upload+derive equals the JAX DeviceIndex, with the
    uint32 arrays held as int64 and the records as int32 bit patterns."""
    got = tmr.DeviceIndex.from_host(world["gi"], "cpu")
    for f in INDEX_FIELDS:
        want = world["arrs"][f]
        have = getattr(got, f).numpy()
        if f == "pos_records":
            have = have.view(np.uint32)
        np.testing.assert_array_equal(want.astype(np.int64),
                                      have.astype(np.int64), err_msg=f)


def test_revcomp_matches_jax(world):
    got = tmr._revcomp_batch(torch.from_numpy(world["reads"]),
                             torch.from_numpy(world["lens"]))
    np.testing.assert_array_equal(world["reads2"][len(world["reads"]):],
                                  got.numpy())


def test_find_anchors_matches_jax(anchors):
    ja, ta = anchors
    assert int(np.asarray(ja.valid).sum()) > 100
    for f in tanchor.Anchors._fields:
        np.testing.assert_array_equal(np.asarray(getattr(ja, f)),
                                      getattr(ta, f).numpy(), err_msg=f)


@pytest.mark.parametrize("cfg", [
    dict(n_cand=16, rank_by_pvalue=True, p_value_type=0),
    dict(n_cand=1, rank_by_pvalue=True, p_value_type=0, drift_penalty=1.0),
    dict(n_cand=10, rank_by_pvalue=True, p_value_type=1, lookback=64),
    dict(n_cand=10, rank_by_pvalue=True, p_value_type=2, global_chain=True),
    dict(n_cand=10, rank_by_pvalue=False),
], ids=["pvt0", "guide-drift", "pvt1-lookback", "pvt2-global", "size"])
def test_chain_matches_jax(world, anchors, cfg):
    ja, _ = anchors
    ta = as_torch_anchors(ja)
    jc = jchain.chain_anchors(ja, jnp.asarray(world["lens2"]),
                              indel_rate=0.3, **cfg)
    tc = tchain.chain_anchors(ta, torch.from_numpy(world["lens2"]),
                              indel_rate=0.3, **cfg)
    assert np.asarray(jc.valid).any()
    for f in tchain.Candidates._fields:
        np.testing.assert_array_equal(np.asarray(getattr(jc, f)),
                                      getattr(tc, f).numpy(), err_msg=f)
    jm = jchain.chain_members(jc, ja, max_chain=96)
    tm = tchain.chain_members(tc, ta, max_chain=96)
    for a, b in zip(jm, tm):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_window_fragment_diags_matches_jax(world):
    rng = np.random.default_rng(9)
    N, W = 6, 896
    g = np.asarray(world["gi"].genome)
    rows = rng.integers(0, len(world["reads2"]), N)
    starts = rng.integers(0, len(g) - W, N)
    windows = np.stack([g[s:s + W] for s in starts]).astype(np.int8)
    reads = world["reads2"][rows].copy()
    for i in range(N):                # plant read k-mers near the diagonal
        windows[i, 100:100 + 300] = reads[i, 40:340]
    offs = np.clip(np.arange(L)[None, :] + 60 - 64 + rng.integers(
        -30, 30, (N, 1)), 0, W - 128)
    offs = np.maximum.accumulate(offs, axis=1).astype(np.int32)
    wl = np.full(N, W, np.int32)
    for occ in (1, 2):
        rk, rv = janchor.read_kmer_keys(jnp.asarray(reads),
                                        jnp.asarray(world["lens2"][rows]), 11)
        jd, jv = jsdp.window_fragment_diags_banded(
            rk, rv, jnp.asarray(windows), jnp.asarray(wl),
            jnp.asarray(offs), k=11, occ=occ)
        trk, trv = tanchor.read_kmer_keys(
            torch.from_numpy(reads), torch.from_numpy(world["lens2"][rows]),
            11)
        np.testing.assert_array_equal(np.asarray(rk), trk.numpy())
        np.testing.assert_array_equal(np.asarray(rv), trv.numpy())
        td, tv = tsdp.window_fragment_diags_banded(
            trk, trv, torch.from_numpy(windows), torch.from_numpy(wl),
            torch.from_numpy(offs), k=11, occ=occ)
        assert np.asarray(jv).sum() > 200
        np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
        np.testing.assert_array_equal(np.asarray(jd), td.numpy())


def test_xla_rounding_emulation():
    """log_f32 rounds as XLA's float32 log; fma_f32 as XLA's contracted
    a*b+c; both differ from eager torch on some inputs."""
    import jax
    rng = np.random.default_rng(1)
    x = np.concatenate([
        np.float32(4_600_000.0) / np.arange(1, 20001, dtype=np.float32),
        (rng.random(200_000) * 1e7 + 0.5).astype(np.float32)])
    want = np.asarray(jax.jit(jnp.log)(x))
    np.testing.assert_array_equal(
        want, xla_math.log_f32(torch.from_numpy(x)).numpy())
    assert (want != torch.log(torch.from_numpy(x)).numpy()).any()
    a = (rng.random(100_000) * 100).astype(np.float32)
    b = (rng.random(100_000) * 20).astype(np.float32)
    c = rng.random(100_000).astype(np.float32)
    want = np.asarray(jax.jit(lambda a, b, c: a + b * c)(a, b, c))
    got = xla_math.fma_f32(torch.from_numpy(b), torch.from_numpy(c),
                           torch.from_numpy(a)).numpy()
    np.testing.assert_array_equal(want, got)


def test_argmax_takes_first_index_like_jax():
    """Chain selection relies on argmax returning the first maximal index
    (jnp.argmax does, chain.py:203/:280)."""
    x = np.array([[1.0, 5.0, 5.0, 2.0], [-1e30, -1e30, -1e30, -1e30]],
                 np.float32)
    np.testing.assert_array_equal(np.asarray(jnp.argmax(jnp.asarray(x), 1)),
                                  torch.argmax(torch.from_numpy(x), 1).numpy())
    assert torch.argmax(torch.from_numpy(x), 1).tolist() == [1, 0]

"""The plain PyTorch anchor search and band offsets against the JAX package
on the edge inputs of ``tests/torch_edge_cases.py``.

Anchors: reads shorter than k, reads with N runs, a row with no valid
anchor (its output slots hold the raw values of invalid candidates), a
saturated row (more valid candidates than A, nearly all of one length),
seeds with more occurrences than O and than max_anchors_per_pos, O = 6 and
48 at A = 2048, advance_exact 8, max_lcp 20, hits whose extension runs
past the genome's end, the LUT-only and sorted-key lookups, the word
gathers instead of the fused records, a row with exactly A, A - 1 and
A + 1 valid candidates, ties at the threshold length across radix
digits, O = 1, 2, 5 and 64.  Band offsets: no members, one member,
members at rows 0 and L - 1, duplicate rows, fragments outside the band,
between_only, negative interpolation steps, no fragments, five fragments
a row, L = 4096, 1001, 8192 and 8193, and an item whose one member is on
its last row.  Every comparison is exact.  The CUDA kernels (K5, K6)
meet the same inputs in ``tests/test_torch_cuda.py``.

Also: on CPU tensors the two public functions never reach ``cuda_ops``,
and its launch wrappers refuse CPU tensors.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from blasr_tpu.index.genome import build_genome_index  # noqa: E402
from blasr_tpu.io.fasta import FastaRecord  # noqa: E402
from blasr_tpu.kernels import anchor as janchor  # noqa: E402
from blasr_tpu.pipeline import map_read as jmr  # noqa: E402
from blasr_tpu_torch.kernels import anchor as tanchor  # noqa: E402
from blasr_tpu_torch.kernels import cuda_ops  # noqa: E402
from blasr_tpu_torch.pipeline import map_read as tmr  # noqa: E402
from torch_edge_cases import (ANCHOR_CASES, ANCHOR_ROW5_EXCESS,  # noqa
                              BAND_CASES, BIG32, anchor_case, anchor_world,
                              band_case)
from torch_shared import TORCH_THREADS  # noqa: E402

torch.set_num_threads(TORCH_THREADS)

INDEX_FIELDS = ("genome", "keys_sorted", "pos_sorted", "contig_starts",
                "contig_ends", "bucket_starts", "bucket_pairs", "gwords",
                "gnwords", "pos_records")
LOOKUP_FIELDS = ("bucket_starts", "bucket_pairs", "gwords", "gnwords",
                 "pos_records")


@pytest.fixture(scope="module")
def edge_index():
    g = anchor_world()[0]
    jdev = jmr.DeviceIndex.from_host(
        build_genome_index([FastaRecord("edge", g)], k=12))
    arrs = {f: np.asarray(getattr(jdev, f)) for f in INDEX_FIELDS
            if getattr(jdev, f) is not None}
    arrs["k"] = jdev.k
    return jdev, arrs


def _call(mod, ix, reads, rlen, kw):
    return mod.find_anchors(ix.genome, ix.keys_sorted, ix.pos_sorted, reads,
                            rlen, **kw,
                            **{f: getattr(ix, f) for f in LOOKUP_FIELDS})


@pytest.mark.parametrize("name", list(ANCHOR_CASES))
def test_find_anchors_edges_match_jax(edge_index, name):
    jdev, arrs = edge_index
    _, reads, rlen, kw, drop = anchor_case(name)
    jix = jdev._replace(**{f: None for f in drop})
    tix = tmr.device_index_from_jax_arrays(
        {f: v for f, v in arrs.items() if f not in drop}, "cpu")
    ja = _call(janchor, jix, jnp.asarray(reads), jnp.asarray(rlen), kw)
    ta = _call(tanchor, tix, torch.from_numpy(reads), torch.from_numpy(rlen),
               kw)
    dtypes = dict(valid=torch.bool, hits_valid=torch.bool,
                  nlogp=torch.float32, n_total=torch.int32,
                  n_clipped=torch.int32)
    for f in janchor.Anchors._fields:
        have = getattr(ta, f)
        assert have.dtype == dtypes.get(f, torch.int64), f
        np.testing.assert_array_equal(np.asarray(getattr(ja, f)),
                                      have.numpy(), err_msg=f)
    A = min(kw["max_anchors"], reads.shape[1] * kw["occ_per_pos"])
    assert ta.q.shape == (len(reads), A)
    n_total, valid = ta.n_total.numpy(), ta.valid.numpy()
    assert n_total[0] > 0 and n_total[2] == 0 and n_total[4] == 0
    # a row with no valid anchor keeps the raw invalid candidates
    assert not valid[4].any() and (ta.l[4].numpy() > 0).all()
    # the genome's last bases: some hit reaches past the genome's end
    G = arrs["genome"].shape[0]
    hv6 = ta.hits_valid[6].numpy()
    assert (ta.hits_t[6].numpy()[hv6] + 12 + 16 > G).any()
    if name == "saturated-A64":
        assert n_total[5] > A and valid[5].all()
        lens = ta.l[5].numpy()
        assert (lens == lens.max()).mean() > 0.5
    if name == "mapp40":
        assert n_total[5] < 100     # the 60-copy seeds are skipped
    elif kw["occ_per_pos"] < 60:
        assert int(ta.n_clipped[5]) > 0     # nocc > O at the 60-copy unit
    if name == "maxlcp20":
        assert int(ta.l.max()) == 20
    if name in ANCHOR_ROW5_EXCESS:
        # the selection's boundary: exactly A, A - 1 or A + 1 valid
        assert n_total[5] - A == ANCHOR_ROW5_EXCESS[name]
    if name == "ties-A30":
        # every anchor kept is one of the ties at the longest length
        assert n_total[5] > A and (ta.l[5].numpy()[valid[5]] == 32).all()


@pytest.mark.parametrize("name", BAND_CASES)
def test_band_offsets_edges_match_jax(name):
    c = band_case(name)

    def j32(x):
        return None if x is None else jnp.asarray(x.astype(np.int32))

    def t(x):
        return None if x is None else torch.from_numpy(x)

    fv = c["frag_valid"]
    jo = jmr._band_offsets(j32(c["mq"]), j32(c["mt"]), j32(c["ws"]), c["L"],
                           c["W"], c["w_b"], j32(c["frag_diag"]),
                           None if fv is None else jnp.asarray(fv),
                           c["between_only"])
    to = tmr._band_offsets(t(c["mq"]), t(c["mt"]), t(c["ws"]), c["L"],
                           c["W"], c["w_b"], t(c["frag_diag"]), t(fv),
                           c["between_only"])
    assert to.dtype == torch.int64 and to.shape == (6, c["L"])
    if name == "last-row-only":
        assert (c["mq"][0] < BIG32).sum() == 1
    np.testing.assert_array_equal(np.asarray(jo), to.numpy())
    step = np.diff(to.numpy(), axis=1)
    assert (step >= 0).all() and (step <= 2).all()   # the DP's contract
    if name == "no-members":
        # no guide: diagonal 0, the band centred on the main diagonal
        r = np.arange(c["L"])
        want = np.clip(r - c["w_b"] // 2, 0, c["W"] - c["w_b"])
        assert (to.numpy() == want).all()


def test_cpu_tensors_never_reach_the_new_kernels(edge_index):
    """On CPU tensors find_anchors and _band_offsets run their plain
    versions without loading the kernel library or counting a launch; the
    K5 and K6 launch wrappers refuse CPU tensors."""
    _, arrs = edge_index
    before = dict(cuda_ops.LAUNCHES)
    _, reads, rlen, kw, _ = anchor_case("default")
    tix = tmr.device_index_from_jax_arrays(arrs, "cpu")
    _call(tanchor, tix, torch.from_numpy(reads), torch.from_numpy(rlen), kw)
    c = band_case("ends")
    args = [torch.from_numpy(c[f]) for f in ("mq", "mt", "ws")]
    frags = dict(frag_diag=torch.from_numpy(c["frag_diag"]),
                 frag_valid=torch.from_numpy(c["frag_valid"]))
    tmr._band_offsets(*args, c["L"], c["W"], c["w_b"], **frags)
    assert cuda_ops._lib is None
    assert cuda_ops.LAUNCHES == before
    with pytest.raises(ValueError):
        cuda_ops.anchor_search_launch(
            tix.genome, tix.keys_sorted, tix.pos_sorted,
            torch.from_numpy(reads), torch.from_numpy(rlen), **kw,
            **{f: getattr(tix, f) for f in LOOKUP_FIELDS})
    with pytest.raises(ValueError):
        cuda_ops.band_offsets_launch(*args, L=c["L"], W=c["W"],
                                     w_b=c["w_b"], **frags)
    assert cuda_ops._lib is None

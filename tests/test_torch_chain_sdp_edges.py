"""The plain PyTorch chain scan and SDP window pass against the JAX
package on the edge inputs of ``tests/torch_edge_cases.py``: exact ties,
A = 100 (JAX pads to a multiple of 8) and A = 1024, a 32-anchor lookback,
rows with no and one valid anchor, the global chain, the guide pass's
drift penalty; slab starts clamped at -(L + D) and at W, slabs crossing
the window's ends, short windows, a read with no valid k-mer, k = 16 keys
using the top bit, all-N windows, hits on the edges of K4's 32-diagonal
ballot steps, occ 1 and 2.  Every comparison is exact.  The CUDA kernels
(K3, K4) meet the same inputs in ``tests/test_torch_cuda.py``.

Also: on CPU tensors the public functions never reach ``cuda_ops``, and
its launch wrappers refuse CPU tensors.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from blasr_tpu.kernels import anchor as janchor  # noqa: E402
from blasr_tpu.kernels import chain as jchain  # noqa: E402
from blasr_tpu.kernels import sdp as jsdp  # noqa: E402
from blasr_tpu_torch.kernels import anchor as tanchor  # noqa: E402
from blasr_tpu_torch.kernels import chain as tchain  # noqa: E402
from blasr_tpu_torch.kernels import cuda_ops  # noqa: E402
from blasr_tpu_torch.kernels import sdp as tsdp  # noqa: E402
from torch_edge_cases import (BALLOT_DLO, CHAIN_CASES,  # noqa: E402
                              SDP_CASES, SDP_D, chain_case, sdp_case)
from torch_shared import TORCH_THREADS  # noqa: E402

torch.set_num_threads(TORCH_THREADS)


def jax_anchors(c):
    return janchor.Anchors(
        q=jnp.asarray(c["q"], jnp.int32), t=jnp.asarray(c["t"], jnp.int32),
        l=jnp.asarray(c["l"], jnp.int32), valid=jnp.asarray(c["valid"]),
        n_total=jnp.asarray(c["valid"].sum(1), jnp.int32),
        nlogp=jnp.asarray(c["nlogp"]))


def torch_anchors(c):
    return tanchor.Anchors(
        q=torch.from_numpy(c["q"]), t=torch.from_numpy(c["t"]),
        l=torch.from_numpy(c["l"]), valid=torch.from_numpy(c["valid"]),
        n_total=torch.from_numpy(c["valid"].sum(1).astype(np.int32)),
        nlogp=torch.from_numpy(c["nlogp"]))


@pytest.mark.parametrize("name", list(CHAIN_CASES))
def test_chain_edges_match_jax(name):
    c, kw = chain_case(name)
    jc = jchain.chain_anchors(jax_anchors(c), jnp.asarray(c["read_len"]),
                              indel_rate=0.3, **kw)
    tc = tchain.chain_anchors(torch_anchors(c),
                              torch.from_numpy(c["read_len"]),
                              indel_rate=0.3, **kw)
    for f in tchain.Candidates._fields:
        want = np.asarray(getattr(jc, f))
        have = getattr(tc, f).numpy()
        assert have.dtype == (np.float32 if want.dtype == np.float32
                              else bool if want.dtype == bool else np.int64)
        np.testing.assert_array_equal(want, have, err_msg=f)
    parent = tc.parent.numpy()
    assert (parent >= 0).any()             # chains were extended
    if name.startswith("ties"):
        # chains run through the tied copies: some anchor extends the
        # first of two copies (same q and length, t one apart)
        q, t, ln = c["q"], c["t"], c["l"]
        b, i = np.nonzero(parent >= 0)
        j = parent[b, i]
        k = np.minimum(j + 1, q.shape[1] - 1)
        twin = ((q[b, k] == q[b, j]) & (ln[b, k] == ln[b, j])
                & (t[b, k] == t[b, j] + 1))
        assert twin.any()
    if name == "empty-and-single-rows":
        assert not tc.valid[0].any() and not tc.valid[2].any()
        assert int(tc.valid[1].sum()) == 1
        # all-masked selections still report anchor 0's coordinates
        assert (tc.end_idx[0] == 0).all()


@pytest.mark.parametrize("name", SDP_CASES)
def test_sdp_window_edges_match_jax(name):
    reads, rlen, windows, wlens, offs, occ, k = sdp_case(name)
    rk, rv = janchor.read_kmer_keys(jnp.asarray(reads), jnp.asarray(rlen), k)
    jd, jv = jsdp.window_fragment_diags_banded(
        rk, rv, jnp.asarray(windows), jnp.asarray(wlens), jnp.asarray(offs),
        k=k, occ=occ)
    trk, trv = tanchor.read_kmer_keys(torch.from_numpy(reads),
                                      torch.from_numpy(rlen), k)
    td, tv = tsdp.window_fragment_diags_banded(
        trk, trv, torch.from_numpy(windows), torch.from_numpy(wlens),
        torch.from_numpy(offs), k=k, occ=occ)
    assert td.shape == (len(reads), reads.shape[1], occ)
    assert td.dtype == torch.int64 and tv.dtype == torch.bool
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    np.testing.assert_array_equal(np.asarray(jd), td.numpy())
    L, W, D = reads.shape[1], windows.shape[1], SDP_D
    dlo = tsdp._diag_lo(torch.from_numpy(offs), L, W, D, 128)
    if name.startswith("clamp"):
        want = -(L + D) if "low" in name else W
        assert (dlo == want).all() and not tv.any()
    else:
        assert int(tv[..., 0].sum()) > 100
        if occ == 2:
            assert tv[..., 1].any()
    if name.startswith("straddle"):
        assert (dlo[::2] < 0).all()
        assert (dlo[1::2] + L + D > W).all()
    if name.startswith("empty-read"):
        assert not tv[1].any() and not tv[3].any()
    if name.startswith("all-n"):
        assert not tv[1].any() and not tv[4].any()
    if name.startswith("k16"):
        wk, wv = tanchor.read_kmer_keys(torch.from_numpy(windows),
                                        torch.from_numpy(wlens), k)
        assert (wk[wv] >= 1 << 31).any()          # keys use the top bit
        assert (torch.from_numpy(wlens) < W).all()
        # an all-T read key equals the invalid-window sentinel, so it hits
        # window positions past wlens (JAX's semantics, kept)
        allt = trv & (trk == tsdp.INVALID_WINDOW)
        assert tv[..., 0][allt].any()
    if name.startswith("ballot-edges"):
        assert (dlo == BALLOT_DLO).all()
        s0 = td[..., 0] - BALLOT_DLO
        v0 = tv[..., 0]
        for row, s in ((0, 31), (1, 32), (2, D - 1), (3, 3), (5, 0)):
            assert (s0[row][v0[row]] == s).sum() > 50, (row, s)
        assert (s0[5][v0[5]] == 480).sum() > 50
        if occ == 2:
            s1 = td[..., 1] - BALLOT_DLO
            both = tv[..., 1]
            # two hits inside one 32-diagonal step, and across two steps
            assert ((s0[3] == 3) & (s1[3] == 18) & both[3]).sum() > 100
            assert ((s0[4] == 31) & (s1[4] == 32) & both[4]).any()


def test_cpu_tensors_never_reach_the_kernels():
    """On CPU tensors both public functions run their plain versions
    without loading the kernel library or counting a launch; the launch
    wrappers refuse CPU tensors."""
    before = dict(cuda_ops.LAUNCHES)
    c, kw = chain_case("A100-pvt1")
    tchain.chain_anchors(torch_anchors(c), torch.from_numpy(c["read_len"]),
                         **kw)
    reads, rlen, windows, wlens, offs, occ, k = sdp_case("straddle-occ2")
    trk, trv = tanchor.read_kmer_keys(torch.from_numpy(reads),
                                      torch.from_numpy(rlen), k)
    sdp_args = (trk, trv, torch.from_numpy(windows), torch.from_numpy(wlens),
                torch.from_numpy(offs))
    tsdp.window_fragment_diags_banded(*sdp_args, k=k, occ=occ)
    assert cuda_ops._lib is None
    assert cuda_ops.LAUNCHES == before
    i32 = torch.int32
    B, A = c["q"].shape
    with pytest.raises(ValueError):
        cuda_ops.chain_scan_launch(
            *(torch.from_numpy(c[f]).to(i32) for f in ("q", "t", "l")),
            torch.from_numpy(c["valid"]), torch.from_numpy(c["nlogp"]),
            torch.from_numpy(c["read_len"]), n_cand=4, lookback=A,
            rate=1.3, drift_frac=0.35, drift_slack=50.0, drift_penalty=0.0,
            global_chain=False, rank_mode=1)
    with pytest.raises(ValueError):
        cuda_ops.sdp_window_launch(*sdp_args, k=k, occ=occ, D=SDP_D,
                                   w_b=128)
    assert cuda_ops._lib is None

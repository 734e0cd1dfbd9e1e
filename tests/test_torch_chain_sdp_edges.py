"""The plain PyTorch chain scan and SDP window pass against the JAX
package on the edge inputs of ``tests/torch_edge_cases.py``: exact ties,
A = 100 (JAX pads to a multiple of 8) and A = 1024, a 32-anchor lookback,
rows with no and one valid anchor, the global chain, the guide pass's
drift penalty; slab starts clamped at -(L + D) and at W, slabs crossing
the window's ends, short windows, a read with no valid k-mer, occ 1 and
2.  Every comparison is exact.  The CUDA kernels (K3, K4) meet the same
inputs in ``tests/test_torch_cuda.py``.

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
from torch_edge_cases import (CHAIN_CASES, K_SDP, SDP_CASES,  # noqa: E402
                              chain_case, sdp_case)

torch.set_num_threads(2)


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
    reads, rlen, windows, wlens, offs, occ = sdp_case(name)
    rk, rv = janchor.read_kmer_keys(jnp.asarray(reads), jnp.asarray(rlen),
                                    K_SDP)
    jd, jv = jsdp.window_fragment_diags_banded(
        rk, rv, jnp.asarray(windows), jnp.asarray(wlens), jnp.asarray(offs),
        k=K_SDP, occ=occ)
    trk, trv = tanchor.read_kmer_keys(torch.from_numpy(reads),
                                      torch.from_numpy(rlen), K_SDP)
    td, tv = tsdp.window_fragment_diags_banded(
        trk, trv, torch.from_numpy(windows), torch.from_numpy(wlens),
        torch.from_numpy(offs), k=K_SDP, occ=occ)
    assert td.shape == (len(reads), reads.shape[1], occ)
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    np.testing.assert_array_equal(np.asarray(jd), td.numpy())
    dlo = tsdp._diag_lo(torch.from_numpy(offs), reads.shape[1],
                        windows.shape[1], 512, 128)
    if name.startswith("clamp"):
        want = -(reads.shape[1] + 512) if "low" in name else windows.shape[1]
        assert (dlo == want).all() and not tv.any()
    else:
        assert int(tv[..., 0].sum()) > 100
        if occ == 2:
            assert tv[..., 1].any()
    if name.startswith("straddle"):
        assert (dlo[::2] < 0).all()
        assert (dlo[1::2] + reads.shape[1] + 512 > windows.shape[1]).all()
    if name.startswith("empty-read"):
        assert not tv[1].any() and not tv[3].any()


def test_cpu_tensors_never_reach_the_kernels():
    """On CPU tensors both public functions run their plain versions
    without loading the kernel library or counting a launch; the launch
    wrappers refuse CPU tensors."""
    before = dict(cuda_ops.LAUNCHES)
    c, kw = chain_case("A100-pvt1")
    tchain.chain_anchors(torch_anchors(c), torch.from_numpy(c["read_len"]),
                         **kw)
    reads, rlen, windows, wlens, offs, occ = sdp_case("straddle-occ2")
    trk, trv = tanchor.read_kmer_keys(torch.from_numpy(reads),
                                      torch.from_numpy(rlen), K_SDP)
    tsdp.window_fragment_diags_banded(
        trk, trv, torch.from_numpy(windows), torch.from_numpy(wlens),
        torch.from_numpy(offs), k=K_SDP, occ=occ)
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
        cuda_ops.sdp_window_launch(
            trk.to(i32), torch.zeros(windows.shape, dtype=i32),
            torch.zeros(len(reads), dtype=i32), D=512, occ=2)
    assert cuda_ops._lib is None


def test_k4_inputs_keep_the_sentinels():
    """The keys K4 takes are the plain version's masked keys narrowed to
    int32 bit patterns: invalid window k-mers stay 0xFFFFFFFF, invalid
    read k-mers 0xFFFFFFFE (so the two never match), and the slab starts
    are the plain version's."""
    reads, rlen, windows, wlens, offs, occ = sdp_case("short-windows-occ2")
    rk, rv = tanchor.read_kmer_keys(torch.from_numpy(reads),
                                    torch.from_numpy(rlen), 16)
    wins, wl, of = (torch.from_numpy(x) for x in (windows, wlens, offs))
    k_rk, k_wk, k_dlo = tsdp.kernel_inputs(rk, rv, wins, wl, of, k=16,
                                           D=512, w_b=128)
    assert k_rk.dtype == k_wk.dtype == k_dlo.dtype == torch.int32
    wkeys, wval = tanchor.read_kmer_keys(wins, wl, 16)
    want_w = torch.where(wval, wkeys, tsdp.INVALID_WINDOW)
    want_r = torch.where(rv, rk, tsdp.INVALID_READ)
    assert torch.equal(k_wk.to(torch.int64) & 0xFFFFFFFF, want_w)
    assert torch.equal(k_rk.to(torch.int64) & 0xFFFFFFFF, want_r)
    assert (k_wk[~wval] == -1).all() and (k_rk[~rv] == -2).all()
    assert (want_w >= 1 << 31).any()     # k = 16: keys use the top bit
    assert torch.equal(k_dlo.to(torch.int64),
                       tsdp._diag_lo(of, reads.shape[1], windows.shape[1],
                                     512, 128))

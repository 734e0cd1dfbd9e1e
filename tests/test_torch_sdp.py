"""The port's pairwise SDP skeleton and chain members against the JAX
package on the CPU.

* ``sdp_align`` at N = 8 pairs, Lq = 256, Lt = 512, k = 11 (reads
  mutated from a planted target span, ``tests/test_sdp_sw.py``'s world),
  global and local: every ``SDPResult`` field exactly equal.
* ``chain_members_plain`` against JAX's ``chain_members`` on the K7 edge
  inputs of ``tests/torch_edge_cases.py`` (K3-shaped parents with q ties,
  q that does not fall along a chain, chains longer than M, invalid
  candidates and negative ends, M = 1 and 2, q at or above BIG, a chain
  of exactly M = 64 members and one of 65, chains sharing a suffix,
  sdp_align's whole call (64 pairs, M = 256), and rows on either side of
  each seam of K7's shared memory): every member exactly equal.  The CUDA
  kernel K7 meets the same inputs in ``tests/test_torch_cuda.py``.
* ``cuda_ops.chain_members_plan`` on those seams, from the sizes of
  ``csrc/chain_members_plan.h`` built with g++: the stage and the chains
  a CTA.
"""

import ctypes
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from blasr_tpu.kernels import anchor as janchor  # noqa: E402
from blasr_tpu.kernels import chain as jchain  # noqa: E402
from blasr_tpu.kernels import sdp as jsdp  # noqa: E402
from blasr_tpu_torch.kernels import anchor as tanchor  # noqa: E402
from blasr_tpu_torch.kernels import chain as tchain  # noqa: E402
from blasr_tpu_torch.kernels import sdp as tsdp  # noqa: E402
from test_sdp_sw import mutate  # noqa: E402
from torch_edge_cases import (MEMBER_CASES, MEMBER_PATH_CASES,  # noqa: E402
                              member_case)
from torch_shared import TORCH_THREADS  # noqa: E402

torch.set_num_threads(TORCH_THREADS)


def sdp_world(seed=5, N=8, Lq=256, Lt=512):
    """``test_sdp_recovers_planted_span``'s pairs: 200-base spans of a
    random target, mutated, with the target shifted by one base."""
    rng = np.random.default_rng(seed)
    qarr = np.full((N, Lq), 4, np.int8)
    tarr = np.full((N, Lt), 4, np.int8)
    qlen = np.zeros(N, np.int32)
    tlen = np.zeros(N, np.int32)
    for n in range(N):
        target = rng.integers(0, 4, Lt - 1).astype(np.int8)
        pos = int(rng.integers(0, Lt - 1 - 220))
        q = mutate(rng, target[pos:pos + 200])[:Lq]
        qarr[n, :len(q)] = q
        tarr[n, 1:Lt] = target
        qlen[n] = len(q)
        tlen[n] = Lt
    return qarr, qlen, tarr, tlen


@pytest.mark.parametrize("global_align", [True, False])
def test_sdp_align_matches_jax(global_align):
    args = sdp_world()
    want = jsdp.sdp_align(*map(jnp.asarray, args), k=11,
                          global_align=global_align)
    got = tsdp.sdp_align(*map(torch.from_numpy, args), k=11,
                         global_align=global_align)
    assert tsdp.SDPResult._fields == jsdp.SDPResult._fields
    assert np.asarray(want.valid).all()
    for f in jsdp.SDPResult._fields:
        np.testing.assert_array_equal(np.asarray(getattr(want, f)),
                                      getattr(got, f).numpy(), err_msg=f)


def _member_inputs(c):
    """(JAX Candidates and Anchors, torch ones) carrying the case's
    parents, ends and flags; the fields chain_members does not read are
    zeros."""
    B, A = c["q"].shape
    C = c["end_idx"].shape[1]
    zb = np.zeros((B, C), np.int32)
    jc = jchain.Candidates(
        zb, zb, zb, zb, zb.astype(np.float32), zb, zb.astype(np.float32),
        jnp.asarray(c["valid"]), jnp.asarray(c["end_idx"], jnp.int32),
        jnp.asarray(c["parent"], jnp.int32))
    ja = janchor.Anchors(
        q=jnp.asarray(c["q"], jnp.int32), t=jnp.asarray(c["t"], jnp.int32),
        l=jnp.asarray(c["l"], jnp.int32), valid=jnp.ones((B, A), bool),
        n_total=jnp.full((B,), A, jnp.int32),
        nlogp=jnp.zeros((B, A), jnp.float32))
    zt = torch.zeros((B, C), dtype=torch.int64)
    tc = tchain.Candidates(
        zt, zt, zt, zt, zt.float(), zt, zt.float(),
        torch.from_numpy(c["valid"]), torch.from_numpy(c["end_idx"]),
        torch.from_numpy(c["parent"]))
    ta = tanchor.Anchors(
        q=torch.from_numpy(c["q"]), t=torch.from_numpy(c["t"]),
        l=torch.from_numpy(c["l"]), valid=torch.ones((B, A), dtype=bool),
        n_total=torch.full((B,), A, dtype=torch.int32),
        nlogp=torch.zeros((B, A)))
    return (jc, ja), (tc, ta)


@pytest.mark.parametrize("name", list(MEMBER_CASES))
def test_chain_members_edges_match_jax(name):
    c = member_case(name)
    (jc, ja), (tc, ta) = _member_inputs(c)
    want = jchain.chain_members(jc, ja, max_chain=c["M"])
    got = tchain.chain_members_plain(tc, ta, max_chain=c["M"])
    for f, a, b in zip(("mq", "mt", "ml", "mvalid"), want, got):
        assert tuple(b.shape) == tuple(a.shape), f
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=f)
    # the dispatch takes the plain version on CPU tensors
    same = tchain.chain_members(tc, ta, max_chain=c["M"])
    for a, b in zip(same, got):
        assert torch.equal(a, b)
    # what the case is for
    mq = got[0].numpy()
    if name == "longer-than-M":
        assert got[3].all(dim=2).any()
    if name == "q-ties":
        assert any((np.diff(row[row < 0x3FFFFFFF]) == 0).any()
                   for row in mq.reshape(-1, c["M"]))
    if name == "invalid-cands":
        assert not got[3][0, 1].any() and not c["valid"].all()
    if name in ("M64-chain-64", "M64-chain-65", "sdp-B64-chain-300"):
        assert got[3][:, 0].all()           # the long chain fills M
    if name == "shared-suffix":
        for row in mq:
            assert all(np.intersect1d(row[0][row[0] < 0x3FFFFFFF],
                                      row[c][row[c] < 0x3FFFFFFF]).size
                       for c in range(1, 4))


@pytest.fixture(scope="module")
def plan_lib(tmp_path_factory):
    """K7's launch plan, csrc/chain_members_plan.h, built with g++ (it is
    host code only), bound as kernels/cuda_ops.py binds the whole
    library."""
    from blasr_tpu_torch.kernels import cuda_ops
    so = tmp_path_factory.mktemp("plan") / "libchain_members_plan.so"
    subprocess.run(["g++", "-std=c++17", "-shared", "-fPIC", "-x", "c++",
                    str(cuda_ops.SRC_DIR / "chain_members_plan.h"), "-o",
                    str(so)], check=True, capture_output=True, timeout=120)
    return cuda_ops.bind(ctypes.CDLL(str(so)),
                         ("blasr_chain_members_plan",
                          "blasr_chain_members_smem",
                          "blasr_chain_members_max_smem"))


@pytest.mark.parametrize("name", list(MEMBER_PATH_CASES))
def test_members_plan_follows_the_sizes(plan_lib, name):
    """The wrapper's plan for K7 on each seam case, from the source's own
    sizes: the shared path, one CTA a row holding every chain (C * M <=
    1024 here), or the chase at up to four warps, the row's parents in
    shared or in global memory."""
    from blasr_tpu_torch.kernels import cuda_ops
    B, A, C, M, _ = MEMBER_CASES[name]
    plan = cuda_ops.chain_members_plan(plan_lib, C, A, M)
    assert plan == MEMBER_PATH_CASES[name]
    limit = plan_lib.blasr_chain_members_max_smem()
    assert plan_lib.blasr_chain_members_smem(A, M, *plan) <= limit
    # the path before it does not fit: the table beside the CTA's chains,
    # or the parents beside the warps
    if plan[1] == 1:
        assert plan_lib.blasr_chain_members_smem(A, M, C, 2) > limit
    if plan[1] == 0:
        assert plan_lib.blasr_chain_members_smem(A, M, plan[0], 1) > limit


def test_members_plan_refuses_what_no_path_holds(plan_lib):
    from blasr_tpu_torch.kernels import cuda_ops
    assert cuda_ops.chain_members_plan(plan_lib, 10, 512, 2048) == (4, 1)
    with pytest.raises(ValueError):
        cuda_ops.chain_members_plan(plan_lib, 10, 512, 1 << 15)

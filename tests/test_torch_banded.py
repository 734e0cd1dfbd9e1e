"""Banded DP and run-length traceback of the PyTorch port against the JAX
package.

The port's plain ``banded_align`` / ``banded_traceback_plain`` must equal
JAX ``banded_align`` (XLA), ``pallas_banded_align`` (interpret mode) and
``banded_traceback`` exactly: scores are integer-valued float32, every
other output is an int or a bool.  The CUDA kernels K1/K2 are held to the
plain versions by tests/test_torch_cuda.py (on a card) and chip_smoke.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import blasr_tpu.kernels.pallas_banded as pb  # noqa: E402
from blasr_tpu.kernels.banded import banded_align as jax_banded_align  # noqa: E402
from blasr_tpu.kernels.banded import banded_traceback as jax_traceback  # noqa: E402
from blasr_tpu.kernels.banded import BandedResult as JaxBandedResult  # noqa: E402
from blasr_tpu.params import MappingParams  # noqa: E402
from blasr_tpu_torch.kernels import banded as tb  # noqa: E402
from blasr_tpu_torch.kernels import pallas_banded as tpb  # noqa: E402
from test_torch_cuda import qv_words  # noqa: E402
from torch_edge_cases import (BANDED_CASES, BANDED_NOT_PALLAS,  # noqa: E402
                              BANDED_QV_SEED, TB_TILE, TRACEBACK_CASES,
                              banded_case, traceback_case)
from torch_shared import TORCH_THREADS, shared  # noqa: E402

torch.set_num_threads(TORCH_THREADS)


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(pb, "INTERPRET", True)


def _submat():
    p = MappingParams().make_sane()
    return np.asarray(p.score_matrix, np.float32).reshape(25)


def _case(rng, N, L, W, w_b=128, steep=()):
    """numpy inputs as tests/test_pallas_banded.py::_random_case builds
    them; items listed in ``steep`` span two window columns per row on a
    slope-2 band (a deletion per row: their tracebacks need ~2 pairs per
    row and overflow a small t_max)."""
    reads = rng.integers(0, 4, (N, L)).astype(np.int8)
    windows = rng.integers(0, 4, (N, W)).astype(np.int8)
    qa = rng.integers(0, 8, N).astype(np.int32)
    qb = (qa + rng.integers(L // 2, L - 8, N)).astype(np.int32)
    ta = rng.integers(1, 40, N).astype(np.int32)
    offs = np.zeros((N, L), np.int64)
    tbv = np.zeros(N, np.int32)
    for i in range(N):
        if i in steep:
            qb[i] = qa[i] + min(L - 8, (W - int(ta[i]) - 2 * w_b) // 2)
            span = int(qb[i] - qa[i])
            windows[i, ta[i]:ta[i] + 2 * span:2] = reads[i, qa[i]:qb[i]]
            tbv[i] = ta[i] + 2 * span
            slope = 2
        else:
            t = int(ta[i])
            for r in range(qa[i], qb[i]):
                u = rng.random()
                if u < 0.08:
                    pass
                elif u < 0.16 and t + 2 < W:
                    windows[i, t] = rng.integers(0, 4)
                    t += 2
                else:
                    if rng.random() < 0.9:
                        windows[i, t] = reads[i, r]
                    t += 1
                t = min(t, W - 1)
            tbv[i] = min(t + 1, W)
            slope = 1
        center = np.minimum(
            ta[i] + slope * np.maximum(np.arange(L) - int(qa[i]), 0), W - 1)
        offs[i] = np.clip(center - w_b // 2, 0, W - w_b)
    offs = np.asarray(pb.slope_limit_offsets(
        jnp.asarray(offs.astype(np.int32)), w_b))
    return reads, windows, offs, qa, qb, ta, tbv


def _torch(arrs):
    return [torch.from_numpy(np.array(a)) for a in arrs]


def _assert_same(ref, out, fields):
    for name in fields:
        a = np.asarray(getattr(ref, name))
        b = getattr(out, name).numpy()
        assert a.dtype.kind == b.dtype.kind or name == "score", name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("N,L,W,gaps", [
    (8, 256, 512, (4.0, 4.0, 5.0, 5.0)),
    (5, 128, 384, (4.0, 4.0, 5.0, 5.0)),      # N not a multiple of 8
    (6, 192, 448, (14.0, 1.0, 15.0, 1.0)),    # affine gap costs
])
def test_plain_dp_matches_jax(N, L, W, gaps):
    rng = np.random.default_rng(N * 1000 + L)
    arrs = _case(rng, N, L, W, steep=(1,))
    sm = _submat()
    ref = jax_banded_align(*[jnp.asarray(a) for a in arrs], jnp.asarray(sm),
                           *gaps, w_b=128)
    pal = pb.pallas_banded_align(*[jnp.asarray(a) for a in arrs],
                                 jnp.asarray(sm), *gaps, w_b=128)
    out = tb.banded_align(*_torch(arrs), torch.from_numpy(sm), *gaps)
    fields = ("score", "tbbits", "final_state", "valid")
    _assert_same(ref, out, fields)
    _assert_same(pal, out, fields)
    assert out.valid.any()
    # the CPU entry of the fast path is the same plain version
    fast = tpb.banded_align_cuda(*_torch(arrs), sm, *gaps)
    for a, b in zip(out, fast):
        assert torch.equal(a, b)


@pytest.mark.parametrize("N,L,W,flavours", [
    (8, 256, 512, ("ids", "qv", "none")),
    (5, 128, 384, ("ids",)),                  # N not a multiple of 8
    (6, 192, 448, ("qv", "ids")),
])
def test_plain_qv_dp_matches_jax(N, L, W, flavours):
    """QV-steered mode: the plain DP equals JAX's XLA kernel and the
    Pallas kernel (interpret mode) on every output, every tbbits row."""
    rng = np.random.default_rng(N * 100 + L + 1)
    arrs = _case(rng, N, L, W, steep=(1,))
    q1, q2 = qv_words(rng, N, L, flavours)
    sm = _submat()
    gaps = (4.0, 4.0, 5.0, 5.0)
    ja = [jnp.asarray(a) for a in arrs]
    jq = dict(qv1=jnp.asarray(q1), qv2=jnp.asarray(q2))
    ref = jax_banded_align(*ja, jnp.asarray(sm), *gaps, w_b=128, **jq)
    pal = pb.pallas_banded_align(*ja, jnp.asarray(sm), *gaps, w_b=128, **jq)
    tq = dict(qv1=torch.from_numpy(q1), qv2=torch.from_numpy(q2))
    out = tb.banded_align(*_torch(arrs), torch.from_numpy(sm), *gaps, **tq)
    fields = ("score", "tbbits", "final_state", "valid")
    _assert_same(ref, out, fields)
    _assert_same(pal, out, fields)
    assert out.valid.sum() >= N - 1
    fast = tpb.banded_align_cuda(*_torch(arrs), sm, *gaps, **tq)
    for a, b in zip(out, fast):
        assert torch.equal(a, b)


@pytest.mark.parametrize("mode", ["distance", "qv"])
@pytest.mark.parametrize("name", BANDED_CASES)
def test_plain_dp_edges_match_jax(name, mode):
    """The plain DP against JAX's XLA kernel on the edge shapes of K1's
    row tiles (tests/torch_edge_cases.py::banded_case), in both modes, and
    against the Pallas kernel (interpret mode) where its contract holds."""
    arrs = banded_case(name)
    N, L = arrs[0].shape
    sm = _submat()
    gaps = (4.0, 4.0, 5.0, 5.0)
    ja = [jnp.asarray(a) for a in arrs]
    jq, tq = {}, {}
    if mode == "qv":
        q1, q2 = qv_words(np.random.default_rng(BANDED_QV_SEED), N, L)
        jq = dict(qv1=jnp.asarray(q1), qv2=jnp.asarray(q2))
        tq = dict(qv1=torch.from_numpy(q1), qv2=torch.from_numpy(q2))
    ref = jax_banded_align(*ja, jnp.asarray(sm), *gaps, w_b=128, **jq)
    out = tb.banded_align(*_torch(arrs), torch.from_numpy(sm), *gaps, **tq)
    fields = ("score", "tbbits", "final_state", "valid")
    _assert_same(ref, out, fields)
    if name not in BANDED_NOT_PALLAS:
        pal = pb.pallas_banded_align(*ja, jnp.asarray(sm), *gaps, w_b=128,
                                     **jq)
        _assert_same(pal, out, fields)
    assert out.valid.sum() >= N - 1
    offs, qa, qb = arrs[2], arrs[3], arrs[4]
    if name == "negative-offsets":
        assert (offs[np.arange(N), qa] < 0).all()
    if name == "band-past-window":
        assert (offs.max(axis=1) + 128 > arrs[1].shape[1]).all()
    tpb.check_slope(*_torch((offs, qa, qb)))


def test_no_qv_flavour_equals_distance_mode():
    """Reads without QVs get flat per-row costs that reproduce the
    distance-mode DP bit for bit (linear gaps at the default costs)."""
    rng = np.random.default_rng(41)
    N, L, W = 6, 192, 448
    arrs = _torch(_case(rng, N, L, W, steep=(2,)))
    q1, q2 = qv_words(rng, N, L, ("none",))
    p = MappingParams().make_sane()
    gaps = (p.insertion, p.insertion, p.deletion, p.deletion)
    sm = _submat()
    dist = tb.banded_align(*arrs, sm, *gaps)
    qv = tb.banded_align(*arrs, sm, *gaps, qv1=torch.from_numpy(q1),
                         qv2=torch.from_numpy(q2))
    assert dist.valid.any()
    for name, a, b in zip(dist._fields, dist, qv):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("t_max", [128, 640])
def test_plain_traceback_matches_jax(t_max):
    """t_max = 128 overflows the steep items; 640 = L + W fits."""
    rng = np.random.default_rng(31)
    N, L, W = 6, 128, 512
    arrs = _case(rng, N, L, W, steep=(0, 3))
    sm = _submat()
    ja = [jnp.asarray(a) for a in arrs]
    ref = jax_banded_align(*ja, jnp.asarray(sm), 4.0, 4.0, 5.0, 5.0)
    jt = jax_traceback(ref, *ja[2:], t_max=t_max)
    ta = _torch(arrs)
    out = tb.banded_align(*ta, sm, 4.0, 4.0, 5.0, 5.0)
    got = tb.banded_traceback(out, *ta[2:], t_max=t_max)
    _assert_same(jt, got, tb.TracebackResult._fields)
    if t_max < 640:
        assert got.overflow[[0, 3]].all()
    else:
        assert not got.overflow.any()


def _walk_pairs(pairs):
    """The (op, count) halfword pairs of packed pair words [N, P//2]."""
    p = pairs.numpy().astype(np.int64)
    both = np.stack([p & 0xFFFF, (p >> 16) & 0xFFFF], -1).reshape(len(p), -1)
    return both & 3, both >> 2


@pytest.mark.parametrize("name", list(TRACEBACK_CASES))
def test_plain_traceback_edges_match_jax(name):
    """The plain walk against JAX's banded_traceback on planted walks at
    the edges of K2's 16-row tiles (tests/torch_edge_cases.py::
    traceback_case): M runs of up to 63 rows across tiles, qa / qb - 1 on
    and beside tile edges, stalls on tile edges, L = 200, valid == 0
    items, all-boundary walks past the 16383-column cap, overflow at P and
    a walk leaving the band.  Every output exactly."""
    tbb, st, valid, off, qa, qb, ta, tbv, t_max = traceback_case(name)
    N = len(st)
    rest = (off, qa, qb, ta, tbv)
    jt = jax_traceback(
        JaxBandedResult(jnp.zeros(N, jnp.float32), jnp.asarray(tbb),
                        jnp.asarray(st), jnp.asarray(valid)),
        *[jnp.asarray(x) for x in rest], t_max=t_max)
    res = tb.BandedResult(torch.zeros(N), torch.from_numpy(tbb),
                          torch.from_numpy(st), torch.from_numpy(valid))
    got = tb.banded_traceback(res, *_torch(rest), t_max=t_max)
    _assert_same(jt, got, tb.TracebackResult._fields)
    op, cnt = _walk_pairs(got.pairs)
    stall = (op == 1) & (cnt == 0)
    if name == "m-runs-cross-tiles":
        assert ((op == 1) & (cnt >= TB_TILE * 2 + 8)).sum() >= 10
    if name in ("stall-on-tile-edge", "L-not-tile"):
        assert stall.sum() >= 8
    if name == "invalid-and-empty":
        assert not got.n_pairs[~torch.from_numpy(valid)].any()
        assert got.n_del[1] == 40_000 and got.n_pairs[1] == 3
        assert (got.pairs[[0, 3]] == 0).all()
    if name == "overflow-and-band-exit":
        assert got.overflow.sum() >= 2
        assert (got.n_pairs[~got.overflow] < 40).any()   # left the band
    assert not got.overflow[torch.from_numpy(~valid)].any()


@pytest.fixture(scope="module")
def dp_edges(tmp_path_factory):
    """``build_dp_edges``, once per test run (tests/torch_shared.py)."""
    return shared(tmp_path_factory, __file__, "dp_edges", build_dp_edges)


def build_dp_edges(_):
    """The plain DP on the K1 edge shapes, once per shape."""
    out = {}
    sm = _submat()
    for name in BANDED_CASES:
        arrs = banded_case(name)
        out[name] = (arrs, tb.banded_align(*_torch(arrs), torch.from_numpy(sm),
                                          4.0, 4.0, 5.0, 5.0))
    return out


@pytest.mark.parametrize("frac", ["3T/8", "T"])
@pytest.mark.parametrize("name", BANDED_CASES)
def test_plain_traceback_dp_edges_match_jax(dp_edges, name, frac):
    """The plain walk against JAX's banded_traceback on the plain DP's
    cell words of each K1 edge shape (tests/torch_edge_cases.py::
    banded_case), at t_max = 3T/8 and T (T = L + W)."""
    arrs, res = dp_edges[name]
    L, W = arrs[0].shape[1], arrs[1].shape[1]
    t_max = (3 * (L + W)) // 8 if frac == "3T/8" else L + W
    rest = arrs[2:]
    jt = jax_traceback(
        JaxBandedResult(*(jnp.asarray(x.numpy()) for x in res)),
        *[jnp.asarray(x) for x in rest], t_max=t_max)
    got = tb.banded_traceback(res, *_torch(rest), t_max=t_max)
    _assert_same(jt, got, tb.TracebackResult._fields)
    assert got.n_pairs[res.valid].min() > 0
    if frac == "T":
        assert not got.overflow.any()


def test_per_distinct_row_groups_rows_by_their_bits():
    """kernels/dispatch.py::per_distinct_row runs its function on each
    distinct row once (a float by its bits: 0.0 and -0.0 are two rows)
    and copies each result to the rows that repeat it, named tuples and
    None outputs kept."""
    from blasr_tpu_torch.kernels.dispatch import per_distinct_row
    x = torch.tensor([[1.0, 2.0], [0.0, -0.0], [1.0, 2.0], [0.0, 0.0]])
    y = torch.tensor([7, 7, 7, 7])
    seen = []

    def fn(a, b):
        seen.append(a.shape[0])
        return tb.BandedResult(a.sum(dim=1), a * 2, b + 1, None)

    out = per_distinct_row(fn, x, y)
    assert seen == [3]
    assert torch.equal(out.tbbits, x * 2) and torch.equal(out.final_state,
                                                          y + 1)
    assert out.valid is None
    assert torch.signbit(out.tbbits[1, 1]) and not torch.signbit(
        out.tbbits[3, 1])


def test_plain_dp_on_repeated_items_equals_each_item():
    """The plain DP on a batch whose items repeat (as a mapping batch's
    empty slots do) gives every item the result it gets alone."""
    arrs = banded_case("tile-edges")
    rep = np.array([0, 1, 0, 2, 1, 0, 3, 3])
    sm = torch.from_numpy(_submat())
    many = tb.banded_align(*_torch([a[rep] for a in arrs]), sm, 4.0, 4.0,
                           5.0, 5.0)
    for i, j in enumerate(rep):
        one = tb.banded_align(*_torch([a[j:j + 1] for a in arrs]), sm, 4.0,
                              4.0, 5.0, 5.0)
        for f, a, b in zip(one._fields, many, one):
            assert torch.equal(a[i:i + 1], b), (f, i)


def test_slope_limit_offsets_matches_jax():
    rng = np.random.default_rng(5)
    offs = np.cumsum(rng.integers(0, 6, (4, 300)), axis=1).astype(np.int32)
    offs[:, 100:110] -= 7                     # a non-monotone dip
    ref = np.asarray(pb.slope_limit_offsets(jnp.asarray(offs), 128))
    got = tpb.slope_limit_offsets(torch.from_numpy(offs), 128).numpy()
    np.testing.assert_array_equal(ref, got)
    assert (np.diff(got, axis=1) >= 0).all() and (np.diff(got, axis=1)
                                                  <= 2).all()


def test_fast_path_contract():
    """banded_align_cuda keeps pallas_banded_align's slope contract at
    band 128.  Another band width is K1-W on the card, so on CPU tensors
    it is the plain DP at that width; a general matrix is K1's GEN form
    on the card, so on CPU tensors it is the plain DP with that
    matrix."""
    rng = np.random.default_rng(2)
    arrs = _torch(_case(rng, 2, 64, 256))
    sm = _submat().copy()
    sm[7] = 3.0                                 # C->G differs: not 2-valued
    assert not tpb.two_valued(sm)
    assert tpb.two_valued(_submat())
    gen = tpb.banded_align_cuda(*arrs, sm, 4.0, 4.0, 5.0, 5.0)
    for f, a, b in zip(gen._fields, gen,
                       tb.banded_align(*arrs, sm, 4.0, 4.0, 5.0, 5.0)):
        assert torch.equal(a, b), f
    narrow = _torch(_case(rng, 2, 64, 256, w_b=64))
    w64 = tpb.banded_align_cuda(*narrow, _submat(), 4.0, 4.0, 5.0, 5.0,
                                w_b=64)
    assert w64.tbbits.shape == (2, 64, 64) and w64.valid.all()
    for f, a, b in zip(w64._fields, w64,
                       tb.banded_align(*narrow, _submat(), 4.0, 4.0, 5.0,
                                       5.0, w_b=64)):
        assert torch.equal(a, b), f
    bad = arrs[2].clone()
    bad[:, 20] += 5                             # a jump of 5 in one row
    with pytest.raises(ValueError):
        tpb.check_slope(bad, arrs[3], arrs[4])
    tpb.check_slope(arrs[2], arrs[3], arrs[4])

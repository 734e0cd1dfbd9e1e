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
from blasr_tpu.params import MappingParams  # noqa: E402
from blasr_tpu_torch.kernels import banded as tb  # noqa: E402
from blasr_tpu_torch.kernels import pallas_banded as tpb  # noqa: E402
from test_torch_cuda import qv_words  # noqa: E402

torch.set_num_threads(2)


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
    """banded_align_cuda keeps pallas_banded_align's contract on every
    device: a general matrix or band width is refused, not rerouted."""
    rng = np.random.default_rng(2)
    arrs = _torch(_case(rng, 2, 64, 256))
    sm = _submat().copy()
    sm[7] = 3.0                                 # C->G differs: not 2-valued
    assert not tpb.two_valued(sm)
    assert tpb.two_valued(_submat())
    with pytest.raises(ValueError):
        tpb.banded_align_cuda(*arrs, sm, 4.0, 4.0, 5.0, 5.0)
    with pytest.raises(ValueError):
        tpb.banded_align_cuda(*arrs, _submat(), 4.0, 4.0, 5.0, 5.0, w_b=64)
    bad = arrs[2].clone()
    bad[:, 20] += 5                             # a jump of 5 in one row
    with pytest.raises(ValueError):
        tpb.check_slope(bad, arrs[3], arrs[4])
    tpb.check_slope(arrs[2], arrs[3], arrs[4])

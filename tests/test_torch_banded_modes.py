"""The plain banded DP of the PyTorch port in the modes of the affine path
and of a general ``--scoreMatrix`` against the JAX package.

``blasr_tpu_torch.kernels.banded.banded_align`` with the homopolymer-
insertion band (``use_hp``), with a general 5x5 matrix (distance, hp and
QV forms) must equal JAX ``banded_align`` (XLA) on every output and every
cell word, and ``banded_traceback_plain`` over the hp cell words must
equal JAX ``banded_traceback``.  The inputs are the tile-edge shapes of
``tests/torch_edge_cases.py::banded_case``, its ``hp-runs`` world
(homopolymer runs and insertions, qa = 0, qa on a tile edge, a qa whose
base repeats the one before it, N bases) and the inputs that switch the
CUDA kernel's hp row cases (``HP_ROW_CASES``: hp runs on tile edges,
hp_ok on alternate rows, never, always), in the modes of
``K1_MODES`` (the Mapper's affine costs, hp costs tied with the
insertion costs, a matrix with unequal diagonal entries and an N row of
its own).  The CUDA kernel's modes meet the same inputs in
``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from blasr_tpu.kernels.banded import banded_align as jax_banded_align  # noqa: E402
from blasr_tpu.kernels.banded import banded_traceback as jax_traceback  # noqa: E402
from blasr_tpu.kernels.banded import BandedResult as JaxBandedResult  # noqa: E402
from blasr_tpu_torch.kernels import banded as tb  # noqa: E402
from blasr_tpu_torch.kernels import pallas_banded as tpb  # noqa: E402
from test_torch_cuda import qv_words  # noqa: E402
from torch_edge_cases import (BANDED_QV_SEED, HP_ROW_CASES,  # noqa: E402
                              K1_MODE_CASES, K1_MODES, banded_case,
                              k1_mode_kwargs)
from torch_shared import TORCH_THREADS  # noqa: E402

torch.set_num_threads(TORCH_THREADS)

FIELDS = ("score", "tbbits", "final_state", "valid")


def _torch(arrs):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]


def _assert_same(ref, out, fields):
    for f in fields:
        np.testing.assert_array_equal(np.asarray(getattr(ref, f)),
                                      getattr(out, f).numpy(), err_msg=f)


def _run_both(name, mode):
    """(JAX result, port result, inputs) of one edge shape in one mode."""
    arrs = banded_case(name)
    N, L = arrs[0].shape
    submat, gaps, kw = k1_mode_kwargs(mode)
    jq, tq = {}, {}
    if K1_MODES[mode][3]:
        q1, q2 = qv_words(np.random.default_rng(BANDED_QV_SEED), N, L)
        jq = dict(qv1=jnp.asarray(q1), qv2=jnp.asarray(q2))
        tq = dict(qv1=torch.from_numpy(q1), qv2=torch.from_numpy(q2))
    ref = jax_banded_align(*[jnp.asarray(a) for a in arrs],
                           jnp.asarray(submat), *gaps, w_b=128, **kw, **jq)
    out = tb.banded_align(*_torch(arrs), torch.from_numpy(submat), *gaps,
                          **kw, **tq)
    return ref, out, arrs


@pytest.mark.parametrize("mode", list(K1_MODES))
@pytest.mark.parametrize("name", K1_MODE_CASES)
def test_plain_dp_modes_match_jax(name, mode):
    """Every output and cell word equal to the XLA kernel's; the hp modes
    set h_open bits, and on the inputs with homopolymer rows (but at the
    tied costs, where I wins every tie, so never) take H as a diagonal
    source; on ``hp-none`` H stays INF, so h_open is set in every cell of
    the active rows and no cell or final state is H."""
    ref, out, arrs = _run_both(name, mode)
    _assert_same(ref, out, FIELDS)
    N = arrs[0].shape[0]
    assert out.valid.sum() >= N - 1
    h_open = (out.tbbits >> 6) & 1
    m_src = out.tbbits & 3
    if K1_MODES[mode][2] is None:
        assert not h_open.any() and not (m_src == tb.ST_H).any()
        return
    assert h_open.any()
    in_h = (m_src == tb.ST_H).any() or (out.final_state == tb.ST_H).any()
    if name == "hp-none":
        rows = torch.arange(arrs[0].shape[1])
        active = (rows >= torch.from_numpy(arrs[3])[:, None]) & \
            (rows < torch.from_numpy(arrs[4])[:, None])
        assert (h_open[active] == 1).all() and (h_open[~active] == 0).all()
        assert not in_h
    elif mode == "hp-ties":
        assert not in_h
    elif name == "hp-runs" or name in HP_ROW_CASES:
        assert (m_src == tb.ST_H).any()
    # the routing of banded_align_cuda on CPU tensors is the plain DP
    submat, gaps, kw = k1_mode_kwargs(mode)
    assert tpb.two_valued(submat) == (mode in ("hp", "hp-ties"))


def test_hp_runs_reach_the_quirks():
    """The hp world holds what the hp band's quirks need: H open at the
    first row of an item whose read[qa] repeats read[qa - 1], none at
    row 0 (the previous base is code 4), final states in H, and ties
    between H and I resolved to I."""
    _, out, arrs = _run_both("hp-runs", "hp")
    reads, qa = arrs[0], arrs[3]
    assert reads[2, qa[2]] == reads[2, qa[2] - 1]
    tbb = out.tbbits.numpy()
    # the H state feeds a diagonal source somewhere on row qa + 1 of item 2
    # only through an H cell of row qa: H opened at its first row
    assert ((tbb[2, qa[2] + 1] & 3) == tb.ST_H).any()
    # row 0 of item 0: hp_ok is false, so no cell of row 1 leaves H
    assert not ((tbb[0, 1] & 3) == tb.ST_H).any()
    assert (out.final_state.numpy() == tb.ST_H).any() or \
        ((tbb & 3) == tb.ST_H).sum() > 100
    _, tie, _ = _run_both("hp-runs", "hp-ties")
    # with H priced as I, a diagonal source is H only where I is worse
    assert ((tie.tbbits.numpy() & 3) == tb.ST_H).sum() < \
        ((tbb & 3) == tb.ST_H).sum()


def _walk_both(name, mode, frac):
    """The plain walk over the plain hp DP's cell words of ``name`` against
    JAX's banded_traceback, every output exactly."""
    ref, out, arrs = _run_both(name, mode)
    L, W = arrs[0].shape[1], arrs[1].shape[1]
    t_max = (3 * (L + W)) // 8 if frac == "3T/8" else L + W
    rest = arrs[2:]
    jt = jax_traceback(JaxBandedResult(*(jnp.asarray(x.numpy())
                                         for x in out)),
                       *[jnp.asarray(x) for x in rest], t_max=t_max)
    got = tb.banded_traceback(out, *_torch(rest), t_max=t_max)
    _assert_same(jt, got, tb.TracebackResult._fields)
    assert got.n_pairs[out.valid].min() > 0
    assert got.n_ins.sum() > 0


@pytest.mark.parametrize("frac", ["3T/8", "T"])
@pytest.mark.parametrize("mode", ["hp", "hp-ties", "hp-gen"])
def test_plain_traceback_on_hp_words_matches_jax(mode, frac):
    """The plain walk over the plain hp DP's cell words (states H and the
    h_open bit) against JAX's banded_traceback, every output exactly."""
    _walk_both("hp-runs", mode, frac)


@pytest.mark.parametrize("frac", ["3T/8", "T"])
@pytest.mark.parametrize("mode", ["hp", "hp-ties", "hp-gen"])
def test_plain_traceback_on_hp_edge_words_matches_jax(mode, frac):
    """The same walk over the cell words of ``hp-tile-edges``, whose H
    runs start and end on the edges of K1's and K2's 16-row tiles."""
    _walk_both("hp-tile-edges", mode, frac)


def test_qv_excludes_the_hp_band():
    arrs = _torch(banded_case("hp-runs"))
    q = torch.zeros(arrs[0].shape, dtype=torch.int32)
    with pytest.raises(ValueError):
        tb.banded_align(*arrs, torch.zeros(25), 4.0, 4.0, 5.0, 5.0,
                        use_hp=True, qv1=q, qv2=q)

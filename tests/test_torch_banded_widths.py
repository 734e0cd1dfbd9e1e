"""The port's plain banded DP and traceback at band widths other than 128
against the JAX package.

JAX's ``banded_align`` (XLA) and ``banded_traceback`` run at any ``w_b``,
and the JAX Mapper sends every width but 128 there; the port's plain
versions must equal them exactly there too, as they are what K1-W and K2-W
(csrc/banded_dp_wide.cu, csrc/banded_traceback_wide.cu) are held to on the
card.  The inputs are tests/torch_edge_cases.py::wide_case (the K1
tile-edge shapes, the homopolymer world and offsets beyond K1's slope
limit) at each width:

* the DP in distance mode at w_b 48, 64 and 256; QV, hp, GEN, hp-GEN and
  QV-GEN at 64; QV at 256; distance at 128 on the same inputs (score,
  tbbits, final_state, valid);
* the walk on the port's cell words of every mode at a width, in one
  batch, at t_max = 3T/8 and T (every output);
* the DP and the walk at K1-W's lane-count edges (31, 32, 33, 255, 256,
  257) on the shifts that move its warp layout by whole and part lanes
  (tests/torch_edge_cases.py::lane_shifts, cut to 48 rows).

JAX compiles once per width and form (the matrix is an argument, so a
GEN mode shares its form's program): seven DP programs and six walks."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from blasr_tpu.kernels.banded import BandedResult as JaxBandedResult  # noqa: E402
from blasr_tpu.kernels.banded import banded_align as jax_banded_align  # noqa: E402
from blasr_tpu.kernels.banded import banded_traceback as jax_traceback  # noqa: E402
from blasr_tpu_torch.kernels import banded as tb  # noqa: E402
from test_torch_cuda import qv_words  # noqa: E402
from torch_edge_cases import (BANDED_QV_SEED, DEFAULT_SUBMAT,  # noqa: E402
                              K1_MODES, LANE_WIDTHS, WIDE_WIDTHS,
                              cut_rows, k1_mode_kwargs, lane_shifts,
                              wide_case)
from torch_shared import TORCH_THREADS  # noqa: E402

torch.set_num_threads(TORCH_THREADS)

# (mode, w_b) of the DP cases; a mode is "distance", "qv" or a K1_MODES key
# ("distance", 128) holds the wild-shifts offsets at K1's width too: the
# plain DP once read a band that steps back by clamping where JAX's
# dynamic_slice wraps (kernels/banded.py::_shift)
DP_CASES = [("distance", 48), ("distance", 64), ("distance", 256),
            ("qv", 64), ("hp", 64), ("gen", 64), ("hp-gen", 64),
            ("qv-gen", 64), ("qv", 256), ("distance", 128)]
FIELDS = ("score", "tbbits", "final_state", "valid")


def mode_args(mode, N, L):
    """(matrix, gap costs, keyword arguments) of a mode, the QV words as
    numpy arrays."""
    if mode in ("distance", "qv"):
        sub, gaps, kw = DEFAULT_SUBMAT, (4.0, 4.0, 5.0, 5.0), {}
    else:
        sub, gaps, kw = k1_mode_kwargs(mode)
    if mode == "qv" or (mode in K1_MODES and K1_MODES[mode][3]):
        q1, q2 = qv_words(np.random.default_rng(BANDED_QV_SEED), N, L)
        kw = dict(kw, qv1=q1, qv2=q2)
    return sub, gaps, kw


@functools.lru_cache(maxsize=None)
def plain_dp(mode, w_b):
    arrs = wide_case(w_b)
    sub, gaps, kw = mode_args(mode, *arrs[0].shape)
    kw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
          for k, v in kw.items()}
    return tb.banded_align(*(torch.from_numpy(a) for a in arrs),
                           torch.from_numpy(sub), *gaps, w_b=w_b, **kw)


@pytest.mark.parametrize("mode,w_b", DP_CASES,
                         ids=[f"{m}-{w}" for m, w in DP_CASES])
def test_plain_dp_matches_jax_at_width(mode, w_b):
    arrs = wide_case(w_b)
    N = arrs[0].shape[0]
    sub, gaps, kw = mode_args(mode, N, arrs[0].shape[1])
    jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    ref = jax_banded_align(*(jnp.asarray(a) for a in arrs),
                           jnp.asarray(sub), *gaps, w_b=w_b, **jkw)
    out = plain_dp(mode, w_b)
    assert out.tbbits.shape == (N, arrs[0].shape[1], w_b)
    for name in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(ref, name)),
                                      getattr(out, name).numpy(),
                                      err_msg=name)
    # the tile-edges items align at every width (the others may leave a
    # narrow band: negative-offsets starts 40 columns left of the path)
    assert out.valid[:4].all() and int(out.valid.sum()) >= N // 2


WALKS = [(w_b, frac) for w_b in WIDE_WIDTHS for frac in ("3T/8", "T")]


@pytest.mark.parametrize("w_b,frac", WALKS,
                         ids=[f"{w}-{f}" for w, f in WALKS])
def test_plain_traceback_matches_jax_at_width(w_b, frac):
    """The walk over the cell words of every DP case at ``w_b``, in one
    batch."""
    arrs = wide_case(w_b)
    L, W = arrs[0].shape[1], arrs[1].shape[1]
    t_max = (3 * (L + W)) // 8 if frac == "3T/8" else L + W
    modes = [m for m, w in DP_CASES if w == w_b]
    res = [plain_dp(m, w_b) for m in modes]
    res = tb.BandedResult(*(torch.cat(x) for x in zip(*res)))
    rest = [np.concatenate([a] * len(modes)) for a in arrs[2:]]
    jt = jax_traceback(JaxBandedResult(*(jnp.asarray(x.numpy())
                                         for x in res)),
                       *(jnp.asarray(x) for x in rest), t_max=t_max,
                       w_b=w_b)
    got = tb.banded_traceback(res, *(torch.from_numpy(x) for x in rest),
                              t_max=t_max, w_b=w_b)
    for name in tb.TracebackResult._fields:
        np.testing.assert_array_equal(np.asarray(getattr(jt, name)),
                                      getattr(got, name).numpy(),
                                      err_msg=name)
    assert got.n_pairs[res.valid].min() > 0
    if frac == "T":
        assert not got.overflow.any()


@pytest.mark.parametrize("w_b", LANE_WIDTHS)
def test_plain_dp_and_walk_match_jax_on_lane_shifts(w_b):
    """The plain DP (distance mode) and the walk (t_max = T) against JAX
    on the lane_shifts items at ``w_b``, cut to 48 rows: steps back by 1
    (the diagonal slice starts past the row), by w_b + 1 and past the
    row's start (the start wraps), and by whole and part lanes of K1-W's
    layout."""
    arrs = cut_rows(lane_shifts(w_b), 48, w_b)
    sub, gaps, _ = mode_args("distance", *arrs[0].shape)
    ref = jax_banded_align(*(jnp.asarray(a) for a in arrs),
                           jnp.asarray(sub), *gaps, w_b=w_b)
    out = tb.banded_align(*(torch.from_numpy(a) for a in arrs),
                          torch.from_numpy(sub), *gaps, w_b=w_b)
    for name in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(ref, name)),
                                      getattr(out, name).numpy(),
                                      err_msg=name)
    assert out.valid[0]
    L, W = arrs[0].shape[1], arrs[1].shape[1]
    jt = jax_traceback(JaxBandedResult(*(jnp.asarray(x.numpy())
                                         for x in out)),
                       *(jnp.asarray(x) for x in arrs[2:]), t_max=L + W,
                       w_b=w_b)
    got = tb.banded_traceback(out, *(torch.from_numpy(x) for x in arrs[2:]),
                              t_max=L + W, w_b=w_b)
    for name in tb.TracebackResult._fields:
        np.testing.assert_array_equal(np.asarray(getattr(jt, name)),
                                      getattr(got, name).numpy(),
                                      err_msg=name)
    assert int(got.n_pairs[0]) > 0 and not got.overflow.any()

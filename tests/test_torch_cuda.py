"""The hand-written CUDA kernels (K1 banded DP in its distance and QV
modes, K2 traceback walk) against their plain PyTorch versions, on a card.
Skipped without a CUDA device.

The GPU machine has no JAX, and tests/conftest.py imports it, so run this
file there without the conftest:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from blasr_tpu_torch.params import MappingParams  # noqa: E402
from blasr_tpu_torch.kernels import banded as tb  # noqa: E402
from blasr_tpu_torch.kernels import cuda_ops  # noqa: E402
from blasr_tpu_torch.kernels import pallas_banded as tpb  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _case(rng, N, L, W, steep=(), w_b=128):
    """Planted noisy diagonals (tests/test_pallas_banded.py::_random_case),
    numpy and torch only; ``steep`` items need a deletion per row and
    overflow a small t_max."""
    reads = rng.integers(0, 4, (N, L)).astype(np.int8)
    windows = rng.integers(0, 4, (N, W)).astype(np.int8)
    qa = rng.integers(0, 8, N).astype(np.int32)
    qb = (qa + rng.integers(L // 2, L - 8, N)).astype(np.int32)
    ta = rng.integers(1, 40, N).astype(np.int32)
    tbv = np.zeros(N, np.int32)
    offs = np.zeros((N, L), np.int32)
    for i in range(N):
        slope = 2 if i in steep else 1
        if i in steep:
            qb[i] = qa[i] + min(L - 8, (W - int(ta[i]) - 2 * w_b) // 2)
            span = int(qb[i] - qa[i])
            windows[i, ta[i]:ta[i] + 2 * span:2] = reads[i, qa[i]:qb[i]]
            tbv[i] = ta[i] + 2 * span
        else:
            t = int(ta[i])
            for r in range(qa[i], qb[i]):
                u = rng.random()
                if u < 0.08:
                    pass
                elif u < 0.16 and t + 2 < W:
                    t += 2
                else:
                    windows[i, t] = reads[i, r]
                    t += 1
                t = min(t, W - 1)
            tbv[i] = min(t + 1, W)
        center = np.minimum(
            ta[i] + slope * np.maximum(np.arange(L) - int(qa[i]), 0), W - 1)
        offs[i] = np.clip(center - w_b // 2, 0, W - w_b)
    offs = tpb.slope_limit_offsets(torch.from_numpy(offs), w_b).numpy()
    return [torch.from_numpy(np.ascontiguousarray(a))
            for a in (reads, windows, offs, qa, qb, ta, tbv)]


def _submat():
    return np.asarray(MappingParams().make_sane().score_matrix,
                      np.float32).reshape(25)


def test_kernels_match_plain(cuda):
    args = [t.to(cuda) for t in _case(np.random.default_rng(17), 13, 256,
                                      640, steep=(2, 7))]
    sm = _submat()
    before = dict(cuda_ops.LAUNCHES)
    k1 = tpb.banded_align_cuda(*args, sm, 4.0, 4.0, 5.0, 5.0)
    p1 = tb.banded_align(*args, sm, 4.0, 4.0, 5.0, 5.0)
    for name, a, b in zip(k1._fields, k1, p1):
        assert torch.equal(a, b), name
    overflowed = 0
    for t_max in (128, 256 + 640):
        k2 = tb.banded_traceback(k1, *args[2:], t_max=t_max)
        p2 = tb.banded_traceback_plain(k1, *args[2:], t_max=t_max)
        for name, a, b in zip(k2._fields, k2, p2):
            assert torch.equal(a, b), (name, t_max)
        overflowed += int(k2.overflow.sum())
    assert overflowed >= 2
    assert cuda_ops.LAUNCHES["banded_dp"] == before["banded_dp"] + 1
    assert cuda_ops.LAUNCHES["banded_traceback"] == \
        before["banded_traceback"] + 2


def qv_words(rng, N, L, flavours=("ids", "qv", "none")):
    """Packed QV words (kernels/banded.py::unpack_qv layout), item i in
    flavour ``flavours[i % len(flavours)]``, the three that
    Mapper.pack_qv_rows makes: "ids" (random IDS costs, tags 0-3 and 7,
    the global priors), "qv" (plain base qualities 8-39 as the mismatch
    prior, flat indels) and "none" (the flat costs)."""
    p = MappingParams().make_sane()
    mm = int(_submat()[1])
    q1 = np.zeros((N, L), np.int64)
    q2 = np.zeros((N, L), np.int64)
    z, seven = np.zeros(L, np.int64), np.full(L, 7, np.int64)
    for i in range(N):
        f = flavours[i % len(flavours)]
        if f == "ids":
            insq, delq, subq = (rng.integers(1, 30, L) for _ in range(3))
            dtag, stag = (rng.choice([0, 1, 2, 3, 7], L) for _ in range(2))
            dpri = np.full(L, p.global_deletion_prior)
            spri = np.full(L, p.substitution_prior)
        elif f == "qv":
            insq, delq, subq, dtag, stag = (np.full(L, p.indel), z, z,
                                            seven, seven)
            dpri, spri = np.full(L, p.indel), rng.integers(8, 40, L)
        else:
            insq, delq, subq, dtag, stag = (np.full(L, p.insertion), z, z,
                                            seven, seven)
            dpri, spri = np.full(L, p.deletion), np.full(L, mm)
        q1[i] = insq | (delq << 8) | (subq << 16) | (dtag << 24) | (stag << 27)
        q2[i] = dpri | (spri << 8)
    return q1.astype(np.int32), q2.astype(np.int32)


def test_qv_kernel_matches_plain(cuda):
    """K1-QV against the plain QV DP, exactly, on every output."""
    rng = np.random.default_rng(29)
    args = [t.to(cuda) for t in _case(rng, 14, 256, 640, steep=(4,))]
    q1, q2 = (torch.from_numpy(q).to(cuda)
              for q in qv_words(rng, 14, 256))
    sm = _submat()
    before = dict(cuda_ops.LAUNCHES)
    k1 = tpb.banded_align_cuda(*args, sm, 4.0, 4.0, 5.0, 5.0, qv1=q1, qv2=q2)
    p1 = tb.banded_align(*args, sm, 4.0, 4.0, 5.0, 5.0, qv1=q1, qv2=q2)
    assert k1.valid.sum() >= 12
    for name, a, b in zip(k1._fields, k1, p1):
        assert torch.equal(a, b), name
    assert cuda_ops.LAUNCHES["banded_dp_qv"] == before["banded_dp_qv"] + 1
    assert cuda_ops.LAUNCHES["banded_dp"] == before["banded_dp"]
    with pytest.raises(ValueError):
        cuda_ops.banded_dp_launch(*args, match=-5.0, mismatch=6.0,
                                  ins_open=4.0, ins_ext=4.0, del_open=5.0,
                                  del_ext=5.0, qv1=q1)
    with pytest.raises(TypeError):
        cuda_ops.banded_dp_launch(*args, match=-5.0, mismatch=6.0,
                                  ins_open=4.0, ins_ext=4.0, del_open=5.0,
                                  del_ext=5.0, qv1=q1.to(torch.int64),
                                  qv2=q2)


def test_wrappers_check_their_inputs(cuda):
    args = [t.to(cuda) for t in _case(np.random.default_rng(3), 4, 128,
                                      384)]
    kw = dict(match=-5.0, mismatch=6.0, ins_open=4.0, ins_ext=4.0,
              del_open=5.0, del_ext=5.0)
    with pytest.raises(TypeError):
        cuda_ops.banded_dp_launch(*args[:2], args[2].to(torch.int64),
                                  *args[3:], **kw)
    with pytest.raises(ValueError):
        cuda_ops.banded_dp_launch(args[0].t().contiguous().t(), *args[1:],
                                  **kw)
    with pytest.raises(ValueError):
        cuda_ops.banded_dp_launch(args[0].cpu(), *args[1:], **kw)

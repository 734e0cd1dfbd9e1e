"""The run-length traceback through an index of DP rows (``rows=``).

``banded_traceback(res, ..., rows=idx)`` walks the DP rows ``idx`` of a
batch's result in place; it must give, every output exactly, what the
walk gives on the result and arguments gathered by ``idx``, and what the
walk of every row gives at those rows.  The worlds: the planted walks of
``tests/torch_edge_cases.py::traceback_case`` (band 128, valid == 0 items
among them; the walks at the first case's t_max), its overflow case at its
small t_max beside the invalid items, and the plain DP's cell
words at band 64 on two K1 edge shapes (one all valid, one all invalid).
Then the structure of ``map_batch``: its traceback is handed K1's whole
result and an int64 index of the traced rows, never a gathered copy.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from blasr_tpu_torch.index.genome import build_genome_index  # noqa: E402
from blasr_tpu_torch.kernels import banded as tb  # noqa: E402
from blasr_tpu_torch.params import (MappingParams,  # noqa: E402
                                    ShapeConfig)
from blasr_tpu_torch.pipeline import map_read as tmr  # noqa: E402
from blasr_tpu_torch.sim import random_genome, simulate_reads  # noqa: E402
from torch_edge_cases import banded_case, traceback_case  # noqa: E402
from torch_shared import TORCH_THREADS, shared  # noqa: E402

torch.set_num_threads(TORCH_THREADS)

# the planted-walk cases of one shape (L = 256, t_max = 640)
WALK_CASES = ("m-runs-cross-tiles", "ends-on-tile-edges",
              "stall-on-tile-edge", "invalid-and-empty", "hp-walks")
WORLDS = ("walks", "overflow", "dp64")
INDICES = ("identity", "reversed", "repeats", "invalid-subset", "empty")


def _walk_world(names):
    parts = [traceback_case(n) for n in names]
    tbb, st, valid, off, qa, qb, ta, tbv = (
        np.concatenate([p[i] for p in parts]) for i in range(8))
    res = (np.zeros(len(st), np.float32), tbb.astype(np.int32),
           st.astype(np.int32), valid.astype(bool))
    args = tuple(x.astype(np.int32) for x in (off, qa, qb, ta, tbv))
    return res, args, parts[0][8], 128


def _dp_world(w_b=64):
    sm = np.asarray(MappingParams().make_sane().score_matrix,
                    np.float32).reshape(25)
    cases = [banded_case(n, w_b=w_b)
             for n in ("tile-edges", "negative-offsets")]
    arrs = [torch.from_numpy(np.concatenate([c[i] for c in cases]))
            for i in range(7)]
    res = tb.banded_align(*arrs, sm, 4.0, 4.0, 5.0, 5.0, w_b=w_b)
    L, W = arrs[0].shape[1], arrs[1].shape[1]
    return (tuple(x.numpy() for x in res),
            tuple(a.numpy() for a in arrs[2:]), L + W, w_b)


def _build(name):
    if name == "walks":
        return _walk_world(WALK_CASES)
    if name == "overflow":
        return _walk_world(("overflow-and-band-exit", "invalid-and-empty"))
    return _dp_world()


def _index(name, valid):
    n = len(valid)
    if name == "identity":
        return np.arange(n)
    if name == "reversed":
        return np.arange(n)[::-1].copy()
    if name == "repeats":
        idx = np.random.default_rng(n).integers(0, n, n + 5)
        assert len(np.unique(idx)) < len(idx)
        return idx
    if name == "invalid-subset":
        bad, good = np.flatnonzero(~valid), np.flatnonzero(valid)
        assert len(bad) and len(good)
        return np.concatenate([good[1::2], bad[::-1], good[:1]])
    return np.zeros(0, np.int64)


@pytest.mark.parametrize("index", INDICES)
@pytest.mark.parametrize("world", WORLDS)
def test_traceback_through_rows_equals_the_gathered_walk(
        tmp_path_factory, world, index):
    """The walk through ``rows`` against the walk on the result and its
    arguments gathered by the same index, and against the walk of every
    row at those rows: every output, dtype and shape exactly."""
    res_np, args_np, t_max, w_b = shared(tmp_path_factory, __file__, world,
                                         lambda d: _build(world))
    res = tb.BandedResult(*(torch.from_numpy(x) for x in res_np))
    args = [torch.from_numpy(x) for x in args_np]
    idx = torch.from_numpy(_index(index, res_np[3]).astype(np.int64))
    got = tb.banded_traceback(res, *args, t_max=t_max, w_b=w_b, rows=idx)
    copy = tb.banded_traceback(tb.BandedResult(*(x[idx] for x in res)),
                               *(a[idx] for a in args), t_max=t_max, w_b=w_b)
    full = tb.banded_traceback(res, *args, t_max=t_max, w_b=w_b)
    assert got.pairs.shape == (len(idx), tb.pair_capacity(t_max) // 2)
    for f in got._fields:
        a, b, c = getattr(got, f), getattr(copy, f), getattr(full, f)[idx]
        assert a.dtype == b.dtype == c.dtype, f
        assert torch.equal(a, b) and torch.equal(a, c), f
    if index == "identity":
        assert bool(full.overflow.any()) == (world == "overflow")


def test_map_batch_walks_k1_result_through_the_traced_rows():
    """``map_batch`` (the plain path) hands the traceback K1's own result,
    the whole ``[n_dp, L, w_b]`` cell words, with the DP rows' offsets and
    bounds and an int64 ``rows`` of the n_tb traced rows: no gathered copy
    of them precedes the walk."""
    contigs = random_genome(30_000, seed=221, n_contigs=1)
    sims = simulate_reads(contigs, 3, read_len=(300, 480), accuracy=0.88,
                          seed=222)
    gi = build_genome_index(contigs, k=12)
    cfg = ShapeConfig(buckets=(512,), batch_size=4)
    mapper = tmr.Mapper(gi, MappingParams().make_sane(), cfg, device="cpu")
    L = 512
    reads = torch.full((cfg.batch_size, L), 4, dtype=torch.int8)
    lens = torch.zeros(cfg.batch_size, dtype=torch.int32)
    for i, s in enumerate(sims):
        seq = torch.as_tensor(np.asarray(s.rec.seq, np.int8))
        reads[i, :len(seq)] = seq
        lens[i] = len(seq)
    seen = {}
    # K1 is banded_align_cuda where use_pallas is set (its plain DP on CPU
    # tensors), banded_align elsewhere
    inner = {n: getattr(tmr, n) for n in ("banded_align", "banded_align_cuda",
                                          "banded_traceback")}

    def k1(name):
        def call(*a, **kw):
            seen["k1"] = inner[name](*a, **kw)
            return seen["k1"]
        return call

    def k2(res, *a, **kw):
        seen["k2"] = (res, a, kw)
        return inner["banded_traceback"](res, *a, **kw)

    pos, kw = mapper._batch_call_args(L)
    tmr.banded_align = k1("banded_align")
    tmr.banded_align_cuda = k1("banded_align_cuda")
    tmr.banded_traceback = k2
    try:
        pb = tmr.map_batch(mapper.dev, reads, lens, *pos, **kw)
    finally:
        for n, f in inner.items():
            setattr(tmr, n, f)
    res, a, kwargs = seen["k2"]
    n_dp = res.tbbits.shape[0]
    assert res is seen["k1"]
    assert res.tbbits.shape == (n_dp, L, kw["w_b"])
    assert [tuple(x.shape) for x in a] == [(n_dp, L)] + [(n_dp,)] * 4
    rows = kwargs["rows"]
    n_tb = min(cfg.batch_size * kw["C"], n_dp)
    assert rows.dtype == torch.int64 and rows.shape == (n_tb,)
    assert n_tb < n_dp and bool(((rows >= 0) & (rows < n_dp)).all())
    assert tmr.unpack_batch(pb).valid.any()

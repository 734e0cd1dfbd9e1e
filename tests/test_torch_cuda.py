"""The hand-written CUDA kernels (K1 banded DP in its distance, QV, hp
band and general-matrix modes, K2 traceback walk, K3 chain scan, K4 SDP
window pass, K5 anchor search with its block mode, K6 band offsets, K7
chain members; K1-W and K2-W, the DP and walk at other band widths, K4
and K6 at band widths 64 and 256, and the Mapper at band 64 on the card
against the CPU) against their plain PyTorch versions, on a card; the
Mapper's batches as CUDA graph replays (``pipeline/graphs.py``) against
eager dispatch; and the
pairwise SDP path (``sdp_align``, the ``sdpMatcher`` CLI) on the card
against the same calls on the CPU; the multi-device paths
(``dist/mesh.py``) on two gloo ranks of the card against the same ranks on
the CPU.  Skipped without a CUDA
device.  K1 in every mode and K2-K6 take the edge inputs of
``tests/torch_edge_cases.py`` (K2 its planted walks and K1's cell words
on the K1 edge shapes, the hp ones included), on which
``tests/test_torch_banded.py``, ``tests/test_torch_banded_modes.py``,
``tests/test_torch_chain_sdp_edges.py`` and
``tests/test_torch_anchor_band_edges.py`` and ``tests/test_torch_sdp.py``
(K7's) hold the plain versions to JAX; K3 also at A = 8192 (beyond one block's shared memory) and K4 at
L = 65536 (a row's slab spread over many CTAs).

The GPU machine has no JAX, and tests/conftest.py imports it, so run this
file there without the conftest:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda.py
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from blasr_tpu_torch.params import MappingParams  # noqa: E402
from blasr_tpu_torch.kernels import banded as tb  # noqa: E402
from blasr_tpu_torch.kernels import cuda_ops  # noqa: E402
from blasr_tpu_torch.kernels import pallas_banded as tpb  # noqa: E402
from blasr_tpu_torch.kernels import anchor as tanchor  # noqa: E402
from blasr_tpu_torch.kernels import chain as tchain  # noqa: E402
from blasr_tpu_torch.kernels import sdp as tsdp  # noqa: E402
from blasr_tpu_torch.index.genome import build_genome_index  # noqa: E402
from blasr_tpu_torch.io.fasta import FastaRecord  # noqa: E402
from blasr_tpu_torch.pipeline import map_read as tmr  # noqa: E402
from torch_edge_cases import (ANCHOR_CASES, BAND_CASES,  # noqa: E402
                              BANDED_CASES, BANDED_QV_SEED, CHAIN_CASES,
                              K1_MODE_CASES, K1_MODES, K_SDP,
                              MEMBER_CASES, MEMBER_PATH_CASES, SDP_CASES,
                              GROUP_WIDTHS, LANE_WIDTHS, ODD_ROWS,
                              RING_WIDTHS, TRACEBACK_CASES, WIDE_WIDTHS,
                              anchor_case,
                              anchor_world, band_case, banded_case,
                              chain_case, chain_rows, k1_mode_kwargs,
                              long_sdp_case, member_case, sdp_case,
                              traceback_case, wide_case)

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


def _scrambled_rows(n, device, seed=0):
    """About half of ``n`` DP rows in a scrambled order and the first of
    them again: an index of the rows to walk (int64)."""
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(seed))
    return torch.cat([perm[:(n + 1) // 2], perm[:1]]).to(device)


def _same_indexed_walk(res, rest, t_max, k2, w_b=128, rows=None):
    """K2 (K2-W at a band width other than 128) through an index of the DP
    rows (``rows``, by default :func:`_scrambled_rows`) against K2 on the
    result and arguments gathered by it, against the plain walk through
    the same index and against ``k2`` (the walk of every row) at those
    rows, every output exactly; one launch, counted in INDEXED_WALKS."""
    if rows is None:
        rows = _scrambled_rows(res.tbbits.shape[0], res.tbbits.device)
    key = "banded_traceback" if w_b == 128 else "banded_traceback_w"
    before, walks = cuda_ops.LAUNCHES[key], cuda_ops.INDEXED_WALKS
    got = tb.banded_traceback(res, *rest, t_max=t_max, w_b=w_b, rows=rows)
    torch.cuda.synchronize()
    assert cuda_ops.LAUNCHES[key] == before + 1
    assert cuda_ops.INDEXED_WALKS == walks + 1
    copy = tb.banded_traceback(tb.BandedResult(*(x[rows] for x in res)),
                               *(a[rows] for a in rest), t_max=t_max,
                               w_b=w_b)
    assert cuda_ops.INDEXED_WALKS == walks + 1
    plain = tb.banded_traceback_plain(res, *rest, t_max=t_max, w_b=w_b,
                                      rows=rows)
    assert got.pairs.shape[0] == rows.shape[0]
    for name in got._fields:
        a = getattr(got, name)
        for b in (getattr(copy, name), getattr(plain, name),
                  getattr(k2, name)[rows]):
            assert a.dtype == b.dtype and torch.equal(a, b), (name, t_max)
    return got


def _same_walk(res, rest, t_max):
    """K2 against the plain walk on the same CUDA tensors, every output
    exactly, one launch; the pair buffer the kernel fills is handed out
    dirty first, so the zeros after each stop are the kernel's own.  Then
    K2 through an index of the rows (:func:`_same_indexed_walk`)."""
    N = res.tbbits.shape[0]
    P = tb.pair_capacity(t_max)
    torch.full((N, P // 2), -1, dtype=torch.int32, device=res.tbbits.device)
    before = cuda_ops.LAUNCHES["banded_traceback"]
    k2 = tb.banded_traceback(res, *rest, t_max=t_max)
    torch.cuda.synchronize()
    assert cuda_ops.LAUNCHES["banded_traceback"] == before + 1
    p2 = tb.banded_traceback_plain(res, *rest, t_max=t_max)
    for name, a, b in zip(k2._fields, k2, p2):
        assert a.dtype == b.dtype and torch.equal(a, b), (name, t_max)
    _same_indexed_walk(res, rest, t_max, k2)
    return k2


@pytest.mark.parametrize("frac", ["3T/8", "T"])
def test_traceback_kernel_through_rows_at_bench_shape(cuda, frac):
    """K2 at the bench's DP shape (N = 640, L = 2048, W = 3072) walking
    n_tb = 320 of K1's rows in a scrambled order, in place: equal to K2 on
    the gathered copy, to the plain walk and to the walk of every row at
    those rows; the launch counted in INDEXED_WALKS."""
    N, L, W = 640, 2048, 3072
    args = [t.to(cuda) for t in _case(np.random.default_rng(22), N, L, W,
                                      steep=(5, 300))]
    k1 = tpb.banded_align_cuda(*args, _submat(), 4.0, 4.0, 5.0, 5.0)
    t_max = (3 * (L + W)) // 8 if frac == "3T/8" else L + W
    rows = torch.randperm(N, generator=torch.Generator().manual_seed(320))[
        :N // 2].to(cuda)
    full = tb.banded_traceback(k1, *args[2:], t_max=t_max)
    got = _same_indexed_walk(k1, args[2:], t_max, full, rows=rows)
    assert got.pairs.shape[0] == 320 and bool(k1.valid[rows].any())


@pytest.mark.parametrize("name", list(TRACEBACK_CASES))
def test_traceback_kernel_edges_match_plain(cuda, name):
    """K2 on the planted walks of tests/torch_edge_cases.py::
    traceback_case: M runs across its 16-row tiles, qa / qb - 1 on tile
    edges, stalls on tile edges, L = 200, valid == 0 items, overflow at P,
    a walk leaving the band."""
    tbb, st, valid, off, qa, qb, ta, tbv, t_max = traceback_case(name)
    res = tb.BandedResult(torch.zeros(len(st), device=cuda),
                          *(torch.from_numpy(x).to(cuda)
                            for x in (tbb, st, valid)))
    _same_walk(res, [torch.from_numpy(x).to(cuda)
                     for x in (off, qa, qb, ta, tbv)], t_max)


@pytest.mark.parametrize("frac", ["3T/8", "T"])
@pytest.mark.parametrize("name", BANDED_CASES)
def test_traceback_kernel_dp_edges_match_plain(cuda, name, frac):
    """K2 on K1's cell words of each K1 edge shape, at t_max = 3T/8 and
    T."""
    args = [torch.from_numpy(a).to(cuda) for a in banded_case(name)]
    L, W = args[0].shape[1], args[1].shape[1]
    t_max = (3 * (L + W)) // 8 if frac == "3T/8" else L + W
    k1 = tpb.banded_align_cuda(*args, _submat(), 4.0, 4.0, 5.0, 5.0)
    _same_walk(k1, args[2:], t_max)


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


@pytest.mark.parametrize("mode", ["distance", "qv"])
@pytest.mark.parametrize("name", BANDED_CASES)
def test_dp_kernel_edges_match_plain(cuda, name, mode):
    """K1 / K1-QV against the plain DP on the edge shapes of its 16-row
    tiles (tests/torch_edge_cases.py::banded_case), every output exactly,
    one launch per call."""
    arrs = banded_case(name)
    N, L = arrs[0].shape
    args = [torch.from_numpy(a).to(cuda) for a in arrs]
    qv = {}
    if mode == "qv":
        q1, q2 = qv_words(np.random.default_rng(BANDED_QV_SEED), N, L)
        qv = dict(qv1=torch.from_numpy(q1).to(cuda),
                  qv2=torch.from_numpy(q2).to(cuda))
    key = "banded_dp_qv" if qv else "banded_dp"
    sm = _submat()
    before = cuda_ops.LAUNCHES[key]
    k1 = tpb.banded_align_cuda(*args, sm, 4.0, 4.0, 5.0, 5.0, **qv)
    torch.cuda.synchronize()
    assert cuda_ops.LAUNCHES[key] == before + 1
    p1 = tb.banded_align(*args, sm, 4.0, 4.0, 5.0, 5.0, **qv)
    assert p1.valid.sum() >= N - 1
    for f, a, b in zip(k1._fields, k1, p1):
        assert a.dtype == b.dtype and torch.equal(a, b), f


def _k1_mode(cuda, name, mode):
    """(K1 in ``mode`` on edge shape ``name``, the plain DP, the inputs),
    after asserting one launch of the mode's own count and none of the
    others'."""
    arrs = banded_case(name)
    N, L = arrs[0].shape
    args = [torch.from_numpy(a).to(cuda) for a in arrs]
    submat, gaps, kw = k1_mode_kwargs(mode)
    if K1_MODES[mode][3]:
        q1, q2 = qv_words(np.random.default_rng(BANDED_QV_SEED), N, L)
        kw = dict(kw, qv1=torch.from_numpy(q1).to(cuda),
                  qv2=torch.from_numpy(q2).to(cuda))
    before = dict(cuda_ops.LAUNCHES)
    k1 = tpb.banded_align_cuda(*args, submat, *gaps, **kw)
    torch.cuda.synchronize()
    after = dict(cuda_ops.LAUNCHES)
    key = cuda_ops.dp_launch_key(K1_MODES[mode][3], "use_hp" in kw,
                                 not tpb.two_valued(submat))
    assert {k: after[k] - before[k] for k in after
            if k.startswith("banded_dp")} == {
        k: int(k == key) for k in after if k.startswith("banded_dp")}
    return k1, tb.banded_align(*args, submat, *gaps, **kw), args


@pytest.mark.parametrize("mode", list(K1_MODES))
@pytest.mark.parametrize("name", K1_MODE_CASES)
def test_dp_kernel_modes_match_plain(cuda, name, mode):
    """K1-HP and the GEN forms (distance, hp, QV) against the plain DP on
    the tile-edge shapes and the homopolymer world, every output
    exactly, one launch of the mode's own count."""
    k1, p1, args = _k1_mode(cuda, name, mode)
    assert p1.valid.sum() >= args[0].shape[0] - 1
    for f, a, b in zip(k1._fields, k1, p1):
        assert a.dtype == b.dtype and torch.equal(a, b), f


@pytest.mark.parametrize("frac", ["3T/8", "T"])
@pytest.mark.parametrize("mode", ["hp", "hp-ties", "hp-gen"])
@pytest.mark.parametrize("name", ["hp-runs", "hp-tile-edges"])
def test_traceback_kernel_hp_words_match_plain(cuda, name, mode, frac):
    """K2 over K1-HP's cell words of the homopolymer world and of the H
    runs on tile edges (H states and h_open bits) against the plain
    walk."""
    k1, _, args = _k1_mode(cuda, name, mode)
    assert ((k1.tbbits & 3) == tb.ST_H).any() or mode == "hp-ties"
    L, W = args[0].shape[1], args[1].shape[1]
    t_max = (3 * (L + W)) // 8 if frac == "3T/8" else L + W
    _same_walk(k1, args[2:], t_max)


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
    q = torch.zeros(args[0].shape, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):       # the QV mode has no hp band
        cuda_ops.banded_dp_launch(*args, **kw, qv1=q, qv2=q, use_hp=True)
    with pytest.raises(ValueError):       # 25 matrix entries
        cuda_ops.banded_dp_launch(*args, **kw, submat=np.zeros(24))


def _anchors(c, dev):
    return tanchor.Anchors(
        q=torch.from_numpy(c["q"]).to(dev), t=torch.from_numpy(c["t"]).to(dev),
        l=torch.from_numpy(c["l"]).to(dev),
        valid=torch.from_numpy(c["valid"]).to(dev),
        n_total=torch.from_numpy(c["valid"].sum(1).astype(np.int32)).to(dev),
        nlogp=torch.from_numpy(c["nlogp"]).to(dev))


@pytest.mark.parametrize("name", list(CHAIN_CASES))
def test_chain_kernel_matches_plain(cuda, name):
    """K3 against chain_anchors_plain on the same CUDA tensors, every
    Candidates field exactly, one launch per call."""
    c, kw = chain_case(name)
    anchors = _anchors(c, cuda)
    rlen = torch.from_numpy(c["read_len"]).to(cuda)
    before = cuda_ops.LAUNCHES["chain_scan"]
    k3 = tchain.chain_anchors(anchors, rlen, **kw)
    torch.cuda.synchronize()
    assert cuda_ops.LAUNCHES["chain_scan"] == before + 1
    plain = tchain.chain_anchors_plain(anchors, rlen, **kw)
    for f, a, b in zip(tchain.Candidates._fields, k3, plain):
        assert a.dtype == b.dtype and torch.equal(a, b), f


def test_chain_kernel_reads_both_widths(cuda):
    """K3 reads int32 anchors and read lengths (the JAX package's dtypes)
    as it reads the mapper's int64 ones: the same Candidates, int64
    fields written by the kernel."""
    c, kw = chain_case("lookback17")
    wide = _anchors(c, cuda)
    rlen = torch.from_numpy(c["read_len"]).to(cuda)
    narrow = wide._replace(q=wide.q.int(), t=wide.t.int(), l=wide.l.int())
    a = tchain.chain_anchors(wide, rlen.long(), **kw)
    b = tchain.chain_anchors(narrow, rlen, **kw)
    for f, x, y in zip(tchain.Candidates._fields, a, b):
        assert x.dtype == y.dtype and torch.equal(x, y), f
    assert a.parent.dtype == torch.int64 and a.end_idx.dtype == torch.int64


@pytest.mark.parametrize("name", SDP_CASES)
def test_sdp_kernel_matches_plain(cuda, name):
    """K4 against window_fragment_diags_banded_plain on the same CUDA
    tensors, exactly, one launch per call."""
    reads, rlen, windows, wlens, offs, occ, k = sdp_case(name)
    rk, rv = tanchor.read_kmer_keys(torch.from_numpy(reads).to(cuda),
                                    torch.from_numpy(rlen).to(cuda), k)
    args = (rk, rv, torch.from_numpy(windows).to(cuda),
            torch.from_numpy(wlens).to(cuda), torch.from_numpy(offs).to(cuda))
    before = cuda_ops.LAUNCHES["sdp_window"]
    k4 = tsdp.window_fragment_diags_banded(*args, k=k, occ=occ)
    torch.cuda.synchronize()
    assert cuda_ops.LAUNCHES["sdp_window"] == before + 1
    plain = tsdp.window_fragment_diags_banded_plain(*args, k=k, occ=occ)
    for a, b in zip(k4, plain):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_chain_and_sdp_wrappers_check_their_inputs(cuda):
    c, _ = chain_case("A100-pvt1")
    i32 = torch.int32
    B, A = c["q"].shape
    args = [torch.from_numpy(c[f]).to(cuda).to(i32) for f in ("q", "t", "l")]
    args += [torch.from_numpy(c["valid"]).to(cuda),
             torch.from_numpy(c["nlogp"]).to(cuda),
             torch.from_numpy(c["read_len"]).to(cuda)]
    kw = dict(n_cand=4, lookback=A, rate=1.3, drift_frac=0.35,
              drift_slack=50.0, drift_penalty=0.0, global_chain=False,
              rank_mode=1)
    before = dict(cuda_ops.LAUNCHES)
    with pytest.raises(TypeError):          # int64 q beside int32 t and l
        cuda_ops.chain_scan_launch(args[0].long(), *args[1:], **kw)
    with pytest.raises(TypeError):          # float read lengths
        cuda_ops.chain_scan_launch(*args[:5], args[5].float(), **kw)
    with pytest.raises(ValueError):         # one tensor on the CPU
        cuda_ops.chain_scan_launch(*args[:5], args[5].cpu(), **kw)
    with pytest.raises(ValueError):         # a row short
        cuda_ops.chain_scan_launch(args[0][1:].contiguous(), *args[1:], **kw)
    with pytest.raises(ValueError):         # a lookback beyond the row
        cuda_ops.chain_scan_launch(*args, **dict(kw, lookback=A + 1))
    reads, rlen, windows, wlens, offs, occ, k = sdp_case("straddle-occ2")
    rk, rv = tanchor.read_kmer_keys(torch.from_numpy(reads).to(cuda),
                                    torch.from_numpy(rlen).to(cuda), k)
    sargs = [rk, rv, *(torch.from_numpy(x).to(cuda)
                       for x in (windows, wlens, offs))]
    skw = dict(k=k, occ=occ, D=512, w_b=128)
    with pytest.raises(TypeError):          # int32 read keys
        cuda_ops.sdp_window_launch(rk.int(), *sargs[1:], **skw)
    with pytest.raises(TypeError):          # float offsets
        cuda_ops.sdp_window_launch(*sargs[:4], sargs[4].float(), **skw)
    with pytest.raises(ValueError):         # a window length short
        cuda_ops.sdp_window_launch(*sargs[:3], sargs[3][:3].contiguous(),
                                   sargs[4], **skw)
    with pytest.raises(ValueError):         # flags on the CPU
        cuda_ops.sdp_window_launch(rk, rv.cpu(), *sargs[2:], **skw)
    with pytest.raises(ValueError):
        cuda_ops.sdp_window_launch(*sargs, **dict(skw, occ=3))
    with pytest.raises(ValueError):
        cuda_ops.sdp_window_launch(*sargs, **dict(skw, k=33))
    with pytest.raises(ValueError):         # a slab wider than a block holds
        cuda_ops.sdp_window_launch(*sargs, **dict(skw, D=60_000))
    assert cuda_ops.LAUNCHES == before


def test_chain_kernel_wide_rows(cuda):
    """K3 at A = 8192, past CHAIN_MAX_ANCHORS: the rows' arrays sit in
    global scratch; every Candidates field equals the plain version's."""
    rng = np.random.default_rng(8192)
    A = 8192
    assert A > cuda_ops.CHAIN_MAX_ANCHORS
    c = chain_rows(rng, 2, A, (A, 6000), read_len=(20_000, 40_000))
    anchors = _anchors(c, cuda)
    rlen = torch.from_numpy(c["read_len"]).to(cuda)
    kw = dict(n_cand=20, rank_by_pvalue=True, p_value_type=0)
    before = cuda_ops.LAUNCHES["chain_scan"]
    k3 = tchain.chain_anchors(anchors, rlen, **kw)
    torch.cuda.synchronize()
    assert cuda_ops.LAUNCHES["chain_scan"] == before + 1
    plain = tchain.chain_anchors_plain(anchors, rlen, **kw)
    for f, a, b in zip(tchain.Candidates._fields, k3, plain):
        assert a.dtype == b.dtype and torch.equal(a, b), f
    assert (k3.parent >= 0).sum() > 1000


@pytest.mark.parametrize("occ", [2, 1])
def test_sdp_kernel_long_bucket(cuda, occ):
    """K4 at L = 65536, N = 4, D = 512: a row's L + D slab keys exceed
    one block's shared memory, so its query positions spread over 64 CTAs
    of 1024; equal to the plain version, one launch per call."""
    reads, rlen, windows, wlens, offs = long_sdp_case(
        np.random.default_rng(65536))
    rk, rv = tanchor.read_kmer_keys(torch.from_numpy(reads).to(cuda),
                                    torch.from_numpy(rlen).to(cuda), K_SDP)
    args = (rk, rv, *(torch.from_numpy(x).to(cuda)
                      for x in (windows, wlens, offs)))
    assert 4 * (reads.shape[1] + 512) > cuda_ops.SMEM_OPTIN
    before = cuda_ops.LAUNCHES["sdp_window"]
    k4 = tsdp.window_fragment_diags_banded(*args, k=K_SDP, occ=occ)
    torch.cuda.synchronize()
    assert cuda_ops.LAUNCHES["sdp_window"] == before + 1
    plain = tsdp.window_fragment_diags_banded_plain(*args, k=K_SDP, occ=occ)
    for a, b in zip(k4, plain):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert int(k4[1][..., 0].sum()) > 4 * 50_000
    if occ == 2:
        assert k4[1][..., 1].any()


@pytest.fixture(scope="module")
def edge_index_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gi = build_genome_index([FastaRecord("edge", anchor_world()[0])], k=12)
    return tmr.DeviceIndex.from_host(gi, "cuda")


def _find(fn, ix, reads, rlen, kw):
    return fn(ix.genome, ix.keys_sorted, ix.pos_sorted, reads, rlen, **kw,
              bucket_starts=ix.bucket_starts, bucket_pairs=ix.bucket_pairs,
              gwords=ix.gwords, gnwords=ix.gnwords,
              pos_records=ix.pos_records)


@pytest.mark.parametrize("name", list(ANCHOR_CASES))
def test_anchor_kernel_matches_plain(edge_index_cuda, name):
    """K5 against find_anchors_plain on the same CUDA tensors, every
    Anchors field exactly, one launch per call (the block-* cases in K5's
    block mode, counted apart)."""
    _, reads, rlen, kw, drop = anchor_case(name)
    ix = edge_index_cuda._replace(**{f: None for f in drop})
    r = torch.from_numpy(reads).cuda()
    rl = torch.from_numpy(rlen).cuda()
    key = ("anchor_search_block" if kw.get("occ_block_sample")
           else "anchor_search")
    before = cuda_ops.LAUNCHES[key]
    k5 = _find(tanchor.find_anchors, ix, r, rl, kw)
    torch.cuda.synchronize()
    assert cuda_ops.LAUNCHES[key] == before + 1
    plain = _find(tanchor.find_anchors_plain, ix, r, rl, kw)
    for f, a, b in zip(tanchor.Anchors._fields, k5, plain):
        assert a.dtype == b.dtype and torch.equal(a, b), f


@pytest.mark.parametrize("name", BAND_CASES)
def test_band_kernel_matches_plain(cuda, name):
    """K6 against _band_offsets_plain on the same CUDA tensors, exactly,
    one launch per call."""
    c = band_case(name)

    def t(x):
        return None if x is None else torch.from_numpy(x).to(cuda)

    args = (t(c["mq"]), t(c["mt"]), t(c["ws"]), c["L"], c["W"], c["w_b"],
            t(c["frag_diag"]), t(c["frag_valid"]), c["between_only"])
    before = cuda_ops.LAUNCHES["band_offsets"]
    k6 = tmr._band_offsets(*args)
    torch.cuda.synchronize()
    assert cuda_ops.LAUNCHES["band_offsets"] == before + 1
    plain = tmr._band_offsets_plain(*args)
    assert k6.dtype == plain.dtype and torch.equal(k6, plain)


def test_anchor_and_band_wrappers_check_their_inputs(edge_index_cuda):
    ix = edge_index_cuda
    _, reads, rlen, kw, _ = anchor_case("default")
    r = torch.from_numpy(reads).cuda()
    rl = torch.from_numpy(rlen).cuda()
    idx = dict(bucket_starts=ix.bucket_starts, bucket_pairs=ix.bucket_pairs,
               gwords=ix.gwords, gnwords=ix.gnwords,
               pos_records=ix.pos_records)
    before = dict(cuda_ops.LAUNCHES)
    base = (ix.genome, ix.keys_sorted, ix.pos_sorted)
    with pytest.raises(TypeError):          # int64 read lengths
        cuda_ops.anchor_search_launch(*base, r, rl.long(), **kw, **idx)
    with pytest.raises(ValueError):         # reads on the CPU
        cuda_ops.anchor_search_launch(*base, r.cpu(), rl, **kw, **idx)
    with pytest.raises(ValueError):         # a LUT of the wrong k
        cuda_ops.anchor_search_launch(*base, r, rl, **dict(kw, k=11), **idx)
    with pytest.raises(ValueError):         # no packed genome words
        cuda_ops.anchor_search_launch(*base, r, rl, **kw,
                                      **dict(idx, gwords=None))
    c = band_case("ends")
    m = [torch.from_numpy(c[f]).cuda() for f in ("mq", "mt", "ws")]
    fr = dict(frag_diag=torch.from_numpy(c["frag_diag"]).cuda(),
              frag_valid=torch.from_numpy(c["frag_valid"]).cuda())
    geo = dict(L=c["L"], W=c["W"], w_b=c["w_b"])
    with pytest.raises(TypeError):          # int32 members
        cuda_ops.band_offsets_launch(m[0].int(), *m[1:], **geo, **fr)
    with pytest.raises(ValueError):         # fragments of another L
        cuda_ops.band_offsets_launch(*m, **dict(geo, L=256), **fr)
    with pytest.raises(ValueError):         # a flag tensor without diagonals
        cuda_ops.band_offsets_launch(*m, **geo,
                                     frag_valid=fr["frag_valid"])
    with pytest.raises(ValueError):         # rows past 16 bits
        cuda_ops.band_offsets_launch(*m, **dict(geo, L=1 << 17))
    assert cuda_ops.LAUNCHES == before


def _member_inputs(c, dev, dtype=torch.int64):
    B, A = c["q"].shape
    C = c["end_idx"].shape[1]
    z = torch.zeros((B, C), dtype=torch.int64, device=dev)
    cands = tchain.Candidates(
        z, z, z, z, z.float(), z, z.float(),
        torch.from_numpy(c["valid"]).to(dev),
        torch.from_numpy(c["end_idx"]).to(dev),
        torch.from_numpy(c["parent"]).to(dev))
    anchors = tanchor.Anchors(
        *(torch.from_numpy(c[f]).to(dev).to(dtype) for f in ("q", "t", "l")),
        valid=torch.ones((B, A), dtype=torch.bool, device=dev),
        n_total=torch.full((B,), A, dtype=torch.int32, device=dev),
        nlogp=torch.zeros((B, A), device=dev))
    return cands, anchors


@pytest.mark.parametrize("dtype", [torch.int64, torch.int32],
                         ids=["int64", "int32"])
@pytest.mark.parametrize("name", list(MEMBER_CASES))
def test_members_kernel_matches_plain(cuda, name, dtype):
    """K7 against chain_members_plain on the same CUDA tensors, every
    output exactly, one launch per call, on anchors in the mapper's int64
    and in int32."""
    c = member_case(name)
    cands, anchors = _member_inputs(c, cuda, dtype)
    before = cuda_ops.LAUNCHES["chain_members"]
    k7 = tchain.chain_members(cands, anchors, max_chain=c["M"])
    torch.cuda.synchronize()
    assert cuda_ops.LAUNCHES["chain_members"] == before + 1
    plain = tchain.chain_members_plain(cands, anchors, max_chain=c["M"])
    for f, a, b in zip(("mq", "mt", "ml", "mvalid"), k7, plain):
        assert a.dtype == b.dtype and torch.equal(a, b), f


@pytest.mark.parametrize("name", list(MEMBER_PATH_CASES))
def test_members_path_follows_the_sizes(cuda, name):
    """K7's launch takes the (warps, stage) its sizes give (the seams of
    tests/torch_edge_cases.py: the lifting table in shared memory, the
    chase over the parents in shared or in global memory) and counts its
    path in MEMBER_PATHS."""
    c = member_case(name)
    cands, anchors = _member_inputs(c, cuda)
    A = c["q"].shape[1]
    C = c["end_idx"].shape[1]
    lib = cuda_ops._load(cuda)
    plan = MEMBER_PATH_CASES[name]
    assert cuda_ops.chain_members_plan(lib, C, A, c["M"]) == plan
    before = dict(cuda_ops.MEMBER_PATHS)
    tchain.chain_members(cands, anchors, max_chain=c["M"])
    torch.cuda.synchronize()
    path = cuda_ops.MEMBER_STAGES[plan[1]]
    assert cuda_ops.MEMBER_PATHS == dict(before, **{path: before[path] + 1})


def test_members_wrapper_checks_its_inputs(cuda):
    c = member_case("q-ties")
    cands, anchors = _member_inputs(c, cuda)
    args = (anchors.q, anchors.t, anchors.l, cands.parent, cands.end_idx)
    before = dict(cuda_ops.LAUNCHES)
    with pytest.raises(TypeError):          # int32 q beside int64 t and l
        cuda_ops.chain_members_launch(args[0].int(), *args[1:], max_chain=8)
    with pytest.raises(TypeError):          # int32 parents
        cuda_ops.chain_members_launch(*args[:3], args[3].int(), args[4],
                                      max_chain=8)
    with pytest.raises(ValueError):         # ends on the CPU
        cuda_ops.chain_members_launch(*args[:4], args[4].cpu(), max_chain=8)
    with pytest.raises(ValueError):         # ends of another row count
        cuda_ops.chain_members_launch(*args[:4], args[4][1:].contiguous(),
                                      max_chain=8)
    with pytest.raises(ValueError):
        cuda_ops.chain_members_launch(*args, max_chain=0)
    with pytest.raises(ValueError):         # members past shared memory
        cuda_ops.chain_members_launch(*args, max_chain=1 << 15)
    assert cuda_ops.LAUNCHES == before


def _pairs(rng, N, qlen, tlen, acc=0.85):
    """N reads of qlen (1 - 2 kb) bases drawn at ``acc`` from random
    targets of tlen bases (substitutions, insertions and deletions in
    equal parts), the target shifted by one base as sdpMatcher shifts
    it: (queries, qlens, targets, tlens) as sdp_align takes them."""
    Lq = -(-max(qlen) // 64) * 64
    Lt = -(-(tlen + 129) // 128) * 128
    qarr = np.full((N, Lq), 4, np.int8)
    tarr = np.full((N, Lt), 4, np.int8)
    ql = np.zeros(N, np.int32)
    for n in range(N):
        t = rng.integers(0, 4, tlen).astype(np.int8)
        pos = int(rng.integers(0, tlen - qlen[n] // 2))
        src = t[pos:]
        out = []
        for b in src:
            u = rng.random()
            if u < (1 - acc) / 3:
                continue                                 # deletion
            if u < 2 * (1 - acc) / 3:
                out.append(rng.integers(0, 4))           # insertion
            out.append((b + 1) % 4 if u > 1 - (1 - acc) / 3 else b)
            if len(out) >= qlen[n]:
                break
        q = np.asarray(out[:qlen[n]], np.int8)
        qarr[n, :len(q)] = q
        ql[n] = len(q)
        tarr[n, 1:1 + tlen] = t
    return qarr, ql, tarr, np.full(N, tlen + 1, np.int32)


@pytest.mark.parametrize("global_align", [True, False])
def test_sdp_align_card_matches_cpu(cuda, global_align):
    """sdp_align on the card (the fragment match in PyTorch, the chain on
    K3 and K7, one launch each) equals the same call on the CPU at
    Lq = 2048, Lt = 2304, every field."""
    rng = np.random.default_rng(64)
    args = _pairs(rng, 16, rng.integers(1000, 2000, 16), 2170)
    before = dict(cuda_ops.LAUNCHES)
    got = tsdp.sdp_align(*(torch.from_numpy(a).to(cuda) for a in args),
                         global_align=global_align)
    torch.cuda.synchronize()
    assert cuda_ops.LAUNCHES["chain_scan"] == before["chain_scan"] + 1
    assert cuda_ops.LAUNCHES["chain_members"] == before["chain_members"] + 1
    want = tsdp.sdp_align(*map(torch.from_numpy, args),
                          global_align=global_align)
    assert want.valid.all()
    for f, a, b in zip(tsdp.SDPResult._fields, got, want):
        assert a.dtype == b.dtype and torch.equal(a.cpu(), b), f


def test_sdp_matcher_card_matches_cpu(cuda, tmp_path, capsys):
    """The sdpMatcher CLI on the card prints what it prints on the CPU,
    and its card run launches K3, K7, K6, K1 and K2, never K1's other
    forms."""
    from blasr_tpu_torch.cli import sdp_matcher
    from blasr_tpu_torch.io.fasta import write_fasta
    rng = np.random.default_rng(65)
    q, ql, t, tl = _pairs(rng, 6, rng.integers(300, 700, 6), 900)
    write_fasta(tmp_path / "q.fa", [FastaRecord(f"q{i}", q[i, :ql[i]])
                                    for i in range(6)])
    write_fasta(tmp_path / "t.fa", [FastaRecord(f"t{i}", t[i, 1:tl[i]])
                                    for i in range(6)])
    argv = [str(tmp_path / "q.fa"), str(tmp_path / "t.fa"), "11",
            "-printSimilarity", "-showalign"]
    cuda_ops.reset_launch_counts()
    assert sdp_matcher.run(argv) == 0
    got = capsys.readouterr().out
    n = dict(cuda_ops.LAUNCHES)
    assert sdp_matcher.run(argv + ["--device", "cpu"]) == 0
    assert got == capsys.readouterr().out and got.count("\n") > 20
    for k in ("chain_scan", "chain_members", "band_offsets", "banded_dp",
              "banded_traceback"):
        assert n[k] == 1, (k, n)
    assert sum(v for k, v in n.items() if k.startswith("banded_dp")) == 1


# ------------------------------------------------------- map_batch as graphs

GRAPH_L = 1024
GRAPH_BATCH = 8
# tests/test_torch_mapper_modes.py's general matrix (K1's GEN forms)
GEN_MATRIX = [[-5 if i == j and i < 4 else 6 + (i + j) % 2
               for j in range(5)] for i in range(5)]
GRAPH_MODES = {
    "distance": dict(),
    "qv": dict(ignore_qualities=False),
    "affine": dict(affine_align=True),
    "gen": dict(score_matrix=GEN_MATRIX),
    "block": dict(),
    "dense": dict(),
}


@pytest.fixture(scope="module")
def graph_world():
    """A 200 kb genome of two contigs on the card and 48 reads of 300-900
    bases at 87% accuracy with base qualities 8-39 (the port's sim)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from blasr_tpu_torch.sim import random_genome, simulate_reads
    contigs = random_genome(200_000, seed=91, n_contigs=2)
    sims = simulate_reads(contigs, 48, read_len=(300, 900), accuracy=0.87,
                          seed=92)
    rng = np.random.default_rng(93)
    recs = [FastaRecord(f"r/{i}/0_{len(s.rec.seq)}", s.rec.seq,
                        rng.integers(8, 40, len(s.rec.seq)))
            for i, s in enumerate(sims)]
    gi = build_genome_index(contigs, k=12)
    return gi, tmr.DeviceIndex.from_host(gi, "cuda"), recs


def _graph_mapper(gi, ix, mode, **cfg_kw):
    from blasr_tpu_torch.params import ShapeConfig
    cfg = ShapeConfig(buckets=(512, GRAPH_L), batch_size=GRAPH_BATCH,
                      occ_block_sample=mode == "block", **cfg_kw)
    return tmr.Mapper(gi, MappingParams(**GRAPH_MODES[mode]).make_sane(),
                      cfg, device="cuda", dev=ix)


def _graph_batches(m, recs, L, n):
    """``n`` batches of ``m``'s batch size at bucket L on the card: (reads,
    lens, qv or None)."""
    out = []
    B = m.batch_size_for(L)
    for j in range(n):
        group = recs[j * B:(j + 1) * B]
        arr = np.full((B, L), 4, np.int8)
        lens = np.zeros(B, np.int32)
        for i, r in enumerate(group):
            arr[i, :min(len(r.seq), L)] = r.seq[:L]
            lens[i] = min(len(r.seq), L)
        qv = None
        if m.use_qv:
            qv = tuple(torch.from_numpy(q).cuda()
                       for q in m.pack_qv_rows(group, B, L))
        out.append((torch.from_numpy(arr).cuda(),
                    torch.from_numpy(lens).cuda(), qv))
    return out


def _dispatch(m, L, batch, tb_cap=0):
    from blasr_tpu_torch.pipeline import graphs
    pos, kw = m._batch_call_args(L, tb_cap)
    reads, lens, qv = batch
    return tmr.start_fetch(graphs.dispatch(m.dev, reads, lens, pos, kw, qv,
                                           m.qv_rescore))


def _eager_flats(m, L, batches, tb_cap=0):
    from blasr_tpu_torch.pipeline import graphs
    with graphs.eager_dispatch():
        res = [_dispatch(m, L, b, tb_cap) for b in batches]
    torch.cuda.synchronize()
    return [r.host.clone() for r in res]


@pytest.mark.parametrize("mode", list(GRAPH_MODES))
def test_graph_replay_equals_eager(graph_world, mode):
    """Five batches through one graph, four of them in flight at once
    (each replay's flat copied to the host behind it, none waited for
    before the last is dispatched): every packed buffer equals eager
    dispatch's byte for byte, in the distance, QV, affine, general-matrix
    and block modes and at the dense rerun's tb_cap = T."""
    from blasr_tpu_torch.pipeline import graphs
    gi, ix, recs = graph_world
    m = _graph_mapper(gi, ix, mode)
    L = 512 if mode != "dense" else GRAPH_L
    tb_cap = L + m.cfg.window_len(L) if mode == "dense" else 0
    batches = _graph_batches(m, recs, L, 5)
    want = _eager_flats(m, L, batches, tb_cap)
    graphs.reset_counts()
    first = _dispatch(m, L, batches[0], tb_cap)        # captures the key
    assert graphs.DISPATCHES["captures"] == 1
    got = [first] + [_dispatch(m, L, b, tb_cap) for b in batches[1:]]
    assert graphs.DISPATCHES["captures"] == 1
    for j, (g, w) in enumerate(zip(got, want)):
        g.ready.synchronize()
        assert torch.equal(g.host, w), (mode, j)
        assert int(w[-1]) == 0
    assert not torch.equal(want[0], want[1])          # the inputs differ


def test_graph_keys_interleaved_share_one_pool(graph_world):
    """Two keys of one index (the first pass and the dense rerun) replayed
    in turns on batches that change every turn: each equals eager; both
    graphs live in the index's one pool."""
    from blasr_tpu_torch.pipeline import graphs
    gi, ix, recs = graph_world
    m = _graph_mapper(gi, ix, "distance")
    L = GRAPH_L
    T = L + m.cfg.window_len(L)
    batches = _graph_batches(m, recs, L, 4)
    want = {0: _eager_flats(m, L, batches), T: _eager_flats(m, L, batches, T)}
    got = []
    for j, b in enumerate(batches):
        for cap in (0, T):
            got.append((cap, j, _dispatch(m, L, b, cap)))
    for cap, j, g in got:
        g.ready.synchronize()
        assert torch.equal(g.host, want[cap][j]), (cap, j)
    cache = graphs.cache_for(ix)
    keys = [graphs.graph_key(ix, m.batch_size_for(L), *m._batch_call_args(
        L, cap)) for cap in (0, T)]
    assert all(k in cache.graphs for k in keys) and cache.pool is not None


def test_graph_capture_and_replay_never_sync(graph_world, monkeypatch):
    """map_batch's warm-up pass and its capture run under
    set_sync_debug_mode("error"), and so do the replays: neither waits on
    the card."""
    from blasr_tpu_torch.pipeline import graphs
    gi, ix, recs = graph_world
    m = _graph_mapper(gi, ix, "qv", n_candidates=9)      # a key of its own
    inner = graphs._map_batch

    def strict(*a, **kw):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return inner(*a, **kw)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    monkeypatch.setattr(graphs, "_map_batch", strict)
    batches = _graph_batches(m, recs, 512, 3)
    before = graphs.DISPATCHES["captures"]
    res = [_dispatch(m, 512, batches[0])]
    assert graphs.DISPATCHES["captures"] == before + 1
    torch.cuda.set_sync_debug_mode("error")
    try:
        res += [_dispatch(m, 512, b) for b in batches[1:]]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    monkeypatch.undo()
    want = _eager_flats(m, 512, batches)
    for g, w in zip(res, want):
        g.ready.synchronize()
        assert torch.equal(g.host, w)


def test_graph_pass_launches_equal_eager(graph_world):
    """Mapper.map_reads through graphs (after a pass that captured them)
    gives the eager pass's alignments and counters, and its
    cuda_ops.LAUNCHES equal the eager pass's, kernel for kernel."""
    import contextlib
    from blasr_tpu_torch.pipeline import graphs
    gi, ix, recs = graph_world
    m = _graph_mapper(gi, ix, "distance")
    m.map_reads(recs)
    runs = []
    for eager in (True, False):
        cuda_ops.reset_launch_counts()
        graphs.reset_counts()
        with (graphs.eager_dispatch() if eager
              else contextlib.nullcontext()):
            per_read = m.map_reads(recs)
        runs.append((dict(cuda_ops.LAUNCHES), dict(graphs.DISPATCHES),
                     [[(a.strand, a.tstart, a.tend, a.qstart, a.qend,
                        list(a.cigar), a.score, a.map_qv) for a in alns]
                      for alns in per_read]))
    assert runs[0][2] == runs[1][2]
    assert runs[0][0] == runs[1][0] and runs[0][0]["chain_members"] > 0
    eager, graph = runs[0][1], runs[1][1]
    passes = ("batches", "dense_reruns")
    assert [eager[k] for k in passes] == [graph[k] for k in passes]
    assert eager["replays"] == 0 and eager["captures"] == 0
    assert graph["captures"] == 0
    assert graph["replays"] == graph["batches"] + graph["dense_reruns"] > 0


# the stages map_batch splits into parts (StageTimer's "<stage>.<part>")
SPLIT_STAGES = ("guide_sdp", "traceback")


def _parts_sum_to_stages(totals, passes):
    """Each split stage equals the sum of its parts (the stage's mark ends
    its last part: one event), up to the events' rounding."""
    for stage in SPLIT_STAGES:
        parts = [k for k in totals if k.startswith(stage + ".")]
        assert len(parts) >= 3, (stage, sorted(totals))
        got = sum(totals[k] for k in parts)
        assert abs(got - totals[stage]) <= 1e-4 * totals[stage] \
            + 0.002 * passes, (stage, got, totals[stage])


def test_graph_replay_with_sub_marks_equals_eager(graph_world):
    """Under StageTimer, eager dispatch and graph replays (every stage and
    part mark an event node of the graph) give the same packed buffers
    byte for byte, and in both each split stage is the sum of its
    parts."""
    from blasr_tpu_torch.pipeline import graphs
    gi, ix, recs = graph_world
    m = _graph_mapper(gi, ix, "distance")
    L = 512
    batches = _graph_batches(m, recs, L, 4)
    with tmr.StageTimer() as st_eager:
        want = _eager_flats(m, L, batches)
    eager = st_eager.totals()
    _dispatch(m, L, batches[0]).ready.synchronize()    # the capture
    with tmr.StageTimer() as st:
        got = [_dispatch(m, L, b) for b in batches]
    replay = st.totals()
    for j, (g, w) in enumerate(zip(got, want)):
        g.ready.synchronize()
        assert torch.equal(g.host, w), j
    assert graphs.cache_for(ix).graphs
    for totals in (eager, replay):
        _parts_sum_to_stages(totals, len(batches))
        assert "guide_sdp.sdp" in totals and totals["traceback.k2"] > 0


def test_dp_rows_used_equals_a_host_recount(graph_world):
    """The rows-used word of an eager pass's flat is the sum of qb - qa
    over its valid DP items, recounted on the host from the unpacked
    columns (a candidate without a DP row has qa = qb = 0 there); the
    replay's word is the same, and stored is n_dp x L."""
    gi, ix, recs = graph_world
    m = _graph_mapper(gi, ix, "distance")
    L = 512
    batches = _graph_batches(m, recs, L, 3)
    flats = _eager_flats(m, L, batches)
    pos, kw = m._batch_call_args(L)
    B = m.batch_size_for(L)
    c_dp = kw["C_dp"] or kw["C"]
    for b, flat in zip(batches, flats):
        pb = tmr.start_fetch(tmr.map_batch(m.dev, b[0], b[1], *pos, **kw))
        res = tmr.unpack_batch(pb)
        recount = int(((res.q_end - res.q_start)
                       * res.chain_valid).sum())
        assert int(flat[-2]) == int(pb.host[-2]) == recount > 0
        assert pb.dp_rows == 2 * B * c_dp * L
        assert recount <= pb.dp_rows


def test_waited_never_exceeds_the_passes(graph_world):
    """graphs.DISPATCHES["waited"] counts collections whose copy was not
    done: at most one a pass, through graphs, eagerly and under a
    StageTimer (whose replays wait for their marks, so only the copies
    queued behind the last replays can be waited for)."""
    import contextlib
    from blasr_tpu_torch.pipeline import graphs
    gi, ix, recs = graph_world
    m = _graph_mapper(gi, ix, "distance")
    m.map_reads(recs)
    for ctx in (contextlib.nullcontext, graphs.eager_dispatch,
                tmr.StageTimer):
        graphs.reset_counts()
        with ctx():
            m.map_reads(recs)
        d = dict(graphs.DISPATCHES)
        assert 0 <= d["waited"] <= d["batches"] + d["dense_reruns"], d


def test_graph_pool_freed_with_its_index(graph_world):
    """An index's graphs and their pool go when the index goes: the
    memory the captures reserved is released."""
    import gc
    from blasr_tpu_torch.pipeline import graphs
    gi, _, recs = graph_world
    ix = tmr.DeviceIndex.from_host(gi, "cuda")
    m = _graph_mapper(gi, ix, "distance")
    graphs.reset_counts()
    m.warmup([512])
    assert graphs.DISPATCHES["captures"] == 1
    pool = graphs.CAPTURES[-1]["pool_bytes"]
    assert pool > 0
    key = id(ix.genome)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_reserved()
    del m, ix
    gc.collect()
    assert key not in graphs._CACHES
    torch.cuda.empty_cache()
    assert torch.cuda.memory_reserved() <= held - pool


# ---------------------------------------- multi-device mapping (dist/mesh)

def _mesh_world():
    """tests/test_dist.py's world through the port's copies: a 50 kb genome
    (seed 21, k = 12), eight simulated reads of 150-226 bp in L = 256; the
    matrix and map_batch's keywords of that test, with the Mapper's
    short-tuple SDP pass (k_sdp = 11), so every kernel runs."""
    from blasr_tpu_torch.params import ShapeConfig
    from blasr_tpu_torch.sim import random_genome, simulate_reads
    L = 256
    contigs = random_genome(50_000, seed=21)
    gi = build_genome_index(contigs, k=12)
    sims = simulate_reads(contigs, 8, read_len=(150, L - 30), accuracy=0.9,
                          seed=22)
    reads = np.full((8, L), 4, dtype=np.int8)
    lens = np.zeros(8, dtype=np.int32)
    for i, s in enumerate(sims):
        n = min(len(s.rec.seq), L)
        reads[i, :n] = s.rec.seq[:n]
        lens[i] = n
    submat = np.asarray(MappingParams().make_sane().score_matrix,
                        np.float32).reshape(25)
    W = ShapeConfig(buckets=(L,), band_width=128).window_len(L)
    static = dict(cfg_k=12, L=L, W=W, w_b=128, C=4, A=64, O=4, E=36,
                  T=L + W, max_chain=64, min_match=12,
                  max_anchors_per_pos=1000, max_lcp=0, indel_rate=0.3,
                  k_sdp=11)
    return gi, reads, lens, submat, static


def test_mesh_ranks_on_card_equal_cpu(cuda, tmp_path):
    """map_batch_ref_sharded on a (1, 2) mesh and map_batch_data_parallel
    on a (2, 1) mesh, two gloo ranks on this card, each shard's map_batch
    launching K1-K7, equal the same ranks on the CPU array for array; the
    data-parallel output is one map_batch over the whole batch on the
    card."""
    from torch_dist_rank import finish_ranks, start_ranks
    gi, reads, lens, submat, static = _mesh_world()
    inp = str(tmp_path / "world.npz")
    np.savez(inp, reads=reads, lens=lens, submat=submat,
             gaps=np.asarray([4, 4, 5, 5], np.float32))
    cases = [dict(name=f"{kind}-{dev}", kind=kind, n_data=nd, n_ref=nr,
                  device=dev, glen=50_000, gseed=21, inputs=inp,
                  static=static)
             for kind, nd, nr in (("ref", 1, 2), ("data", 2, 1))
             for dev in ("cuda", "cpu")]
    out = finish_ranks(start_ranks(tmp_path, cases))
    kernels = ("banded_dp", "banded_traceback", "chain_scan", "sdp_window",
               "anchor_search", "band_offsets", "chain_members")
    for kind in ("ref", "data"):
        for card, host in zip(out[f"{kind}-cuda"], out[f"{kind}-cpu"]):
            for f in ("ints", "ops", "clusters", "flat"):
                np.testing.assert_array_equal(card[f], host[f], err_msg=f)
            launched = json.loads(str(card["launches"]))
            assert all(launched[k] > 0 for k in kernels), launched
            assert not any(json.loads(str(host["launches"])).values())
    whole = tmr.map_batch(
        tmr.DeviceIndex.from_host(gi, "cuda"),
        torch.from_numpy(reads).cuda(), torch.from_numpy(lens).cuda(),
        submat, [4.0, 4.0, 5.0, 5.0, 0.0, 0.0], use_pallas=True, **static)
    for card in out["data-cuda"]:
        for f in ("ints", "ops", "clusters", "flat"):
            np.testing.assert_array_equal(
                card[f], getattr(whole, f).cpu().numpy(), err_msg=f)


def test_shard_lut_forms_map_the_same_on_card(cuda):
    """The port's shard index derives bucket_pairs from bucket_starts (the
    JAX shard index has none): K5 reads either LUT, and map_batch on a
    shard gives one batch with either, on the card and on the CPU."""
    from blasr_tpu_torch.dist import mesh
    gi, reads, lens, submat, static = _mesh_world()
    shards = mesh.shard_index(gi, 2, fast_path=True)
    g6 = [4.0, 4.0, 5.0, 5.0, 0.0, 0.0]
    flats = []
    for dev in ("cuda", "cpu"):
        idx = mesh.shard_device_index(gi, shards, 0, dev)
        for ix in (idx, idx._replace(bucket_pairs=None)):
            flats.append(tmr.map_batch(
                ix, torch.from_numpy(reads).to(dev),
                torch.from_numpy(lens).to(dev), submat, g6,
                use_pallas=True, **static).flat.cpu())
    for f in flats[1:]:
        assert torch.equal(f, flats[0])


def test_merge_on_card_equals_cpu(cuda):
    """merge_ref_shards (plain torch: the JAX merge is XLA outside any
    Pallas kernel) gives one batch on CUDA tensors and on the CPU, on
    random shard outputs with tied scores, invalid rows, a fault, the
    shards' DP rows used and their seed counts."""
    from blasr_tpu_torch.dist.mesh import merge_ref_shards
    rng = np.random.default_rng(3)
    R, n2, C, n_dp, half, c_stat = 3, 8, 4, 16, 24, 16
    ints = rng.integers(0, 4, (R, n2, C, tmr.N_COLS)).astype(np.int32)
    ints[..., tmr.COL_VALID] = rng.integers(0, 2, (R, n2, C))
    ints[..., tmr.COL_DPSLOT] = rng.integers(-1, n_dp, (R, n2, C))
    ops = rng.integers(0, 1 << 20, (R, n_dp, half)).astype(np.int32)
    cl = rng.integers(0, 3, (R, n2, c_stat, 2)).astype(np.int32)
    faults = np.asarray([0, 0, 1], np.int32)
    used = rng.integers(0, 1 << 16, R).astype(np.int32)
    seeds = rng.integers(0, 1 << 40, (R, len(tmr.SEED_COUNTERS)))
    words = seeds.astype(np.int64).view(np.int32)
    outs = [merge_ref_shards(*(torch.from_numpy(a).to(dev)
                               for a in (ints, ops, cl, faults, used, words)))
            for dev in ("cuda", "cpu")]
    for f in ("ints", "ops", "clusters", "flat"):
        assert torch.equal(getattr(outs[0], f).cpu(), getattr(outs[1], f))
    assert int(outs[1].flat[-1]) == 1
    assert int(outs[1].flat[-2]) == int(used.sum())
    tail = outs[1].flat[-tmr.TAIL_WORDS:-2].numpy().view(np.int64)
    np.testing.assert_array_equal(tail, seeds.sum(axis=0))


# ------------------------------------------------ band widths other than 128

WIDE_MODES = ("distance", "qv", "hp", "gen", "hp-gen", "qv-gen")


def _wide_mode(cuda, w_b, mode, **case):
    """(K1-W in ``mode`` on tests/torch_edge_cases.py::wide_case(w_b,
    **case), the plain DP, the inputs), after asserting one launch of the
    mode's own count and none of any other DP's."""
    arrs = wide_case(w_b, **case)
    N, L = arrs[0].shape
    args = [torch.from_numpy(a).to(cuda) for a in arrs]
    if mode in ("distance", "qv"):
        submat, gaps, kw = _submat(), (4.0, 4.0, 5.0, 5.0), {}
    else:
        submat, gaps, kw = k1_mode_kwargs(mode)
    use_qv = mode == "qv" or K1_MODES.get(mode, (0, 0, 0, False))[3]
    if use_qv:
        q1, q2 = qv_words(np.random.default_rng(BANDED_QV_SEED), N, L)
        kw = dict(kw, qv1=torch.from_numpy(q1).to(cuda),
                  qv2=torch.from_numpy(q2).to(cuda))
    before = dict(cuda_ops.LAUNCHES)
    k1 = tpb.banded_align_cuda(*args, submat, *gaps, w_b=w_b, **kw)
    torch.cuda.synchronize()
    after = dict(cuda_ops.LAUNCHES)
    key = cuda_ops.dp_launch_key(use_qv, "use_hp" in kw,
                                 not tpb.two_valued(submat), w_b)
    assert key.startswith("banded_dp_w")
    assert {k: after[k] - before[k] for k in after
            if k.startswith("banded_dp")} == {
        k: int(k == key) for k in after if k.startswith("banded_dp")}
    return k1, tb.banded_align(*args, submat, *gaps, w_b=w_b, **kw), args


@pytest.mark.parametrize("mode", WIDE_MODES)
@pytest.mark.parametrize("w_b", WIDE_WIDTHS)
def test_wide_dp_kernel_matches_plain(cuda, w_b, mode):
    """K1-W in each of its six modes against the plain DP at band widths
    48, 64 and 256 on the tile-edge shapes, the homopolymer world and
    offsets beyond K1's slope limit, every output exactly."""
    k1, p1, args = _wide_mode(cuda, w_b, mode)
    assert k1.tbbits.shape == (args[0].shape[0], args[0].shape[1], w_b)
    assert p1.valid[:4].all()
    for f, a, b in zip(k1._fields, k1, p1):
        assert a.dtype == b.dtype and torch.equal(a, b), f


def _same_wide_walk(res, rest, t_max, w_b):
    """K2-W against the plain walk, every output exactly, one launch; the
    pair buffer is handed out dirty first.  Then K2-W through an index of
    the rows (:func:`_same_indexed_walk`)."""
    N = res.tbbits.shape[0]
    P = tb.pair_capacity(t_max)
    torch.full((N, P // 2), -1, dtype=torch.int32, device=res.tbbits.device)
    before = dict(cuda_ops.LAUNCHES)
    k2 = tb.banded_traceback(res, *rest, t_max=t_max, w_b=w_b)
    torch.cuda.synchronize()
    assert cuda_ops.LAUNCHES["banded_traceback_w"] == \
        before["banded_traceback_w"] + 1
    assert cuda_ops.LAUNCHES["banded_traceback"] == before["banded_traceback"]
    p2 = tb.banded_traceback_plain(res, *rest, t_max=t_max, w_b=w_b)
    for name, a, b in zip(k2._fields, k2, p2):
        assert a.dtype == b.dtype and torch.equal(a, b), (name, t_max)
    _same_indexed_walk(res, rest, t_max, k2, w_b)
    return k2


@pytest.mark.parametrize("frac", ["3T/8", "T"])
@pytest.mark.parametrize("w_b", WIDE_WIDTHS)
def test_wide_traceback_kernel_matches_plain(cuda, w_b, frac):
    """K2-W over K1-W's cell words of all six modes at a width, in one
    batch, at t_max = 3T/8 and T."""
    res, args = [], None
    for mode in WIDE_MODES:
        k1, _, args = _wide_mode(cuda, w_b, mode)
        res.append(k1)
    res = tb.BandedResult(*(torch.cat(x) for x in zip(*res)))
    rest = [torch.cat([a] * len(WIDE_MODES)) for a in args[2:]]
    L, W = args[0].shape[1], args[1].shape[1]
    t_max = (3 * (L + W)) // 8 if frac == "3T/8" else L + W
    k2 = _same_wide_walk(res, rest, t_max, w_b)
    if frac == "T":
        assert not k2.overflow.any()


@pytest.mark.parametrize("w_b", [1100, 4000] + list(RING_WIDTHS))
def test_wide_dp_kernel_large_widths(cuda, w_b):
    """K1-W above 1024 band cells (two and four cells a thread), with its
    workspace in shared memory (1100) and in a global scratch (4000 and
    K2-W's ring edge, 3615 and 3616), in distance and QV mode; K2-W on its
    words: a ring of three 8-row tiles (1100), of two at its largest width
    (3615), and one cell past it (3616) and at 4000 the walk from global
    memory."""
    N, L = 6, 256
    W = L + 3 * w_b
    args = [t.to(cuda) for t in _case(np.random.default_rng(w_b), N, L, W,
                                      steep=(1,), w_b=w_b)]
    q1, q2 = qv_words(np.random.default_rng(BANDED_QV_SEED), N, L)
    sm = _submat()
    for kw in ({}, dict(qv1=torch.from_numpy(q1).to(cuda),
                        qv2=torch.from_numpy(q2).to(cuda))):
        k1 = tpb.banded_align_cuda(*args, sm, 4.0, 4.0, 5.0, 5.0, w_b=w_b,
                                   **kw)
        p1 = tb.banded_align(*args, sm, 4.0, 4.0, 5.0, 5.0, w_b=w_b, **kw)
        assert p1.valid.sum() >= N - 1
        for f, a, b in zip(k1._fields, k1, p1):
            assert a.dtype == b.dtype and torch.equal(a, b), (f, kw.keys())
        _same_wide_walk(k1, args[2:], L + W, w_b)


@pytest.mark.parametrize("mode", WIDE_MODES)
@pytest.mark.parametrize("w_b", LANE_WIDTHS + GROUP_WIDTHS)
def test_wide_dp_kernel_lane_widths(cuda, w_b, mode):
    """K1-W on each side of its lane counts (31 | 32 | 33 and 255 | 256 |
    257: the one-warp design at 1, 1, 2, 8 and 8 cells a lane, then the
    first design) and at 512 and 513, in each of its six modes, on
    wide_case's inputs with the lane_shifts items (shifts by one lane and
    a cell, by several lanes, back by 1, 2, 5 and w_b + 1, by w_b and w_b +
    1, and back past the row's start), every output exactly."""
    k1, p1, args = _wide_mode(cuda, w_b, mode, shifts=True)
    assert k1.tbbits.shape == (args[0].shape[0], args[0].shape[1], w_b)
    for f, a, b in zip(k1._fields, k1, p1):
        assert a.dtype == b.dtype and torch.equal(a, b), f


@pytest.mark.parametrize("w_b", LANE_WIDTHS + GROUP_WIDTHS)
def test_wide_traceback_kernel_lane_widths(cuda, w_b):
    """K2-W over K1-W's cell words of all six modes at the lane and group
    widths (K2-W's 16-row ring up to 140 cells, its 8-row ring above), in
    one batch, at t_max = 3T/8 and T."""
    res, args = [], None
    for mode in WIDE_MODES:
        k1, _, args = _wide_mode(cuda, w_b, mode, shifts=True)
        res.append(k1)
    res = tb.BandedResult(*(torch.cat(x) for x in zip(*res)))
    rest = [torch.cat([a] * len(WIDE_MODES)) for a in args[2:]]
    L, W = args[0].shape[1], args[1].shape[1]
    for t_max in ((3 * (L + W)) // 8, L + W):
        _same_wide_walk(res, rest, t_max, w_b)


@pytest.mark.parametrize("w_b", [31, 33, 47, 255, 257])
def test_wide_kernels_odd_rows(cuda, w_b):
    """K1-W and K2-W at an odd width on ODD_ROWS = 201 rows: the last
    16-row tile is partial and most tiles start off a 16-byte boundary
    ((n * L + r0) * w_b * 4), so K1-W's staging slots are skewed and the
    words around each bulk store's aligned interior leave by plain
    stores, and K2-W copies the words around each tile's aligned interior
    itself; distance and QV mode, every output exactly."""
    for mode in ("distance", "qv"):
        k1, p1, args = _wide_mode(cuda, w_b, mode, shifts=True,
                                  rows=ODD_ROWS)
        assert k1.tbbits.shape[1] == ODD_ROWS
        for f, a, b in zip(k1._fields, k1, p1):
            assert a.dtype == b.dtype and torch.equal(a, b), (f, mode)
        L, W = args[0].shape[1], args[1].shape[1]
        _same_wide_walk(k1, args[2:], L + W, w_b)


def test_wide_traceback_kernel_unaligned_words(cuda):
    """K2-W at band 64 on cell words whose storage starts one word past a
    16-byte boundary (a view into a larger buffer): every tile's copy has
    edge words, which the walking lane copies itself."""
    k1, _, args = _wide_mode(cuda, 64, "distance")
    buf = torch.empty(k1.tbbits.numel() + 1, dtype=torch.int32,
                      device=k1.tbbits.device)
    view = buf[1:].view(k1.tbbits.shape)
    view.copy_(k1.tbbits)
    assert view.data_ptr() % 16 == 4
    res = k1._replace(tbbits=view)
    L, W = args[0].shape[1], args[1].shape[1]
    _same_wide_walk(res, args[2:], L + W, 64)


def test_wide_traceback_ring_plans(cuda):
    """K2-W's ring by width (csrc/banded_traceback_wide.cu::ring_plan, as
    rows << 8 | slots): five 16-row tiles at 48 and 64, five 8-row tiles at
    256, three at 1100, two at the largest ring width, none (the walk from
    global memory) one cell past it."""
    lib = cuda_ops._load(torch.device(cuda))
    plan = {w: lib.blasr_banded_traceback_wide_plan(w)
            for w in (48, 64, 256, 1100) + RING_WIDTHS}
    assert plan == {48: 16 << 8 | 5, 64: 16 << 8 | 5, 256: 8 << 8 | 5,
                    1100: 8 << 8 | 3, RING_WIDTHS[0]: 8 << 8 | 2,
                    RING_WIDTHS[1]: 0}


def test_wide_wrappers_check_their_inputs(cuda):
    args = [t.to(cuda) for t in _case(np.random.default_rng(3), 4, 128,
                                      384, w_b=64)]
    kw = dict(match=-5.0, mismatch=6.0, ins_open=4.0, ins_ext=4.0,
              del_open=5.0, del_ext=5.0)
    with pytest.raises(ValueError):
        cuda_ops.banded_dp_launch(*args, **kw, w_b=0)
    res = cuda_ops.banded_dp_launch(*args, **kw, w_b=64)
    with pytest.raises(ValueError):       # tbbits of another width
        cuda_ops.banded_traceback_cuda(res, *args[2:], t_max=512, w_b=96)
    rows = torch.arange(4, device=cuda)
    for bad, err in ((rows.to(torch.int32), TypeError),
                     (rows.cpu(), ValueError),
                     (rows.reshape(2, 2), ValueError),
                     (torch.arange(8, device=cuda)[::2], ValueError)):
        with pytest.raises(err):          # rows not int64, 1-D, contiguous
            cuda_ops.banded_traceback_cuda(res, *args[2:], t_max=512,
                                           w_b=64, rows=bad)


@pytest.mark.parametrize("w_b", [64, 256])
@pytest.mark.parametrize("name", SDP_CASES)
def test_sdp_kernel_matches_plain_at_width(cuda, name, w_b):
    """K4 against window_fragment_diags_banded_plain at band widths 64 and
    256 (the guide offsets centred for that width), one launch a call."""
    reads, rlen, windows, wlens, offs, occ, k = sdp_case(name, w_b)
    rk, rv = tanchor.read_kmer_keys(torch.from_numpy(reads).to(cuda),
                                    torch.from_numpy(rlen).to(cuda), k)
    args = (rk, rv, torch.from_numpy(windows).to(cuda),
            torch.from_numpy(wlens).to(cuda), torch.from_numpy(offs).to(cuda))
    before = cuda_ops.LAUNCHES["sdp_window"]
    k4 = tsdp.window_fragment_diags_banded(*args, k=k, occ=occ, w_b=w_b)
    torch.cuda.synchronize()
    assert cuda_ops.LAUNCHES["sdp_window"] == before + 1
    plain = tsdp.window_fragment_diags_banded_plain(*args, k=k, occ=occ,
                                                    w_b=w_b)
    for a, b in zip(k4, plain):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("w_b", [64, 256])
@pytest.mark.parametrize("name", BAND_CASES)
def test_band_kernel_matches_plain_at_width(cuda, name, w_b):
    """K6 against _band_offsets_plain at band widths 64 and 256, one
    launch a call."""
    c = band_case(name, w_b)

    def t(x):
        return None if x is None else torch.from_numpy(x).to(cuda)

    args = (t(c["mq"]), t(c["mt"]), t(c["ws"]), c["L"], c["W"], w_b,
            t(c["frag_diag"]), t(c["frag_valid"]), c["between_only"])
    before = cuda_ops.LAUNCHES["band_offsets"]
    k6 = tmr._band_offsets(*args)
    torch.cuda.synchronize()
    assert cuda_ops.LAUNCHES["band_offsets"] == before + 1
    plain = tmr._band_offsets_plain(*args)
    assert k6.dtype == plain.dtype and torch.equal(k6, plain)


def _mapped_fields(per_read):
    return [[(a.strand, a.tindex, a.tstart, a.tend, a.qstart, a.qend,
              list(a.cigar), a.score, a.n_match, a.n_mismatch, a.n_ins,
              a.n_del, a.map_qv, a.band_width) for a in alns]
            for alns in per_read]


@pytest.mark.parametrize("w_b", [64, 256])
def test_mapper_band_width_on_card_equals_cpu(graph_world, w_b):
    """A Mapper at band 64 or 256 on the card (it once refused every width
    but 128 on CUDA) maps 16 reads of the graph world through K1-W and
    K2-W, never K1 or K2, each batch a graph replay after its capture,
    to the same alignments as the Mapper on the CPU."""
    from blasr_tpu_torch.params import ShapeConfig
    from blasr_tpu_torch.pipeline import graphs
    gi, ix, recs = graph_world
    cfg = ShapeConfig(buckets=(512, GRAPH_L), batch_size=GRAPH_BATCH,
                      band_width=w_b)
    p = MappingParams().make_sane()
    m = tmr.Mapper(gi, p, cfg, device="cuda", dev=ix)
    assert not m.use_pallas
    cuda_ops.reset_launch_counts()
    graphs.reset_counts()
    got = m.map_reads(recs[:16])
    torch.cuda.synchronize()
    launches = dict(cuda_ops.LAUNCHES)
    assert launches["banded_dp_w"] > 0 and launches["banded_traceback_w"] > 0
    assert launches["banded_dp"] == 0 and launches["banded_traceback"] == 0
    assert graphs.DISPATCHES["replays"] > 0
    want = tmr.Mapper(gi, p, cfg, device="cpu").map_reads(recs[:16])
    assert sum(len(a) for a in want) >= 12
    assert _mapped_fields(got) == _mapped_fields(want)

"""Edge inputs of the anchor search, the chain scan, the chain members,
the band offsets and the SDP window pass, built with numpy from a seed.
``tests/test_torch_chain_sdp_edges.py`` and
``tests/test_torch_anchor_band_edges.py`` hold the plain PyTorch versions
to the JAX package on them; ``tests/test_torch_cuda.py`` holds the CUDA
kernels K3-K7 to the plain versions on the same inputs (it runs where JAX
is absent, so this module imports numpy only).
"""

import numpy as np

K_SDP = 11


def chain_rows(rng, B, A, n_valid, read_len=(400, 1800), tie_every=0):
    """Anchors as ``find_anchors`` leaves them: per row, ``n_valid[b]``
    valid anchors sorted by genome position, then invalid slots holding
    stale positions.  Most valid anchors lie on one drifting diagonal (a
    read's true placement), the rest are spurious hits nearby or far
    away.  With ``tie_every`` > 0 every such anchor is repeated on the
    next diagonal up (t + 1, same q and length): both copies carry equal
    chain weights, so the scan's and the selection's argmaxes tie
    exactly."""
    q = np.zeros((B, A), np.int64)
    t = np.zeros((B, A), np.int64)
    l = np.zeros((B, A), np.int64)
    valid = np.zeros((B, A), bool)
    nlogp = rng.uniform(3.0, 30.0, (B, A)).astype(np.float32)
    rlen = rng.integers(read_len[0], read_len[1], B).astype(np.int32)
    for b in range(B):
        n = int(n_valid[b])
        d0 = int(rng.integers(10_000, 4_000_000))
        qs, ts, ls = [], [], []
        drift = 0
        while len(qs) < n:
            if tie_every and len(qs) % tie_every == 0 and len(qs) + 2 <= n:
                qq = int(rng.integers(0, rlen[b] - 20))
                ll = int(rng.integers(12, 24))
                qs += [qq, qq]
                ts += [d0 + qq, d0 + qq + 1]
                ls += [ll, ll]
                continue
            u = rng.random()
            qq = int(rng.integers(0, max(rlen[b] - 12, 1)))
            if u < 0.7:
                drift += int(rng.integers(-3, 4))
                tt = d0 + qq + drift
            elif u < 0.9:
                tt = d0 + qq + int(rng.integers(-3000, 3000))
            else:
                tt = int(rng.integers(0, 4_600_000))
            qs.append(qq)
            ts.append(tt)
            ls.append(int(rng.integers(12, 33)))
        order = np.argsort(np.asarray(ts[:n]), kind="stable")
        q[b, :n] = np.asarray(qs[:n])[order]
        t[b, :n] = np.asarray(ts[:n])[order]
        l[b, :n] = np.asarray(ls[:n])[order]
        valid[b, :n] = True
        m = A - n                      # stale slots: positions, no flag
        q[b, n:] = rng.integers(0, rlen[b], m)
        t[b, n:] = rng.integers(0, 4_600_000, m)
        l[b, n:] = rng.integers(12, 33, m)
    return dict(q=q, t=t, l=l, valid=valid, nlogp=nlogp, read_len=rlen)


# name -> (B, A, valid counts per row or None for ~70% of A, tie_every,
#          chain_anchors keyword arguments)
CHAIN_CASES = {
    "ties": (4, 128, None, 1,
             dict(n_cand=8, rank_by_pvalue=False)),
    "ties-pvt0": (4, 128, None, 3,
                  dict(n_cand=8, rank_by_pvalue=True, p_value_type=0)),
    "A100-pvt1": (4, 100, None, 0,
                  dict(n_cand=10, rank_by_pvalue=True, p_value_type=1)),
    "A1024": (2, 1024, (1024, 700), 0,
              dict(n_cand=20, rank_by_pvalue=True, p_value_type=0)),
    "lookback32-pvt2": (4, 256, None, 5,
                        dict(n_cand=10, rank_by_pvalue=True, p_value_type=2,
                             lookback=32)),
    "empty-and-single-rows": (4, 64, (0, 1, 0, 40), 0,
                              dict(n_cand=6, rank_by_pvalue=True,
                                   p_value_type=0)),
    "global": (4, 256, None, 4,
               dict(n_cand=10, rank_by_pvalue=True, p_value_type=0,
                    global_chain=True)),
    "guide-drift": (4, 512, None, 6,
                    dict(n_cand=1, rank_by_pvalue=True, p_value_type=0,
                         drift_penalty=1.0)),
    # rows around K3's 32-anchor scan blocks: one block short, one block,
    # one anchor past it, two blocks and one
    "A31": (3, 31, (31, 20, 2), 0,
            dict(n_cand=6, rank_by_pvalue=True, p_value_type=0)),
    "A32": (3, 32, (32, 25, 1), 2, dict(n_cand=6, rank_by_pvalue=False)),
    "A33": (3, 33, (33, 33, 17), 0,
            dict(n_cand=6, rank_by_pvalue=True, p_value_type=2)),
    "A65-pvt1": (3, 65, None, 3,
                 dict(n_cand=8, rank_by_pvalue=True, p_value_type=1)),
    # predecessor windows shorter than a block, not a multiple of it, and
    # two blocks (--fastMaxInterval) with the global chain
    "lookback1": (2, 200, None, 0,
                  dict(n_cand=8, rank_by_pvalue=True, p_value_type=0,
                       lookback=1)),
    "lookback17": (2, 200, None, 4,
                   dict(n_cand=8, rank_by_pvalue=True, p_value_type=0,
                        lookback=17)),
    "lookback64-global": (2, 200, None, 0,
                          dict(n_cand=8, rank_by_pvalue=True,
                               p_value_type=0, lookback=64,
                               global_chain=True)),
    # every anchor twinned: equal cands on both sides of the block
    # boundaries (a twin in the older part and one in the previous or
    # current block), under a window of 48
    "ties-blocks": (2, 256, (256, 230), 1,
                    dict(n_cand=8, rank_by_pvalue=False, lookback=48)),
    # invalid anchors at the first and last slots of every block
    "block-edge-holes": (3, 192, (192, 170, 120), 0,
                         dict(n_cand=8, rank_by_pvalue=True,
                              p_value_type=0)),
}

# slots (mod 32) whose anchors a case marks invalid
CHAIN_HOLES = {"block-edge-holes": (0, 1, 30, 31)}


def chain_case(name):
    B, A, nv, tie_every, kw = CHAIN_CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    if nv is None:
        nv = rng.integers(int(0.5 * A), int(0.9 * A), B)
    c = chain_rows(rng, B, A, nv, tie_every=tie_every)
    holes = np.isin(np.arange(A) % 32, CHAIN_HOLES.get(name, ()))
    c["valid"] &= ~holes[None, :]
    return c, kw


SDP_D = 512
# slab start of the "ballot-edges" rows: their guide runs on diagonal 300
BALLOT_DLO = 300 - SDP_D // 2


def _ballot_edges(rng, N, L, W, w_b):
    """Rows whose hits sit on the edges of K4's 32-diagonal ballot steps:
    read segments planted at slab diagonals 31, 32 and D - 1; a read of
    period 15 planted at diagonal 3 (hits at 3, 18, 33, ...: the first two
    inside one step); a C run whose k-mers hit consecutive diagonals with
    31 and 32 among them; diagonals 0 and 480 on disjoint read ranges."""
    reads = rng.integers(0, 4, (N, L)).astype(np.int8)
    windows = rng.integers(0, 4, (N, W)).astype(np.int8)

    def plant(i, s, q0, q1):
        p = BALLOT_DLO + s
        windows[i, q0 + p:q1 + p] = reads[i, q0:q1]

    plant(0, 31, 20, 200)
    plant(1, 32, 20, 200)
    plant(2, SDP_D - 1, 20, 200)
    reads[3, 20:230] = np.tile(rng.integers(0, 4, 15), 14).astype(np.int8)
    plant(3, 3, 20, 220)
    reads[4, 50:110] = 1
    x0 = 60 + BALLOT_DLO + 31        # q = 60 first hits diagonal 31
    windows[4, x0:x0 + 80] = 1
    plant(5, 0, 20, 100)
    plant(5, 480, 120, 200)
    offs = np.arange(L)[None, :] + 300 - w_b // 2 + np.zeros((N, 1), int)
    return reads, windows, offs


def sdp_case(name, w_b=128):
    """(reads int8 [N, L], read_len, windows int8 [N, W], wlens, offs
    int32 [N, L], occ, k) for the SDP window pass at band width ``w_b``
    (the guide offsets are band starts, centred on the planted diagonal).  Read segments are
    planted into the windows along a diagonal, twice in some rows so that
    read positions have a second hit; ``name`` picks the edge:

    * ``clamp-low`` / ``clamp-high``: offsets far outside the window, so
      the slab start clamps to -(L + D) or to W (no hits);
    * ``straddle``: slabs that cross the window's start or end;
    * ``short-windows``: wlens < W masks the window tails;
    * ``empty-read``: a row with no valid read k-mer;
    * ``k16-short``: k = 16 (keys use the top bit) and wlens < W, with T
      runs whose all-T keys (0xFFFFFFFF) meet the invalid-window sentinel,
      as in the JAX package;
    * ``all-n``: windows of N bases only (rows 1 and 4), and an N run
      inside the others;
    * ``ballot-edges``: hits on the edges of the 32-diagonal steps
      (:func:`_ballot_edges`);
    * suffix ``-occ1`` / ``-occ2``: one or two hits per position."""
    base, occ = name.rsplit("-occ", 1)
    rng = np.random.default_rng(sum(map(ord, name)))
    N, L, W = 6, 256, 896
    k = 16 if base == "k16-short" else K_SDP
    if base == "ballot-edges":
        reads, windows, offs = _ballot_edges(rng, N, L, W, w_b)
        rlen = np.full(N, L, np.int32)
        return (reads, rlen, windows, np.full(N, W, np.int32),
                offs.astype(np.int32), int(occ), k)
    reads = rng.integers(0, 4, (N, L)).astype(np.int8)
    rlen = rng.integers(L // 2, L + 1, N).astype(np.int32)
    windows = rng.integers(0, 4, (N, W)).astype(np.int8)
    wlens = np.full(N, W, np.int32)
    shift = rng.integers(40, 300, N)
    if base == "straddle":
        shift[1::2] = 290
    for i in range(N):
        windows[i, shift[i]:shift[i] + 200] = reads[i, 20:220]
        if i % 2 == 0:             # a second copy 50 diagonals up
            windows[i, shift[i] + 60:shift[i] + 160] = reads[i, 30:130]
    reads[:, :4] = 4               # an N run: invalid k-mers
    offs = (np.arange(L)[None, :] + shift[:, None] - 20 - w_b // 2)
    if base == "clamp-low":
        offs = offs - 40_000
    elif base == "clamp-high":
        offs = offs + 40_000
    elif base == "straddle":
        offs[::2] = offs[::2] - 200          # slab starts below 0
        offs[1::2] = offs[1::2] + 200        # slab runs past W
    elif base == "short-windows":
        wlens = rng.integers(W // 3, W, N).astype(np.int32)
    elif base == "empty-read":
        rlen[1] = 0
        reads[3] = 4
    elif base == "k16-short":
        wlens = rng.integers(W // 2, W - 100, N).astype(np.int32)
        reads[:, 100:130] = 3                  # all-T 16-mers: 0xFFFFFFFF
        windows[:, 500:530] = 3
    elif base == "all-n":
        windows[[1, 4]] = 4
        windows[:, 380:400] = 4
    else:
        raise KeyError(name)
    offs = np.maximum.accumulate(offs, axis=1).astype(np.int32)
    return reads, rlen, windows, wlens, offs, int(occ), k


def long_sdp_case(rng, N=4, L=65536, D=512, w_b=128):
    """(reads, read_len, windows, wlens, offs) for the SDP window pass at
    bucket 65536: random windows of the main path's width with read
    segments planted on a diagonal (twice in even rows), guide offsets
    along it.  Its L + D slab keys exceed one block's shared memory."""
    W = -(-(int(L * 1.35) + 2 * w_b) // 128) * 128
    reads = rng.integers(0, 4, (N, L)).astype(np.int8)
    windows = rng.integers(0, 4, (N, W)).astype(np.int8)
    shift = rng.integers(100, 9000, N)
    for i in range(N):
        windows[i, shift[i]:shift[i] + L - 2000] = reads[i, 1000:L - 1000]
        if i % 2 == 0:
            windows[i, shift[i] + 300:shift[i] + 20300] = reads[i, 5000:25000]
    offs = np.clip(np.arange(L)[None, :] + shift[:, None] - 1000 - w_b // 2,
                   0, W - w_b)
    offs = np.maximum.accumulate(offs, axis=1)
    rlen = np.full(N, L, np.int32)
    return reads, rlen, windows, np.full(N, W, np.int32), offs


SDP_CASES = [f"{b}-occ{o}" for b in ("clamp-low", "clamp-high", "straddle",
                                     "short-windows", "empty-read",
                                     "k16-short", "ballot-edges")
             for o in (1, 2)] + ["all-n-occ2"]


# ---------------------------------------------------------------- banded DP

BANDED_CASES = ("L-not-tile", "tile-edges", "slope2-across-tile",
                "negative-offsets", "band-past-window")
# cases outside pallas_banded_align's contract (L a multiple of 64, band
# offsets >= 0); the XLA kernel and the plain DP take them
BANDED_NOT_PALLAS = ("L-not-tile", "negative-offsets")
# seed of the QV words (test_torch_cuda.py::qv_words) the QV mode takes
BANDED_QV_SEED = 55


def banded_case(name, w_b=128):
    """Banded-DP inputs (reads, windows, offsets, qa, qb, ta, tb) at the
    edges of K1's 16-row tiles, four items each (six for ``hp-runs``), the
    read planted on a noisy path into its window:

    * ``L-not-tile``: L = 200, not a multiple of a tile;
    * ``tile-edges``: qa / qb on tile edges (16, 48), one past or before
      them (15, 33), qb = L, and a 17-row span;
    * ``slope2-across-tile``: a slope-2 run over rows 10-40;
    * ``negative-offsets``: the band starts left of the window (o_r < 0)
      at the first rows, the first active row included;
    * ``band-past-window``: the band runs past the window's end
      (o_r + 128 > W);
    * ``hp-runs`` (for the hp band, :data:`K1_MODE_CASES`): homopolymer
      runs of 4-12 bases in the reads, most insertions repeat the previous
      read base, a few read and window bases are N; qa = 0 (row 0, whose
      previous base is code 4), qa on a tile edge, and a qa whose base
      repeats the one before it (outside the aligned range);
    * the hp band's row cases (:data:`HP_ROW_CASES`; ``hp_ok`` is a row's
      ``read[r] == read[r-1] < 4``, its reads built from that mask, an
      item's first row at qa = 0 or where listed):
      ``hp-tile-edges``, hp runs that start and end on rows 15/16 and
      31/32, runs across a tile edge and over a whole tile, ``hp_ok`` at
      qa (qa = 16 and 33) and at qa - 1 outside the range (qa = 5);
      ``hp-alternating``, ``hp_ok`` on every other row (items 0-1) and on
      two rows of four (items 2-3: every pair of the previous row's and
      this row's ``hp_ok`` in turn); ``hp-none``, no two equal adjacent
      read bases; ``hp-all``, one base repeated."""
    rng = np.random.default_rng(sum(map(ord, name)))
    hp = name == "hp-runs"
    N = 6 if hp else 4
    L, W = {"L-not-tile": (200, 448), "band-past-window": (256, 320)}.get(
        name, (256, 512))
    reads = rng.integers(0, 4, (N, L)).astype(np.int8)
    windows = rng.integers(0, 4, (N, W)).astype(np.int8)
    qa = rng.integers(0, 8, N)
    qb = qa + rng.integers(L // 2, L - 8, N)
    ta = rng.integers(1, 40, N)
    if name == "tile-edges":
        qa, qb = np.array([16, 15, 32, 0]), np.array([48, 33, L, 17])
    if hp:
        for i in range(N):
            for p in rng.integers(0, L - 12, 10):
                reads[i, p:p + int(rng.integers(4, 13))] = reads[i, p]
        qa = np.array([0, 16, 37, 0, 5, 64])
        reads[2, 36] = reads[2, 37] = 1          # read[qa] == read[qa - 1]
        qb = np.minimum(qa + rng.integers(L // 2, L - 8, N), L)
    if name in HP_ROW_CASES:
        mask, qa = _hp_rows(name, L, qa)
        reads = _reads_of_hp_rows(rng, mask)
        qb = np.minimum(qa + rng.integers(L // 2, L - 8, N), L)
    slope = np.ones(L, np.int64)
    if name == "slope2-across-tile":
        slope[10:40] = 2
    shift = {"negative-offsets": -40, "band-past-window": 40}.get(name, 0)
    hi = W - 20 if name == "band-past-window" else W - w_b
    offs = np.zeros((N, L), np.int64)
    tb = np.zeros(N, np.int64)
    for i in range(N):
        t = int(ta[i])
        for r in range(int(qa[i]), int(qb[i])):
            if slope[r] == 2 and t + 2 < W:
                windows[i, t] = reads[i, r]
                t += 2
            elif rng.random() < (0.15 if hp else 0.08):
                if hp and r > 0:                     # a homopolymer one
                    reads[i, r] = reads[i, r - 1]
                # an insertion
            else:
                if rng.random() < 0.9:
                    windows[i, t] = reads[i, r]
                t += 1
            t = min(t, W - 1)
        tb[i] = min(t + 1, W)
        steps = np.where(np.arange(L) > qa[i], slope, 0)
        center = np.minimum(ta[i] + np.cumsum(steps), W - 1)
        offs[i] = np.minimum(center - w_b // 2 + shift, hi)
        if shift >= 0:
            offs[i] = np.maximum(offs[i], 0)
    if hp:
        reads[3, 50] = reads[4, 100] = windows[5, 60] = 4
    r = np.arange(L)
    offs = np.maximum.accumulate(offs, axis=1)
    offs = 2 * r + np.minimum.accumulate(offs - 2 * r, axis=1)
    i32 = np.int32
    return (reads, windows, offs.astype(i32), qa.astype(i32), qb.astype(i32),
            ta.astype(i32), tb.astype(i32))


# band widths other than 128, which K1-W and K2-W take
# (csrc/banded_dp_wide.cu, csrc/banded_traceback_wide.cu): 48 (not a
# multiple of 32), 64 and 256
WIDE_WIDTHS = (48, 64, 256)
# K1-W's layouts: CPL = ceil(w_b / 32) band cells a lane of one warp up to
# 256 cells, the first design above; so the widths on each side of a lane
# count's edge (31 | 32 | 33 and 255 | 256 | 257) and at twice 256 (512,
# 513), where a design of several warps would change its warp count
LANE_WIDTHS = (31, 32, 33, 255, 256, 257)
GROUP_WIDTHS = (512, 513)
# K2-W's ring (csrc/banded_traceback_wide.cu::ring_plan): its largest
# width, two 8-row tiles in the SM's whole shared memory, then the first
# width that walks from global memory
RING_WIDTHS = (3615, 3616)
# odd rows for the staging trap: a partial last tile, and at an odd width
# tile starts that are not 16-byte aligned
ODD_ROWS = 201
# the inputs of :func:`wide_case`, in order (all at L = 256, W = 512)
WIDE_PARTS = ("tile-edges", "negative-offsets", "slope2-across-tile",
              "hp-runs", "wild-shifts")


def wide_case(w_b, shifts=False, rows=None):
    """Banded-DP inputs at band width ``w_b`` (22 items, L = 256, W =
    512): :func:`banded_case`'s ``tile-edges``, ``negative-offsets``,
    ``slope2-across-tile`` and ``hp-runs`` at that width, then
    ``wild-shifts``, the ``tile-edges`` inputs on band offsets that K1's
    slope limit refuses and K1-W takes: a step back by 3 then a jump by 5
    (item 0), a jump past the band, w_b + 5 (item 1), a random walk of
    steps -2..4 (item 2) and two steps back on consecutive rows (item
    3).  ``shifts`` appends :func:`lane_shifts` (4 items more); ``rows``
    cuts every item to its first ``rows`` rows (:func:`cut_rows`)."""
    parts = [banded_case(name, w_b) for name in WIDE_PARTS[:-1]]
    wild = [np.array(a) for a in banded_case("tile-edges", w_b)]
    offs = wild[2].astype(np.int64)
    offs[0, 60:] -= 3
    offs[0, 90:] += 5
    offs[1, 25:] += w_b + 5
    steps = np.random.default_rng(w_b).integers(-2, 5, offs.shape[1])
    offs[2] = offs[2, 0] + np.cumsum(steps)
    offs[3, 40:] -= 1
    offs[3, 41:] -= 2
    wild[2] = offs.astype(np.int32)
    parts.append(tuple(wild))
    if shifts:
        parts.append(lane_shifts(w_b))
    out = tuple(np.concatenate([p[k] for p in parts])
                for k in range(len(parts[0])))
    return out if rows is None else cut_rows(out, rows, w_b)


def lane_shifts(w_b):
    """The ``tile-edges`` inputs (4 items) on band shifts that move K1-W's
    warp layout (CPL = ceil(w_b / 32) cells a lane) by whole and part
    lanes: a step of CPL + 1 cells (one lane and a cell), then 3 * CPL +
    2, then -(CPL + 1) (item 0); steps back by 1 (the diagonal slice
    starts past the row), 2, 5 and w_b + 1 (item 1); steps of exactly w_b
    and w_b + 1, and back by 2 * w_b + 1 (the start wraps back onto the
    row) and 2 * w_b + 5 (item 2); a random walk of steps -40..40 (item
    3)."""
    cpl = -(-w_b // 32)
    a = [np.array(x) for x in banded_case("tile-edges", w_b)]
    offs = a[2].astype(np.int64)
    for r, d in ((30, cpl + 1), (50, 3 * cpl + 2), (70, -(cpl + 1))):
        offs[0, r:] += d
    for r, d in ((20, -1), (24, -2), (30, -5), (36, -(w_b + 1))):
        offs[1, r:] += d
    for r, d in ((20, w_b), (26, w_b + 1), (33, -(2 * w_b + 1)),
                 (40, -(2 * w_b + 5))):
        offs[2, r:] += d
    steps = np.random.default_rng(w_b + 1).integers(-40, 41, offs.shape[1])
    offs[3] = offs[3, 0] + np.cumsum(steps)
    a[2] = offs.astype(np.int32)
    return tuple(a)


def cut_rows(arrs, rows, w_b):
    """Banded-DP inputs cut to their first ``rows`` rows: qa and qb
    clipped into them, and tb moved to the band's middle column at the
    last row qb - 1 (so that the item ends inside its band)."""
    reads, windows, offs, qa, qb, ta, tb = (np.array(a) for a in arrs)
    reads, offs = reads[:, :rows], offs[:, :rows]
    qa = np.minimum(qa, rows - 1)
    qb = np.minimum(qb, rows)
    last = offs[np.arange(len(qb)), qb - 1].astype(np.int64) + w_b // 2
    tb = np.clip(last, ta + 1, windows.shape[1])
    i32 = np.int32
    return (reads, windows, offs, qa.astype(i32), qb.astype(i32),
            ta.astype(i32), tb.astype(i32))


def _hp_rows(name, L, qa):
    """(hp_ok mask [4, L], qa) of a :data:`HP_ROW_CASES` input."""
    r = np.arange(L)
    mask = np.zeros((4, L), bool)
    qa = qa.copy()
    qa[0] = 0
    if name == "hp-tile-edges":
        qa = np.array([0, 16, 33, 5])
        runs = ([(12, 15), (28, 31), (40, 47), (100, 140)],
                [(16, 19), (32, 36), (60, 70)],
                [(33, 35), (47, 48), (62, 66)],
                [(4, 7), (15, 16), (31, 32), (80, 95)])
        for i, item in enumerate(runs):
            for a, b in item:
                mask[i, a:b + 1] = True
    elif name == "hp-alternating":
        mask[:2] = r % 2 == 1
        mask[2:] = r % 4 >= 2
    elif name == "hp-all":
        mask[:] = True
    return mask, qa


def _reads_of_hp_rows(rng, mask):
    """Reads whose ``read[r] == read[r-1]`` exactly where ``mask`` is set
    (r >= 1): a masked row repeats the base before it, any other row
    takes another of the four."""
    N, L = mask.shape
    reads = np.zeros((N, L), np.int8)
    reads[:, 0] = rng.integers(0, 4, N)
    for r in range(1, L):
        other = (reads[:, r - 1] + rng.integers(1, 4, N)) % 4
        reads[:, r] = np.where(mask[:, r], reads[:, r - 1], other)
    return reads


# the hp band's row cases (csrc/banded_dp.cu): whether the previous row can
# carry H and whether this row can take it, switching on tile edges and at
# every row, never set and always set
HP_ROW_CASES = ("hp-tile-edges", "hp-alternating", "hp-none", "hp-all")
# K1's modes beyond distance and QV (csrc/banded_dp.cu), on the tile-edge
# shapes, the homopolymer world and the hp band's row cases; the plain DP
# meets JAX's XLA kernel on them in tests/test_torch_banded_modes.py, K1
# the plain DP on the card
K1_MODE_CASES = BANDED_CASES + ("hp-runs",) + HP_ROW_CASES
# the default matrix (match -5 on the ACGT diagonal, 6 elsewhere) and a
# general one: unequal diagonal entries, uneven mismatches, an N row (read
# N) and an N column (window N and the pad past the window) of their own
DEFAULT_SUBMAT = np.where(np.eye(5, dtype=bool) & (np.arange(5) < 4),
                          -5.0, 6.0).astype(np.float32).reshape(25)
GEN_SUBMAT = np.array([[-5, 6, 7, 6, 8],
                       [6, -4, 6, 7, 8],
                       [7, 6, -6, 6, 8],
                       [6, 7, 6, -3, 8],
                       [9, 9, 9, 9, 10]], np.float32).reshape(25)
# the Mapper's --affineAlign costs at the default parameters: insertion
# 10 + 4 / 1, deletion 10 + 5 / 1, hp band indel + 2 / indel - 3
AFFINE_GAPS = (14.0, 1.0, 15.0, 1.0)
HP_COSTS = (7.0, 2.0)
# mode -> (matrix, gap costs, hp band costs or None, QV words); "hp-ties"
# prices H as I, so the two tie wherever H is open (the tie orders M, I,
# D, H of the diagonal source and the final state decide)
K1_MODES = {
    "hp": (DEFAULT_SUBMAT, AFFINE_GAPS, HP_COSTS, False),
    "hp-ties": (DEFAULT_SUBMAT, (7.0, 2.0, 8.0, 2.0), (7.0, 2.0), False),
    "gen": (GEN_SUBMAT, (4.0, 4.0, 5.0, 5.0), None, False),
    "hp-gen": (GEN_SUBMAT, AFFINE_GAPS, HP_COSTS, False),
    "qv-gen": (GEN_SUBMAT, (4.0, 4.0, 5.0, 5.0), None, True),
}


def k1_mode_kwargs(mode):
    """(matrix, gap costs, keyword arguments of banded_align but the QV
    words) of a :data:`K1_MODES` mode."""
    submat, gaps, hp, _ = K1_MODES[mode]
    kw = {} if hp is None else dict(use_hp=True, hp_open=hp[0],
                                    hp_ext=hp[1])
    return submat, gaps, kw


# ---------------------------------------------------------------- anchors

ANCHOR_L = 256
BIG32 = 0x3FFFFFFF


def anchor_world(seed=41):
    """(genome int8 [G], reads int8 [B, L], read_len int32 [B]).  The
    genome is random with a 40-base unit planted 60 times (its k-mers occur
    more often than O and than a small max_anchors_per_pos), a 300-base
    block planted 6 times, and an N run.  Rows: two noisy reads, a read
    shorter than k, a read with N runs, a row with no valid k-mer, a read
    tiling the 60-copy unit (more valid candidates than A, nearly all of
    one length) and the genome's last 200 bases (hits whose extension
    runs past the genome's end)."""
    rng = np.random.default_rng(seed)
    G, L = 24_000, ANCHOR_L
    g = rng.integers(0, 4, G).astype(np.int8)
    unit = rng.integers(0, 4, 40).astype(np.int8)
    for c in range(60):
        s0 = 2_000 + 97 * c
        g[s0:s0 + 40] = unit
    block = rng.integers(0, 4, 300).astype(np.int8)
    for c in range(6):
        g[9_000 + 1_400 * c:9_300 + 1_400 * c] = block
    g[17_000:17_050] = 4

    def noisy(src):
        out = src.copy()
        hit = rng.random(len(out)) < 0.06
        out[hit] = rng.integers(0, 4, int(hit.sum()))
        return out

    B = 7
    reads = np.full((B, L), 4, np.int8)
    rlen = np.zeros(B, np.int32)
    s1 = 12_500
    reads[0] = noisy(g[s1:s1 + L])
    rlen[0] = L
    reads[1, :200] = noisy(g[9_050:9_250])         # inside a 6-copy block
    rlen[1] = 200
    reads[2, :8] = g[5_000:5_008]                  # shorter than k
    rlen[2] = 8
    reads[3] = g[20_000:20_000 + L]
    reads[3, 30:45] = 4                            # N runs
    reads[3, 100:103] = 4
    rlen[3] = L
    rlen[4] = L                                    # all N: no valid k-mer
    reads[5] = np.tile(unit, L // 40 + 1)[:L]      # the 60-copy unit
    rlen[5] = L
    reads[6, :200] = g[G - 200:]                   # the genome's end
    rlen[6] = 200
    return g, reads, rlen


# name -> (find_anchors keyword arguments beyond the defaults, index fields
#          withheld)
_ANCHOR_DEFAULTS = dict(k=12, occ_per_pos=3, max_anchors=512, anchor_ext=20,
                        min_match=12, max_anchors_per_pos=10000)
ANCHOR_CASES = {
    "default": ({}, ()),
    "saturated-A64": (dict(max_anchors=64), ()),
    "mapp40": (dict(max_anchors_per_pos=40), ()),
    "occ6-A2048": (dict(occ_per_pos=6, max_anchors=2048), ()),
    "occ48-A2048": (dict(occ_per_pos=48, max_anchors=2048), ()),
    "advance8": (dict(advance_exact=8), ()),
    "maxlcp20": (dict(max_lcp=20), ()),
    "starts-only": ({}, ("bucket_pairs",)),
    "sorted-keys": ({}, ("bucket_pairs", "bucket_starts")),
    "words-E36": (dict(anchor_ext=36, min_match=14), ()),
    "words-no-records": ({}, ("pos_records",)),
    # the boundaries of K5's selection (csrc/anchor_search.cu): row 5 has
    # 99 valid candidates at the defaults (44 of length 32, then 6, 6, 18,
    # 1, 3, 3 and 18 of lengths 31 down to 12), so A = 99 takes them all,
    # A = 100 one invalid fill and A = 98 a radix select of 17 of the 18
    # ties at length 12; at A = 30 the 30 selected of the 44 ties at
    # length 32 span several top digits of their bit-reversed indices
    "valid-eq-A99": (dict(max_anchors=99), ()),
    "valid-A100": (dict(max_anchors=100), ()),
    "valid-A98": (dict(max_anchors=98), ()),
    "ties-A30": (dict(max_anchors=30), ()),
    # O = 1 and 2 (8 and 9 index bits; seeds with 60 occurrences far above
    # O take the strided index), O = 5 and 64 past the kernel's
    # compile-time O = 1..4 (a deep-seed rerun's O; A = 8192: an invalid
    # fill over several chunks, the bitonic sort above 4096 keys and a row
    # too large to stage in shared memory)
    "occ1-A32": (dict(occ_per_pos=1, max_anchors=32), ()),
    "occ2-A60": (dict(occ_per_pos=2, max_anchors=60), ()),
    "occ5-A128": (dict(occ_per_pos=5, max_anchors=128), ()),
    "occ64-A8192": (dict(occ_per_pos=64, max_anchors=8192), ()),
    # occ_block_sample (K5's block mode): O consecutive slots from a base
    # rotating with q, the records fetched as one slice; at O = 64 the
    # 60-copy seeds fit (base = lo) and the slice runs past hi
    "block-default": (dict(occ_block_sample=True), ()),
    "block-no-records": (dict(occ_block_sample=True), ("pos_records",)),
    "block-occ5-A128": (dict(occ_block_sample=True, occ_per_pos=5,
                             max_anchors=128), ()),
    "block-occ64-A8192": (dict(occ_block_sample=True, occ_per_pos=64,
                               max_anchors=8192), ()),
    "block-sorted-keys": (dict(occ_block_sample=True),
                          ("bucket_pairs", "bucket_starts")),
}
# row 5's valid count minus A in the cases at that boundary
ANCHOR_ROW5_EXCESS = {"valid-eq-A99": 0, "valid-A100": -1, "valid-A98": 1}


def anchor_case(name):
    """(genome, reads, read_len, find_anchors keyword arguments without the
    index arrays, index fields to withhold)."""
    kw, drop = ANCHOR_CASES[name]
    g, reads, rlen = anchor_world()
    return g, reads, rlen, dict(_ANCHOR_DEFAULTS, **kw), drop


# ---------------------------------------------------------------- chain members

# K7 (csrc/chain_members.cu) takes one of three paths by the sizes of
# csrc/chain_members_plan.h: the lifting table in shared memory (one CTA
# of C <= 1024 // M chains a row: C * M int64 keys, C int32 counts and
# bit_length(M - 1) int32 levels of A), else a warp a chain chasing the
# row's parents staged in shared memory (C <= 4 warps of M int64 and M
# int32 slots, then A int32 parents), else chasing them in global memory;
# within 232448 - 4096 bytes, at C = 4, M = 96 the table fits up to
# A = 8045 and the parents up to A = 55936

# name -> (B, A, C, M, longest chain)
MEMBER_CASES = {
    "bench-shape": (4, 512, 10, 96, 150),
    "sdp-shape": (4, 1024, 1, 256, 400),
    "longer-than-M": (2, 1024, 4, 32, 500),
    "q-ties": (3, 256, 8, 64, 80),
    "q-not-monotone": (3, 256, 8, 64, 80),
    "invalid-cands": (4, 300, 6, 48, 60),
    "M1": (2, 128, 5, 1, 20),
    "M100-C3": (3, 400, 3, 100, 200),
    "big-q": (2, 128, 4, 48, 40),
    "parents-in-global": (1, 60000, 4, 96, 300),
    # the seams of the paths: the table in shared memory or the chase, the
    # parents in shared or in global memory, each limit met and passed
    "table-fits-A8045": (1, 8045, 4, 96, 300),
    "table-over-A8046": (1, 8046, 4, 96, 300),
    "parents-fit-A55936": (1, 55936, 4, 96, 300),
    "parents-over-A55937": (1, 55937, 4, 96, 300),
    # one lifting level; a chain of exactly M = 64 members and one of M + 1
    "M2": (2, 128, 5, 2, 20),
    "M64-chain-64": (2, 256, 4, 64, 64),
    "M64-chain-65": (2, 256, 4, 64, 65),
    # chains of one row that end on the long chain or branch off it
    "shared-suffix": (3, 512, 10, 96, 150),
    # sdp_align's whole call: 64 pairs, one chain of up to 256 members
    "sdp-B64-chain-300": (64, 1024, 1, 256, 300),
}
# the (warps, stage) of K7's launch in each seam case: stage 2 (the
# lifting table, warps = the chains a CTA), 1 (the chase over the parents
# in shared memory) or 0 (the chase over global memory)
MEMBER_PATH_CASES = {"bench-shape": (10, 2), "sdp-shape": (1, 2),
                     "table-fits-A8045": (4, 2), "table-over-A8046": (4, 1),
                     "parents-fit-A55936": (4, 1),
                     "parents-over-A55937": (4, 0),
                     "parents-in-global": (4, 0)}


def member_case(name):
    """Inputs of ``chain_members`` as int64 / bool numpy arrays, shaped as
    K3 leaves them: anchors q, t, l [B, A] (t ascending), parent pointers
    [B, A] to earlier anchors (-1 at chain starts), chain ends end_idx and
    their flags valid [B, C], plus M = max_chain.  Every row holds one
    chain of the case's longest length and a forest of shorter ones; the
    ends are that chain's end, other chains' ends and random anchors.
    "q-ties" gives a third of the members their parent's q; "q-not-
    monotone" draws q at random, so a chain's q need not fall toward its
    start; "invalid-cands" clears half the flags and ends two chains at
    -1; "big-q" puts some q at or above BIG32 (2^30 - 1); "shared-suffix"
    ends chains 1-3 on the long chain and the others on anchors whose
    parent lies on it."""
    B, A, C, M, longest = MEMBER_CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    t = np.sort(rng.integers(0, 4_600_000, (B, A)), axis=1)
    l = rng.integers(12, 33, (B, A))
    parent = np.full((B, A), -1, np.int64)
    q = np.zeros((B, A), np.int64)
    end_idx = np.zeros((B, C), np.int64)
    for b in range(B):
        # the long chain on evenly spread anchors, the others a forest
        long_ids = np.linspace(0, A - 1, min(longest, A)).astype(np.int64)
        on_long = np.zeros(A, bool)
        on_long[long_ids] = True
        parent[b, long_ids[1:]] = long_ids[:-1]
        for i in range(1, A):
            if not on_long[i] and rng.random() < 0.8:
                parent[b, i] = int(rng.integers(max(0, i - 48), i))
        qq = np.zeros(A, np.int64)
        for i in range(A):       # q grows along a chain, as K3 chains it
            p = parent[b, i]
            qq[i] = (qq[p] if p >= 0 else 0) + int(rng.integers(1, 40))
            if name == "q-ties" and p >= 0 and rng.random() < 0.33:
                qq[i] = qq[p]
        if name == "q-not-monotone":
            qq = rng.integers(0, 3000, A)
        if name == "big-q":
            hi = rng.random(A) < 0.3
            qq = np.where(hi, BIG32 - 2 + rng.integers(0, 5, A), qq)
        ends = rng.integers(0, A, C)
        ends[0] = long_ids[-1]
        if name == "shared-suffix":
            ends[1:4] = rng.choice(long_ids[-M:-1], 3, replace=False)
            off = rng.choice(np.flatnonzero(~on_long[1:]) + 1, C - 4,
                             replace=False)
            for c, i in enumerate(off, start=4):
                below = long_ids[long_ids < i]
                parent[b, i] = below[int(rng.integers(len(below) // 2,
                                                      len(below)))]
                qq[i] = qq[parent[b, i]] + int(rng.integers(1, 40))
                ends[c] = i
        q[b] = qq
        end_idx[b] = ends
    valid = rng.random((B, C)) < 0.8
    if name == "invalid-cands":
        valid = rng.random((B, C)) < 0.5
        end_idx[0, 1] = end_idx[1, 2] = -1
    return dict(q=q, t=t.astype(np.int64), l=l.astype(np.int64),
                parent=parent, end_idx=end_idx, valid=valid, M=M)


# ---------------------------------------------------------------- band offsets

BAND_CASES = ("no-members", "one-member", "ends", "duplicate-rows",
              "frags-outside-band", "between-only", "negative-steps",
              "no-frags", "five-fragments", "long-rows", "rows-1001",
              "smem-rows-8192", "global-rows-8193", "last-row-only")
# K6 (csrc/band_offsets.cu) keeps up to 8192 rows in shared memory, 256
# threads of ceil(L / 256) rows each, and a global scratch row above
_BAND_L = {"long-rows": 4096, "rows-1001": 1001, "smem-rows-8192": 8192,
           "global-rows-8193": 8193}


def band_case(name, w_b=128):
    """Inputs of ``_band_offsets`` at band width ``w_b`` as int64 / bool
    numpy arrays: chain
    members mq/mt [N, MC] (BIG32 where invalid, q-ascending as
    chain_members leaves them), window starts ws [N], fragments frag_diag /
    frag_valid [N, L, F] near the members' diagonals (or None), plus L, W,
    w_b and between_only.  "long-rows" (L = 4096) has so few members that
    the fills carry across many threads' rows; "rows-1001" leaves the last
    of K6's row-owning threads one row; "smem-rows-8192" and
    "global-rows-8193" lie on either side of its shared-memory limit;
    "last-row-only" gives item 0 one member, on row L - 1."""
    rng = np.random.default_rng(sum(map(ord, name)))
    N, L, W, MC = 6, 512, 1024, 24
    if name in _BAND_L:
        L = _BAND_L[name]
        W = 2 * L
    F = 5 if name == "five-fragments" else 3
    ws = rng.integers(1_000, 50_000, N).astype(np.int64)
    mq = np.full((N, MC), BIG32, np.int64)
    mt = np.full((N, MC), BIG32, np.int64)
    base = rng.integers(100, 400, N)
    for i in range(N):
        if name == "no-members":
            break
        if name == "one-member":
            qs = rng.integers(0, L, 1)
        elif name == "ends":
            qs = np.array([0, 200, L - 1])
        elif name == "duplicate-rows":
            qs = np.repeat(rng.integers(0, L, 6), 3)
        elif name == "long-rows":
            # item i's members lie in its first 4 // (1 + i % 4) chunks
            qs = rng.integers(0, L // (1 + i % 4), int(rng.integers(1, 4)))
        elif name == "last-row-only" and i == 0:
            qs = np.array([L - 1])
        else:
            qs = rng.integers(0, L, int(rng.integers(4, MC)))
        qs = np.sort(qs)
        if name == "negative-steps":
            diag = base[i] - 3 * np.arange(len(qs)) * rng.integers(5, 40)
        else:
            diag = base[i] + rng.integers(-40, 41, len(qs))
        mq[i, :len(qs)] = qs
        mt[i, :len(qs)] = ws[i] + qs + diag
    frag_diag = frag_valid = None
    if name != "no-frags":
        centre = base[:, None, None] + rng.integers(-60, 61, (N, L, F))
        if name == "frags-outside-band":
            far = rng.random((N, L, F)) < 0.5
            centre = np.where(far, centre + rng.choice([-1, 1], (N, L, F))
                              * rng.integers(200, 40_000, (N, L, F)), centre)
        frag_diag = centre.astype(np.int64)
        # sparse on long rows, so the fills after the fold cross chunks too
        frag_valid = rng.random((N, L, F)) < (0.001 if L > 1024 else 0.3)
    return dict(mq=mq, mt=mt, ws=ws, L=L, W=W, w_b=w_b, frag_diag=frag_diag,
                frag_valid=frag_valid, between_only=name == "between-only")


# ---------------------------------------------------------------- traceback

TB_TILE = 16      # K2 stages an item's rows in 16-row tiles
TB_ST_M, TB_ST_I, TB_ST_D, TB_ST_H = 0, 1, 2, 3


def _cell(rng, **f):
    """A cell word (kernels/banded.py layout) with random unused bits and
    the traceback fields given (the rest random)."""
    word = int(rng.integers(0, 1 << 30))
    for name, (shift, width) in (("i_open", (2, 1)), ("d_open", (3, 1)),
                                 ("d_from_m", (4, 1)), ("h_open", (6, 1)),
                                 ("rexit", (7, 2)), ("mrun", (9, 6)),
                                 ("meq", (15, 6)), ("s_r", (21, 2)),
                                 ("ssum", (23, 7))):
        v = f.get(name, int(rng.integers(0, 1 << width)))
        word = (word & ~(((1 << width) - 1) << shift)) | (v << shift)
    return word


def _plant_walk(rng, tbb, off, L, qa, qb, tb, st, P, runs, stall_rows,
                exit_at):
    """Write the cells that one item's walk reads, step by step, as the
    walk (kernels/banded.py::banded_traceback_plain) will take them: M runs
    drawn from ``runs`` (clipped to keep the band column in [0, 128)), I, D
    and H steps with random exits; an M step whose landing row is in
    ``stall_rows`` saturates its band jump (ssum = 127), so the walk
    stalls there and re-derives its column from ``off`` (set so that it
    lands mid-band); at the first M step from step ``exit_at`` on the
    column leaves the band."""
    t = tb - 1
    r = qb - 1
    w = t - off[min(max(r, 0), L - 1)]
    wbad = False
    for step in range(P):
        if r < qa:
            return
        rc = min(max(r, 0), L - 1)
        if wbad:                                     # a stall step
            off[rc] = t - int(rng.integers(40, 88))
            w = t - off[rc]
            wbad = False
            continue
        wc = min(max(w, 0), 127)
        w_ok = 0 <= w < 128
        if st == TB_ST_M:
            m = int(rng.integers(*runs))
            target = [x for x in stall_rows if r - 63 <= x < r and x >= qa]
            sat = bool(target) and rng.random() < 0.7
            if sat:
                m = r - target[0]
            m = max(1, min(m, 63))
            leave = 0 <= exit_at <= step
            nw = 130 if leave else int(rng.integers(20, 108))
            if leave:
                exit_at = -1
            ssum = 127 if sat else min(max(nw - w + m, 0), 126)
            tbb[rc, wc] = _cell(rng, mrun=m, meq=int(rng.integers(0, m + 1)),
                                ssum=ssum,
                                rexit=int(rng.choice(4, p=(.4, .25, .25, .1))))
            nr, t, w = r - m, t - m, w - m + ssum
            wbad = sat and nr >= qa
            st = (int(tbb[rc, wc]) >> 7) & 3
        elif st == TB_ST_D:
            tbb[rc, wc] = _cell(rng, d_open=int(rng.random() < 0.5))
            nr, t, w = r, t - 1, w - 1
            cell = int(tbb[rc, wc])
            if (cell >> 3) & 1:
                st = TB_ST_M if (cell >> 4) & 1 else TB_ST_I
        else:
            s_r = int(rng.integers(0, 3))
            tbb[rc, wc] = _cell(rng, s_r=s_r, i_open=int(rng.random() < 0.5),
                                h_open=int(rng.random() < 0.5))
            nr, w = r - 1, w + s_r
            cell = int(tbb[rc, wc])
            if (cell >> (6 if st == TB_ST_H else 2)) & 1:
                st = TB_ST_M
        r = nr
        if not w_ok:
            return


# name -> (L, t_max, M run lengths [lo, hi), per-item (qa, qb, tb - ta) or
#          None for valid == 0, rows where a saturated M step lands, the
#          step at which the band column leaves the band)
TRACEBACK_CASES = {
    # M steps of 40-63 rows cross up to four 16-row tiles at once; qb - 1
    # on a tile's top row (63, 127, 255) and bottom row (16)
    "m-runs-cross-tiles": (256, 640, (40, 64),
                           [(0, 256, 300), (16, 240, 280), (3, 64, 90),
                            (17, 128, 150), (0, 17, 40), (40, 200, 190)],
                           (), -1),
    # qa and qb - 1 on and beside tile edges, short runs
    "ends-on-tile-edges": (256, 640, (1, 24),
                           [(16, 32, 40), (15, 33, 40), (17, 49, 50),
                            (32, 48, 30), (31, 47, 30), (0, 1, 5)],
                           (), -1),
    # stall steps on the first and last rows of tiles
    "stall-on-tile-edge": (256, 640, (4, 40),
                           [(0, 256, 300), (5, 250, 300), (16, 200, 240),
                            (0, 160, 200), (33, 255, 260), (2, 129, 150)],
                           (16, 31, 32, 47, 48, 64, 79, 95, 96, 127, 128,
                            143, 160, 175, 191, 192, 208, 223, 224), -1),
    # L = 200 is not a multiple of the tile: the top tile holds 8 rows
    "L-not-tile": (200, 640, (1, 40),
                   [(0, 200, 240), (7, 200, 220), (0, 193, 230),
                    (100, 192, 120), (191, 200, 20), (0, 199, 230)],
                   (64, 79, 112, 128), -1),
    # valid == 0 items; qb - 1 < qa (the walk is all boundary, one item
    # past the 16383-column cap); qa = qb - 1
    "invalid-and-empty": (256, 640, (1, 30),
                          [None, (10, 10, 40_000), (0, 256, 300), None,
                           (50, 51, 3), (0, 0, 0)], (), -1),
    # walks longer than P = 128 (short runs, many I / D steps) overflow;
    # one leaves the band at its 20th step
    "overflow-and-band-exit": (256, 128, (1, 4),
                               [(0, 256, 300), (0, 240, 280), (30, 250, 260),
                                (0, 256, 300), (100, 256, 200),
                                (0, 200, 230)], (), 20),
    # the hp band's walks: half the items end in H, whose steps exit by
    # their h_open bit; M runs exit to H too (rexit 3)
    "hp-walks": (256, 640, (1, 30),
                 [(0, 256, 300), (16, 240, 280), (3, 200, 230),
                  (0, 128, 150), (40, 250, 230), (0, 60, 70)], (), -1),
}


def traceback_case(name):
    """Inputs of the run-length traceback with planted walks: (tbbits
    int32 [N, L, 128], final_state int32 [N], valid bool [N], offsets
    int32 [N, L], qa, qb, ta, tb int32 [N], t_max).  Cells off the walks
    are random words; each walk's cells are written as it will read them
    (:func:`_plant_walk`), so its rows, runs, stalls and stop are
    chosen."""
    L, t_max, runs, items, stall_rows, exit_at = TRACEBACK_CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    N = len(items)
    P = -(-t_max // 128) * 128
    tbb = rng.integers(0, 1 << 30, (N, L, 128)).astype(np.int64)
    off = rng.integers(0, 400, (N, L)).astype(np.int64)
    qa, qb, ta, tb = (np.zeros(N, np.int64) for _ in range(4))
    st = rng.integers(0, 3, N).astype(np.int64)
    if name == "hp-walks":
        st[0::2] = TB_ST_H
    valid = np.array([it is not None for it in items])
    for n, it in enumerate(items):
        qa[n], qb[n], span = it if it is not None else (0, L, 200)
        ta[n] = int(rng.integers(1, 40))
        tb[n] = ta[n] + span
        off[n, min(max(qb[n] - 1, 0), L - 1)] = tb[n] - 1 - int(
            rng.integers(30, 98))
        if it is not None:
            _plant_walk(rng, tbb[n], off[n], L, int(qa[n]), int(qb[n]),
                        int(tb[n]), int(st[n]), P, runs, stall_rows,
                        exit_at if n % 2 == 0 else -1)
    i32 = np.int32
    return (tbb.astype(i32), st.astype(i32), valid, off.astype(i32),
            qa.astype(i32), qb.astype(i32), ta.astype(i32), tb.astype(i32),
            t_max)

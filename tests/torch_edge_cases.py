"""Edge inputs of the chain scan and the SDP window pass, built with numpy
from a seed.  ``tests/test_torch_chain_sdp_edges.py`` holds the plain
PyTorch versions to the JAX package on them; ``tests/test_torch_cuda.py``
holds the CUDA kernels K3 and K4 to the plain versions on the same inputs
(it runs where JAX is absent, so this module imports numpy only).
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
}


def chain_case(name):
    B, A, nv, tie_every, kw = CHAIN_CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    if nv is None:
        nv = rng.integers(int(0.5 * A), int(0.9 * A), B)
    return chain_rows(rng, B, A, nv, tie_every=tie_every), kw


def sdp_case(name):
    """(reads int8 [N, L], read_len, windows int8 [N, W], wlens, offs
    int32 [N, L], occ) for the SDP window pass.  Read segments are planted
    into the windows along a diagonal, twice in some rows so that read
    positions have a second hit; ``name`` picks the edge:

    * ``clamp-low`` / ``clamp-high``: offsets far outside the window, so
      the slab start clamps to -(L + D) or to W (no hits);
    * ``straddle``: slabs that cross the window's start or end;
    * ``short-windows``: wlens < W masks the window tails;
    * ``empty-read``: a row with no valid read k-mer;
    * suffix ``-occ1`` / ``-occ2``: one or two hits per position."""
    base, occ = name.rsplit("-occ", 1)
    rng = np.random.default_rng(sum(map(ord, name)))
    N, L, W, w_b = 6, 256, 896, 128
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
    else:
        raise KeyError(name)
    offs = np.maximum.accumulate(offs, axis=1).astype(np.int32)
    return reads, rlen, windows, wlens, offs, int(occ)


SDP_CASES = [f"{b}-occ{o}" for b in ("clamp-low", "clamp-high", "straddle",
                                     "short-windows", "empty-read")
             for o in (1, 2)]

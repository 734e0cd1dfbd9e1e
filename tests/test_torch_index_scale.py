"""The device index at scale, at a small size on the CPU: an index past
the records cap maps as one within it (``DeviceIndex.from_host`` then
leaves the records out and K5's plain version gathers the words), and as
the benchmark's plain reference does; the records table and the packed
words built a chunk at a time equal the whole-array build bit for bit;
the anchor search's seed counts in a batch's ``flat`` tail equal a
recount from ``bucket_starts``; ``from_host`` fills its set-up spans
once per call; and on CUDA the records are built when their bytes fit
in an eighth of the card's memory."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from benchmark import check, inputs, sim  # noqa: E402
from blasr_tpu_torch.index.genome import (build_genome_index,  # noqa: E402
                                          build_packed_words)
from blasr_tpu_torch.io.fasta import FastaRecord  # noqa: E402
from blasr_tpu_torch.params import MappingParams  # noqa: E402
from blasr_tpu_torch.pipeline import map_read as tmr  # noqa: E402
from blasr_tpu_torch.pipeline import metrics  # noqa: E402
from blasr_tpu_torch.pipeline import select as psel  # noqa: E402
from blasr_tpu_torch.pipeline.zmw import zmw_key  # noqa: E402
from torch_shared import TORCH_THREADS, shared  # noqa: E402

torch.set_num_threads(TORCH_THREADS)

SEED = 4123000077
# three contigs at a few hundred kb with one planted repeat family (so
# that some seeds occur more often than occ_per_pos), and a pool of
# CLR-like reads: the benchmark's generator, as a cell makes them
CONFIG = {"genome_seed": 23, "mapper": {},
          "genome": {"contigs": [["chr1", 180000], ["chr2", 120000],
                                 ["chrC", 40000]],
                     "repeat_families": [{
                         "name": "R", "element_len": 2000, "ltr_len": 250,
                         "n_full": 8, "n_solo": 6,
                         "full_identity": [0.995, 1.0],
                         "solo_identity": [0.9, 1.0]}]}}
MIX = {"n_reads": 10,
       "length": {"kind": "lognormal_quantiles", "mean": 900, "sd": 350,
                  "min": 400, "max": 1800},
       "accuracy": {"kind": "normal_quantiles", "mean": 0.82, "sd": 0.02,
                    "min": 0.78},
       "error_split": {"ins": 0.6, "del": 0.3, "sub": 0.1},
       "both_strands": True, "mapper": {}}


def _index(inp):
    params = MappingParams(**inp.mapper).make_sane()
    gi = build_genome_index([FastaRecord(c.title, c.seq)
                             for c in inp.contigs],
                            k=min(params.min_match_length, 16))
    return gi, params


def _build(d):
    """The pool mapped three ways, as the benchmark compares a call: the
    port with the records, the port with the records cap below the
    index's slots, and the plain reference; with what each index held."""
    torch.set_num_threads(TORCH_THREADS)
    inp = inputs.make(CONFIG, MIX, SEED)
    gi, params = _index(inp)
    recs = [FastaRecord(r.name, r.seq) for r in inp.pool]
    out = {"slots": int(gi.pos_sorted.shape[0])}
    cap = tmr.DeviceIndex.RECORDS_MAX_SLOTS
    for name, limit in (("records", cap), ("words", out["slots"] - 1)):
        tmr.DeviceIndex.RECORDS_MAX_SLOTS = limit
        try:
            mapper = tmr.Mapper(gi, params, device="cpu")
        finally:
            tmr.DeviceIndex.RECORDS_MAX_SLOTS = cap
        per_read = mapper.map_reads(recs)
        out[name] = check.finish_reads(per_read, recs, mapper.params, gi,
                                       psel, zmw_key)
        out[f"{name}_held"] = mapper.dev.pos_records is not None
        out[f"{name}_counters"] = dict(mapper.metrics.counters)
    ref = check.run_reference(inp, SEED, torch.device("cpu"))
    out["reference"] = ref.reads
    out["deep"] = sorted(ref.deep)
    return out


@pytest.fixture
def mapped(tmp_path_factory):
    return shared(tmp_path_factory, __file__, "mapped", _build)


def test_past_the_records_cap_maps_as_within_it(mapped):
    """The port without records (the cap patched below the slots) gives
    every read the answer it gives with them, and each read the
    reference maps the reference's answer."""
    assert mapped["records_held"] and not mapped["words_held"]
    assert mapped["records"] == mapped["words"]
    compared = 0
    for j, want in enumerate(mapped["reference"]):
        if want is None or j in mapped["deep"]:
            continue
        compared += 1
        assert mapped["words"][j] == want, j
    assert compared >= 6
    assert sum(1 for c in mapped["words"] if c and c[0]) >= 8


def test_seed_counters_match_with_records_or_without(mapped):
    """The seed counters count what the search needs, not the layout:
    equal with the records and without them."""
    a, b = mapped["records_counters"], mapped["words_counters"]
    for name in tmr.SEED_COUNTERS:
        assert a[name] == b[name] > 0, name
    assert a["anchor_examined"] <= a["anchor_slots"]
    assert a["anchor_capped"] <= a["anchor_seeds"]


def _one_shot_records(genome, pos, gw, gn, k):
    """The records table as one int64 stack, the pad rows concatenated
    after it, then cast to int32 bit patterns (the layout K5 reads)."""
    G = genome.shape[0]
    cols = [pos, genome[(pos - 1).clamp(0, G - 1)].to(torch.int64)]
    for j in range(2):
        off = k + 16 * j
        gidx = (pos + off).clamp(0, G - 1)
        cols.append(gw[gidx])
        cols.append(torch.where(pos + off < G, gn[gidx], tmr.MASK32))
    pad = torch.zeros((tmr.DeviceIndex.RECORDS_PAD, 6), dtype=torch.int64)
    pad[:, 2:] = tmr.MASK32
    return tmr._i32_bits(torch.cat([torch.stack(cols, dim=1), pad]))


@pytest.mark.parametrize("chunk", [997, 4096, 1 << 21])
def test_chunked_records_and_words_equal_one_shot(chunk):
    """The records table and the packed words written ``chunk`` slots
    (positions) at a time equal the one-shot build, pad rows included,
    and the host's numpy words."""
    inp = inputs.make(CONFIG, dict(MIX, n_reads=1), SEED)
    gi, _ = _index(inp)
    ix = tmr.DeviceIndex.from_host(gi, "cpu")
    G = ix.genome.shape[0]
    gw, gn = tmr._packed_words(ix.genome, chunk=chunk)
    want_w, want_n = build_packed_words(ix.genome.numpy())
    np.testing.assert_array_equal(gw.numpy(), want_w.astype(np.int64))
    np.testing.assert_array_equal(gn.numpy(), want_n.astype(np.int64))
    assert torch.equal(gw, ix.gwords) and torch.equal(gn, ix.gnwords)
    # chunks shorter than the 15 bases past them
    short = ix.genome[:20]
    np.testing.assert_array_equal(
        tmr._packed_words(short, chunk=3)[1].numpy(),
        build_packed_words(short.numpy())[1].astype(np.int64))
    got = tmr.DeviceIndex._build_records(ix.genome, ix.pos_sorted, gw, gn,
                                         gi.k, chunk=chunk)
    want = _one_shot_records(ix.genome, ix.pos_sorted, gw, gn, gi.k)
    assert got.dtype == torch.int32 and got.shape == want.shape
    assert got.shape[0] == ix.pos_sorted.shape[0] + tmr.DeviceIndex.RECORDS_PAD
    assert torch.equal(got, want) and torch.equal(got, ix.pos_records)
    assert G == gi.genome.shape[0] + 1


def _revcomp(seq):
    s = np.asarray(seq, np.int64)
    return np.where(s < 4, 3 - s, s)[::-1]


def _recount(bucket_starts, rows, k, O):
    """(valid k-mers, their occurrences, those past O, min(nocc, O)
    summed) over read rows, from the LUT alone."""
    bs = np.asarray(bucket_starts, np.int64)
    out = np.zeros(4, np.int64)
    for seq in rows:
        if len(seq) < k:
            continue
        win = np.lib.stride_tricks.sliding_window_view(seq, k)
        ok = (win < 4).all(axis=1)
        w = win[ok]
        keys = (w << (2 * np.arange(k - 1, -1, -1))).sum(axis=1)
        nocc = bs[keys + 1] - bs[keys]
        out += [ok.sum(), nocc.sum(), (nocc > O).sum(),
                np.minimum(nocc, O).sum()]
    return out


def test_seed_counts_in_the_flat_tail_equal_a_recount():
    """One batch through map_batch: the seed-count words of its ``flat``
    tail, as ``unpack_batch`` counts them, equal a recount over the
    batch's reads and their reverse complements from ``bucket_starts``;
    the anchors kept are the valid ones of each strand row's top A."""
    inp = inputs.make(CONFIG, MIX, SEED)
    gi, params = _index(inp)
    m = tmr.Mapper(gi, params, device="cpu")
    L = 2048
    group = [r.seq for r in inp.pool if 1024 < len(r.seq) <= L]
    # and two reads cut from full-length repeat copies: seeds past O
    _, feats = sim.recipe_genome(
        [(n, ln) for n, ln in CONFIG["genome"]["contigs"]],
        CONFIG["genome_seed"], CONFIG["genome"]["repeat_families"])
    full = [f for f in feats if f.kind.endswith(":full")][:2]
    for f in full:
        c = inp.contigs[f.partner_start].seq
        group.append(np.asarray(c[f.start:f.start + 1500], np.int8))
    batch = m.batch_size_for(L)
    assert 2 <= len(group) <= batch
    arr = np.full((batch, L), 4, np.int8)
    lens = np.zeros(batch, np.int32)
    for i, s in enumerate(group):
        arr[i, :len(s)] = s
        lens[i] = len(s)
    pos, kw = m._batch_call_args(L)
    pb = tmr.map_batch(m.dev, torch.from_numpy(arr), torch.from_numpy(lens),
                       *pos, **kw)
    sink = metrics.MappingMetrics()
    prev, metrics._sink = metrics._sink, sink
    try:
        res = tmr.unpack_batch(pb)
    finally:
        metrics._sink = prev
    rows = [np.asarray(s, np.int64) for s in group]
    rows += [_revcomp(s) for s in group]
    want = _recount(gi.bucket_starts, rows, gi.k, kw["O"])
    got = [sink.counters[n] for n in tmr.SEED_COUNTERS]
    np.testing.assert_array_equal(got[:4], want)
    assert want[2] > 0 and want[0] > 1000
    A = min(kw["A"], L * kw["O"])
    assert got[4] == int(np.minimum(res.n_anchors, A).sum()) > 0


def test_index_spans_filled_once_per_from_host():
    """Each from_host leaves exactly its three set-up spans in
    INDEX_SPANS, replacing the last call's."""
    inp = inputs.make(CONFIG, dict(MIX, n_reads=1), SEED)
    gi, _ = _index(inp)
    names = {"index.upload", "index.words", "index.records"}
    tmr.DeviceIndex.from_host(gi, "cpu")
    first = dict(tmr.INDEX_SPANS)
    assert set(first) == names and all(v >= 0.0 for v in first.values())
    tmr.INDEX_SPANS["stale"] = 1.0
    tmr.DeviceIndex.from_host(gi, "cpu")
    assert set(tmr.INDEX_SPANS) == names


def test_records_fit_a_share_of_the_card(monkeypatch):
    """On CUDA the records are built when (slots + pad) x 24 bytes are
    at most an eighth of the card's memory, whatever RECORDS_MAX_SLOTS
    says; on the CPU up to RECORDS_MAX_SLOTS slots."""
    D = tmr.DeviceIndex
    n = 119_667_750

    class Props:
        total_memory = 8 * 24 * (n + D.RECORDS_PAD)

    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: Props)
    assert D.records_fit(n, "cuda") and not D.records_fit(n + 1, "cuda")
    assert n > D.RECORDS_MAX_SLOTS
    assert not D.records_fit(n, "cpu")
    assert D.records_fit(D.RECORDS_MAX_SLOTS, "cpu")

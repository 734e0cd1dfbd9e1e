"""The TAIR10 configuration and the anchor search's roofline count: the
contigs add up to the assembly, its k = 12 index is past the records cap
of 2^26 slots, and the bytes ``roofline/anchors.py`` counts are the same
whether K5 reads the records or the separate arrays."""

import numpy as np
import pytest

from benchmark import inputs, registry
from benchmark.roofline import anchors
from benchmark.tests import tiny

TAIR10_BASES = 119_667_750


def test_contigs_add_up_to_tair10():
    cfg = registry.config("athaliana_tair10")
    lens = [int(n) for _, n in cfg["genome"]["contigs"]]
    assert len(lens) == 7 and sum(lens) == TAIR10_BASES
    assert cfg["reduced"] == [] and cfg["mapper"] == {}
    assert cfg["genome_seed"] == TAIR10_BASES


def test_index_is_past_the_records_cap():
    """Every k-window of a contig is a slot (the bases are random, with
    no N): the slots outnumber 2^26 by 1.78x."""
    cfg = registry.config("athaliana_tair10")
    k = 12
    slots = sum(int(n) - k + 1 for _, n in cfg["genome"]["contigs"])
    assert slots > 1 << 26
    assert slots / (1 << 26) == pytest.approx(1.783, abs=1e-3)
    # 24-byte records at that size fit an eighth of an 80 GB card
    assert (slots + 1024) * 24 < 80e9 / 8


def test_anchor_bytes_equal_with_records_or_without():
    torch = pytest.importorskip("torch")
    from blasr_tpu_torch.index.genome import build_genome_index
    from blasr_tpu_torch.io.fasta import FastaRecord
    from blasr_tpu_torch.params import MappingParams
    from blasr_tpu_torch.pipeline import map_read as tmr

    inp = inputs.make(tiny.CONFIG, tiny.MIX, 4123000011)
    params = MappingParams(**inp.mapper).make_sane()
    gi = build_genome_index([FastaRecord(c.title, c.seq)
                             for c in inp.contigs], k=12)
    recs = [FastaRecord(r.name, r.seq) for r in inp.pool]
    counts = {}
    cap = tmr.DeviceIndex.RECORDS_MAX_SLOTS
    for name, limit in (("records", cap),
                        ("words", gi.pos_sorted.shape[0] - 1)):
        tmr.DeviceIndex.RECORDS_MAX_SLOTS = limit
        try:
            m = tmr.Mapper(gi, params, device=torch.device("cpu"))
        finally:
            tmr.DeviceIndex.RECORDS_MAX_SLOTS = cap
        assert (m.dev.pos_records is not None) == (name == "records")
        m.map_reads(recs)
        counts[name] = dict(m.metrics.counters)
    got = {k: anchors.nbytes(c) for k, c in counts.items()}
    assert got["records"] == got["words"] > 0
    c = counts["records"]
    assert got["records"] == (33 * c["anchor_seeds"]
                              + 32 * c["anchor_examined"]
                              + 16 * c["anchor_kept"])
    peak = {"hbm_bytes_per_s": 3.35e12}
    assert anchors.roofline_pct(c, got["records"] / 3.35e12, peak) == \
        pytest.approx(100.0)
    assert anchors.roofline_pct({}, 1.0, peak) is None
    assert np.isfinite(got["words"])

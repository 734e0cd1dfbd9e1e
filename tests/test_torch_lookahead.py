"""The port's Mapper pipelines its batches as the JAX Mapper does (four
dispatches in flight, each result's host copy started at its dispatch,
batches collected in order), and K1's slope check, which moved off the
host's path into the packed result, still raises.

* Ten reads of the small golden world at one read a batch (ten batches
  of bucket 1024), the fifth batch's first pass given a 64-pair
  traceback so that it overflows and takes the dense rerun at
  tb_cap = T: the port's alignments and ``MappingMetrics`` counters equal
  the JAX Mapper's, its batches are dispatched four ahead of their
  collection, and the dense rerun comes inside its batch's collection.
* Band offsets that step by 3 on active rows (``_band_offsets``
  replaced) make the Mapper raise the slope error on the CPU, at the
  batch's unpack, before anything of that batch is collected.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from blasr_tpu.index.genome import build_genome_index  # noqa: E402
from blasr_tpu.params import MappingParams, ShapeConfig  # noqa: E402
from blasr_tpu.pipeline import map_read as jmr  # noqa: E402
from blasr_tpu_torch.kernels.pallas_banded import SLOPE_ERROR  # noqa: E402
from blasr_tpu_torch.pipeline import map_read as tmr  # noqa: E402
from test_torch_mapper_modes import fields  # noqa: E402
from test_torch_stages import small_world  # noqa: E402
from torch_shared import TORCH_THREADS  # noqa: E402

torch.set_num_threads(TORCH_THREADS)

CFG = ShapeConfig(buckets=(1024,), batch_size=1)
N_READS = 10
SMALL_CAP = 4          # the first pass of this batch gets a 64-pair cap


def _traced(module, log):
    """Wrap ``module.map_batch`` and ``module.unpack_batch``: log each
    dispatch and unpack, and give the SMALL_CAP-th first pass a 64-pair
    traceback capacity."""
    inner_map, inner_unpack = module.map_batch, module.unpack_batch
    firsts = [0]

    def map_batch(*a, **kw):
        if kw.get("tb_cap", 0):
            log.append("rerun")
        else:
            log.append(f"dispatch {firsts[0]}")
            if firsts[0] == SMALL_CAP:
                kw["tb_cap"] = 64
            firsts[0] += 1
        return inner_map(*a, **kw)

    def unpack_batch(pb):
        log.append("unpack")
        return inner_unpack(pb)

    return map_batch, unpack_batch


# counters the port's Mapper keeps beside the JAX Mapper's: unpack_batch's
# span count (no collect.wait on the CPU, whose copies are done on return),
# K1's rows stored and needed and the anchor search's seed counts
PORT_COUNTERS = {"collect.unpack", "dp_rows_stored", "dp_rows_used",
                 *tmr.SEED_COUNTERS}


@pytest.fixture(scope="module")
def small():
    contigs, recs = small_world()
    return build_genome_index(contigs, k=12), recs[:N_READS]


def test_lookahead_matches_jax(small, monkeypatch):
    gi, recs = small
    p = MappingParams().make_sane()
    logs = {}
    runs = {}
    for name, module, make in (
            ("jax", jmr, lambda: jmr.Mapper(gi, p, CFG)),
            ("port", tmr, lambda: tmr.Mapper(gi, p, CFG, device="cpu"))):
        logs[name] = []
        mb, ub = _traced(module, logs[name])
        monkeypatch.setattr(module, "map_batch", mb)
        monkeypatch.setattr(module, "unpack_batch", ub)
        mapper = make()
        runs[name] = (mapper.map_reads(recs), dict(mapper.metrics.counters))
    (want, want_n), (got, got_n) = runs["jax"], runs["port"]
    assert fields(got) == fields(want) and sum(map(len, got)) >= N_READS
    # unpack_batch's span and K1's rows stored and needed are counters of
    # the port's own (pipeline/metrics.py); the JAX Mapper's are equal
    own = {k: got_n.pop(k) for k in list(got_n) if k not in want_n}
    assert set(own) == PORT_COUNTERS
    assert got_n == want_n and got_n["numReads"] >= N_READS
    log = logs["port"]
    assert own["collect.unpack"] == log.count("unpack")
    assert 0 < own["dp_rows_used"] <= own["dp_rows_stored"]
    assert 0 < own["anchor_examined"] <= own["anchor_slots"]
    assert own["anchor_capped"] <= own["anchor_seeds"]
    assert log == logs["jax"]
    # four dispatches in flight: the fifth is made before the first unpack
    assert log[:6] == [f"dispatch {i}" for i in range(5)] + ["unpack"]
    # the rerun comes at its batch's collection: right after its unpack,
    # once the batches behind it have been dispatched
    i = log.index("rerun")
    assert log[i - 1] == "unpack" and log.count("rerun") == 1
    assert log[:i].count("unpack") == SMALL_CAP + 1
    assert sum(e.startswith("dispatch") for e in log) >= 9


def test_slope_check_raises_at_unpack(small, monkeypatch):
    """Offsets that advance by 3 a row: the batch's packed fault word is
    set, and unpack_batch raises the error banded_align_cuda raised
    before the move; no alignment of the batch is collected."""
    gi, recs = small
    inner = tmr._band_offsets

    def steep(mq, mt, ws, L, W, w_b, *a, **kw):
        off = inner(mq, mt, ws, L, W, w_b, *a, **kw)
        r = torch.arange(L, dtype=off.dtype)
        return torch.minimum(off[:, :1] + 3 * r, torch.full_like(off, W))

    monkeypatch.setattr(tmr, "_band_offsets", steep)
    mapper = tmr.Mapper(gi, MappingParams().make_sane(), CFG, device="cpu")
    collected = []
    monkeypatch.setattr(mapper, "_collect_batch",
                        lambda *a: collected.append(a) or [[]])
    with pytest.raises(ValueError, match="advance by 0, 1 or 2"):
        mapper.map_reads(recs[:2])
    assert not collected
    # the flag itself: the last word of flat
    pos, kw = mapper._batch_call_args(1024)
    reads = np.full((1, 1024), 4, np.int8)
    reads[0, :len(recs[0].seq)] = recs[0].seq[:1024]
    pb = tmr.map_batch(mapper.dev, torch.from_numpy(reads),
                       torch.tensor([min(len(recs[0].seq), 1024)],
                                    dtype=torch.int32), *pos, **kw)
    assert pb.flat[-1] == 1
    with pytest.raises(ValueError) as e:
        tmr.unpack_batch(pb)
    assert str(e.value) == SLOPE_ERROR

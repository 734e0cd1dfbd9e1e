"""``occ_block_sample`` in the PyTorch port's plain anchor search against
the JAX package, on the two worlds of tests/test_anchor.py's block-mode
tests: a random genome whose seeds all fit in O slots (the window's base
is lo there, so the block layout equals the strided one), and a repeat of
eight copies with O = 3 (the base rotates with the read position and the
anchors spread over the copies).  Both with the fused records (one O-row
slice per position, its start clipped to the table's rows) and with the
word gathers; every Anchors field exactly.  K5's block mode meets the
edge inputs ``block-*`` of tests/torch_edge_cases.py in
tests/test_torch_cuda.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from blasr_tpu.index.genome import build_genome_index  # noqa: E402
from blasr_tpu.io.fasta import FastaRecord  # noqa: E402
from blasr_tpu.kernels import anchor as janchor  # noqa: E402
from blasr_tpu.pipeline import map_read as jmr  # noqa: E402
from blasr_tpu_torch.kernels import anchor as tanchor  # noqa: E402
from blasr_tpu_torch.pipeline import map_read as tmr  # noqa: E402
from torch_shared import TORCH_THREADS  # noqa: E402

torch.set_num_threads(TORCH_THREADS)

FIELDS = ("genome", "keys_sorted", "pos_sorted", "contig_starts",
          "contig_ends", "bucket_starts", "bucket_pairs", "gwords",
          "gnwords", "pos_records")
LOOKUP = ("bucket_starts", "bucket_pairs", "gwords", "gnwords",
          "pos_records")


def within_capacity():
    rng = np.random.default_rng(41)
    genome = rng.integers(0, 4, 4000).astype(np.int8)
    reads = [genome[s:s + 160].copy() for s in (100, 900, 2400)]
    return genome, reads, dict(occ_per_pos=8)


def repeat_copies():
    rng = np.random.default_rng(42)
    unit = rng.integers(0, 4, 300).astype(np.int8)
    parts = []
    for _ in range(8):
        parts.append(rng.integers(0, 4, 120).astype(np.int8))
        parts.append(unit.copy())
    return np.concatenate(parts), [unit[:260].copy()], dict(occ_per_pos=3)


WORLDS = {"within-capacity": within_capacity, "repeat-copies": repeat_copies}


def _run(world, records: bool, block: bool = True):
    genome, reads, extra = WORLDS[world]()
    jdev = jmr.DeviceIndex.from_host(
        build_genome_index([FastaRecord("g", genome)], k=10))
    arrs = {f: np.asarray(getattr(jdev, f)) for f in FIELDS
            if getattr(jdev, f) is not None}
    arrs["k"] = jdev.k
    drop = () if records else ("pos_records",)
    jix = jdev._replace(**{f: None for f in drop})
    tix = tmr.device_index_from_jax_arrays(
        {f: v for f, v in arrs.items() if f not in drop}, "cpu")
    L = -(-max(len(r) for r in reads) // 8) * 8
    arr = np.full((len(reads), L), 4, np.int8)
    lens = np.array([len(r) for r in reads], np.int32)
    for i, r in enumerate(reads):
        arr[i, :len(r)] = r
    kw = dict(k=10, max_anchors=128, anchor_ext=32, min_match=12,
              max_anchors_per_pos=1000, occ_block_sample=block, **extra)

    def call(mod, ix, a, n):
        return mod.find_anchors(ix.genome, ix.keys_sorted, ix.pos_sorted, a,
                                n, **kw,
                                **{f: getattr(ix, f) for f in LOOKUP})

    ja = call(janchor, jix, jnp.asarray(arr), jnp.asarray(lens))
    ta = call(tanchor, tix, torch.from_numpy(arr), torch.from_numpy(lens))
    return ja, ta


@pytest.mark.parametrize("records", [True, False],
                         ids=["records", "words"])
@pytest.mark.parametrize("world", list(WORLDS))
def test_block_sample_matches_jax(world, records):
    ja, ta = _run(world, records)
    for f in janchor.Anchors._fields:
        np.testing.assert_array_equal(np.asarray(getattr(ja, f)),
                                      getattr(ta, f).numpy(), err_msg=f)
    assert int(ta.n_total.min()) > 0
    if world == "within-capacity":
        # every seed fits in O slots: the strided layout gives the same
        _, strided = _run(world, records, block=False)
        for f in ("q", "t", "l", "valid", "n_total"):
            assert torch.equal(getattr(ta, f), getattr(strided, f)), f
    else:
        # the rotating window reaches at least six of the eight copies
        starts = [120 + 420 * c for c in range(8)]
        t = ta.t[0][ta.valid[0]].numpy()
        hit = {c for c, s in enumerate(starts) for x in t if s <= x < s + 300}
        assert len(hit) >= 6, sorted(hit)
        assert int(ta.n_clipped[0]) > 0

"""``--fastSDP`` (``sdp_occ=1``, K4) through the JAX Mapper and the
PyTorch port's on the CPU, on tests/test_sdp_guide.py's desert world (a
600 bp anchor desert ending in a 150 bp deletion, ``--sdpTupleSize 8``):
every alignment field identical, the read still aligned across the
desert as test_fast_sdp_still_correct asserts, and the device call got
``sdp_occ`` 1 (the option changes no alignment of this world).  The same
run goes through the card in chip_smoke.py (card == CPU)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from blasr_tpu.index import build_genome_index  # noqa: E402
from blasr_tpu.io.fasta import FastaRecord  # noqa: E402
from blasr_tpu.params import MappingParams, ShapeConfig  # noqa: E402
from blasr_tpu.sim import random_genome  # noqa: E402
from torch_options import map_both  # noqa: E402
from torch_shared import TORCH_THREADS  # noqa: E402

torch.set_num_threads(TORCH_THREADS)


@pytest.fixture(scope="module")
def world():
    """tests/test_sdp_guide.py::desert_world."""
    contigs = random_genome(20_000, seed=77)
    g = contigs[0].seq
    gi = build_genome_index(contigs, k=12)
    desert = g[3000:3600].copy()
    desert[::10] = (desert[::10] + 1) % 4
    read_seq = np.concatenate([g[2000:3000], desert, g[3750:5000]])
    return gi, FastaRecord("desert/1/0_%d" % len(read_seq), read_seq)


def test_fast_sdp_matches_jax(world):
    gi, read = world
    got, args, _ = map_both(
        gi, MappingParams(sdp_tuple_size=8, fast_sdp=True), [read],
        ShapeConfig(buckets=(4096,), batch_size=1))
    assert [(a["k_sdp"], a["sdp_occ"]) for a in args] == [(8, 1)]
    best = min(got[0], key=lambda a: a.score)
    assert best.tstart < 2010 and best.tend > 4990
    assert best.n_match > 2700

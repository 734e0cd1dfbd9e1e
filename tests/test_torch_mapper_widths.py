"""The port's Mapper at a band width other than 128 against the JAX
Mapper on the CPU.

At ``ShapeConfig(band_width=64)`` the JAX Mapper runs the XLA banded DP and
walk (its Pallas kernel takes band 128), and the port's runs its plain
versions on the CPU (K1-W and K2-W on the card, where chip_smoke.py holds
them to this run).  On eight reads of tests/test_golden.py's small world
every field of every Alignment must be equal."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from blasr_tpu.params import MappingParams, ShapeConfig  # noqa: E402
from blasr_tpu.pipeline import map_read as jmr  # noqa: E402
from blasr_tpu_torch.pipeline import map_read as tmr  # noqa: E402
from test_golden import make_small  # noqa: E402
from test_torch_mapper_modes import golden_world  # noqa: E402
from torch_shared import TORCH_THREADS  # noqa: E402

torch.set_num_threads(TORCH_THREADS)

CFG = ShapeConfig(buckets=(1024,), batch_size=8, band_width=64)


def same_field(name, a, b):
    if name == "cigar":
        assert list(a) == list(b), name
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), name
        for k in a:
            same_field(f"{name}.{k}", a[k], b[k])
    else:
        assert a == b, name


def test_band_64_matches_jax(tmp_path):
    gi, recs = golden_world(str(tmp_path), make_small)
    recs = recs[:8]
    p = MappingParams().make_sane()
    jax_mapper = jmr.Mapper(gi, p, CFG)
    port = tmr.Mapper(gi, p, CFG, device="cpu")
    assert not jax_mapper.use_pallas and not port.use_pallas
    want = jax_mapper.map_reads(recs)
    got = port.map_reads(recs)
    assert len(got) == len(want) == 8
    assert sum(len(a) for a in want) >= 6
    for alns_w, alns_g in zip(want, got):
        assert len(alns_g) == len(alns_w)
        for a, b in zip(alns_w, alns_g):
            assert a.band_width == 64
            for f in dataclasses.fields(a):
                same_field(f.name, getattr(a, f.name), getattr(b, f.name))

"""Chain and anchor options of tests/test_flags.py through the JAX Mapper
and the PyTorch port's on the CPU, on the small golden world
(tests/test_golden.py::make_small, its first five reads): every
alignment field identical in the two packages, and each option's effect
shown.

* ``--advanceExactMatches 5`` (test_flags.py:138, ``advance_exact``, K5)
  and ``--globalChainType 1`` (:216-223, ``global_chain``, K3) change the
  alignments of these reads.
* ``--nowarp`` (:216-223) is a no-op there and here: the same alignments
  and the same device call as the default run.
* ``--pvaltype 1`` / ``2`` (:40, ``p_value_type``, K3) and
  ``--advanceHalf`` (:91, the chain ``lookback``, K3) change nothing on
  any read of this world, so their effect is the argument the device call
  got, as test_flags.py reads ``Mapper._chain_lookback()``.

The same options run on the card in chip_smoke.py (card == CPU)."""

import pytest

torch = pytest.importorskip("torch")

from blasr_tpu.params import MappingParams, ShapeConfig  # noqa: E402
from test_golden import make_small  # noqa: E402
from test_torch_mapper_modes import fields, golden_world  # noqa: E402
from torch_options import changed, map_both  # noqa: E402
from torch_shared import TORCH_THREADS, shared  # noqa: E402

torch.set_num_threads(TORCH_THREADS)

CFG = ShapeConfig(buckets=(1024,), batch_size=5)

# option -> (MappingParams fields, the device-call arguments it changes,
# whether it changes these reads' alignments)
OPTIONS = {
    "advanceExactMatches": (dict(advance_exact_matches=5),
                            {"advance_exact": 5}, True),
    "globalChainType": (dict(global_chain_type=1),
                        {"global_chain": True}, True),
    "nowarp": (dict(warp=False), {}, False),
    "pvaltype1": (dict(p_value_type=1), {"p_value_type": 1}, None),
    "pvaltype2": (dict(p_value_type=2), {"p_value_type": 2}, None),
    # half of max_anchors (512)
    "advanceHalf": (dict(advance_half=True), {"lookback": 256}, None),
}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """``build_world``, once per test run (tests/torch_shared.py)."""
    return shared(tmp_path_factory, __file__, "world", build_world)


def build_world(d):
    """(index, the world's first five reads, the default run's port
    alignments and call arguments)."""
    gi, recs = golden_world(str(d), make_small)
    recs = recs[:5]
    base, base_args, _ = map_both(gi, MappingParams(), recs, CFG)
    assert all(base)
    return gi, recs, base, base_args


@pytest.mark.parametrize("name", list(OPTIONS))
def test_option_matches_jax(world, name):
    gi, recs, base, base_args = world
    kw, want_args, differs = OPTIONS[name]
    got, args, (jm, tm) = map_both(gi, MappingParams(**kw), recs, CFG)
    assert changed(args, base_args) == want_args
    if differs is not None:
        assert (fields(got) != fields(base)) == differs
    assert jm._chain_lookback() == tm._chain_lookback() == args[0]["lookback"]

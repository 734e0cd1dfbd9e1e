"""Helpers of the tests/test_torch_options_*.py files: each sends one
option of the JAX tests through the JAX package and the PyTorch port on
the CPU and holds the outputs equal, then shows the option's effect,
either as an output that differs from the world's default run or as the
argument the option gives the device call.

``recorded()`` records the keyword arguments of every ``map_batch`` call:
those each package's ``Mapper._batch_call_args`` builds (the same method
in both packages, held so by tests/test_torch_boundary.py) and those the
port's ``map_batch`` really receives."""

import contextlib

import pytest

from blasr_tpu.pipeline import map_read as jmr
from blasr_tpu_torch.pipeline import map_read as tmr
from test_torch_mapper_modes import fields

# the static arguments of map_batch that a mapping option can change
OPTION_KWARGS = ("O", "A", "C", "k_sdp", "sdp_occ", "p_value_type",
                 "lookback", "global_chain", "aggressive_cut",
                 "advance_exact", "full_widen", "cand_drift")


@contextlib.contextmanager
def recorded():
    """``{"jax": [...], "port": [...], "map_batch": [...]}``: the kwargs
    of each package's map_batch calls in call order, and the kwargs the
    port's map_batch got."""
    calls = {"jax": [], "port": [], "map_batch": []}

    def wrap(cls, key):
        orig = cls._batch_call_args

        def rec(self, L, tb_cap=0):
            pos, kw = orig(self, L, tb_cap)
            calls[key].append(dict(kw))
            return pos, kw
        return rec

    orig_mb = tmr.map_batch

    def map_batch(*args, **kw):
        calls["map_batch"].append(dict(kw))
        return orig_mb(*args, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmr.Mapper, "_batch_call_args", wrap(jmr.Mapper, "jax"))
        mp.setattr(tmr.Mapper, "_batch_call_args", wrap(tmr.Mapper, "port"))
        mp.setattr(tmr, "map_batch", map_batch)
        yield calls


def option_args(calls):
    """The option arguments of each distinct map_batch call of one run,
    in call order; the same in both packages and what the port's
    map_batch got."""
    def distinct(kws):
        return list(dict.fromkeys(tuple((k, kw[k]) for k in OPTION_KWARGS)
                                  for kw in kws))
    got = distinct(calls["port"])
    assert distinct(calls["jax"]) == got
    assert distinct(calls["map_batch"]) == got
    return [dict(t) for t in got]


def map_both(gi, params, recs, cfg):
    """Map ``recs`` with the JAX Mapper and the port's (on the CPU) under
    ``params`` and ``cfg``; assert every alignment field equal.  Returns
    (the port's alignments, the option arguments of the run's calls, the
    JAX and port Mappers)."""
    p = params.make_sane()
    with recorded() as calls:
        jm = jmr.Mapper(gi, p, cfg)
        want = jm.map_reads(recs)
        tm = tmr.Mapper(gi, p, cfg, device="cpu")
        got = tm.map_reads(recs)
    assert fields(got) == fields(want)
    return got, option_args(calls), (jm, tm)


def changed(args, base):
    """The option arguments of a run's first call that differ from the
    default run's first call."""
    return {k: v for k, v in args[0].items() if base[0][k] != v}


def drop_pg(text):
    """SAM text without its @PG line (it carries the command line: the
    --out path and --device), as tests/test_torch_golden.py compares."""
    return "".join(line for line in text.splitlines(keepends=True)
                   if not line.startswith("@PG"))


def cli_both(argv, out):
    """Run ``argv`` through the JAX CLI (writing ``out``.jax) and the
    port's (``--device cpu``, writing ``out``); assert both exit 0 and
    their outputs are byte-identical (SAM without @PG).  Returns the
    port's output text."""
    from blasr_tpu.cli.blasr import run as jax_run
    from blasr_tpu_torch.cli.blasr import run as port_run
    out = str(out)
    assert jax_run(argv + ["--out", out + ".jax"]) == 0
    assert port_run(argv + ["--out", out, "--device", "cpu"]) == 0
    want, got = open(out + ".jax").read(), open(out).read()
    assert drop_pg(got) == drop_pg(want)
    return got

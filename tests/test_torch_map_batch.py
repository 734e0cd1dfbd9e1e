"""map_batch of the PyTorch port against the JAX package: the packed
``flat`` result buffer (every column, the cluster list and the traceback
pairs) must be bit-identical for a bucket-512 batch of the golden small
world, fed the same device index arrays."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from blasr_tpu.index.genome import build_genome_index  # noqa: E402
from blasr_tpu.params import MappingParams  # noqa: E402
from blasr_tpu.pipeline import map_read as jmr  # noqa: E402
from blasr_tpu_torch.pipeline import map_read as tmr  # noqa: E402
from test_torch_stages import jax_index_arrays, small_world  # noqa: E402

torch.set_num_threads(2)


def test_map_batch_flat_matches_jax():
    contigs, recs = small_world()
    gi = build_genome_index(contigs, k=12)
    params = MappingParams().make_sane()
    jm = jmr.Mapper(gi, params)
    L = 512
    batch = jm.batch_size_for(L)
    group = [r for r in recs if len(r.seq) <= L][:batch]
    assert len(group) >= 3
    arr = np.full((batch, L), 4, np.int8)
    lens = np.zeros(batch, np.int32)
    for i, r in enumerate(group):
        arr[i, :len(r.seq)] = r.seq
        lens[i] = len(r.seq)
    pos, kw = jm._batch_call_args(L)
    want = jmr.map_batch(jm.dev, jnp.asarray(arr), jnp.asarray(lens),
                         *pos, **kw)

    tm = tmr.Mapper(gi, params, device="cpu",
                    dev=tmr.device_index_from_jax_arrays(
                        jax_index_arrays(jm.dev), "cpu"))
    tpos, tkw = tm._batch_call_args(L)
    got = tmr.map_batch(tm.dev, torch.from_numpy(arr),
                        torch.from_numpy(lens), *tpos, **tkw)
    w = np.asarray(want.flat)
    g = got.flat.numpy()
    assert w.dtype == g.dtype and w.shape == g.shape
    res = tmr.unpack_batch(got)
    assert res.valid.any() and (res.dp_slot >= 0).any()
    np.testing.assert_array_equal(w, g)

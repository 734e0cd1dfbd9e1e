"""One CUDA graph per static shape of :func:`map_batch`, replayed on every
dispatch: the port's counterpart of the JAX package's jit cache, which
compiles ``map_batch`` once per bucket shape
(``blasr_tpu/pipeline/map_read.py:32-34, 400-412``).

:func:`dispatch` is how :meth:`Mapper._run_bucket` runs a batch.  On CUDA
tensors it looks the call's :func:`graph_key` up in the cache of its
:class:`DeviceIndex`, captures the whole of ``map_batch`` at the key's
first dispatch (:func:`capture`) and replays that graph from then on
(:meth:`BatchGraph.replay`).  Eager dispatch stays the reference: on CPU
tensors, and on CUDA inside :func:`eager_dispatch`, :func:`dispatch` calls
``map_batch`` itself.  A capture that fails raises; nothing falls back to
eager dispatch.

The cache of an index is shared by every Mapper on it (the retry Mappers
of ``Mapper._expanded`` are new objects on the same index), its graphs
share one memory pool (their replays run in order on one stream), and it
is dropped with the index: a ``weakref.finalize`` on the index's genome
tensor.  Since the pool is shared, the device tensors a replay returns are
valid until the next replay on the same index; :func:`map_read.start_fetch`
queues their copy to the host before that.
"""

from __future__ import annotations

import contextlib
import time
import weakref
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from blasr_tpu_torch.kernels import cuda_ops
from blasr_tpu_torch.pipeline.metrics import count

# map_batch passes run through dispatch(): each replay, each eager call and
# the eager warm-up before a capture is one pass ("dense_reruns" at
# tb_cap > 0), so every kernel's launches are a whole multiple of them;
# "captures" counts the graphs captured, "replays" the passes that were
# replays (on CUDA outside eager_dispatch, every pass but the warm-ups);
# "waited" the results the host collected before their copy had ended
# (map_read.unpack_batch)
DISPATCHES = {"batches": 0, "dense_reruns": 0, "captures": 0, "replays": 0,
              "waited": 0}
# one entry per capture: its L, batch, tb_cap, ms, the ms of the kernel
# load and eager pass before it (warmup_ms) and the pool bytes it took
CAPTURES: List[dict] = []

_eager = False


def reset_counts() -> None:
    for k in DISPATCHES:
        DISPATCHES[k] = 0
    CAPTURES.clear()


@contextlib.contextmanager
def eager_dispatch():
    """Inside this context :func:`dispatch` runs ``map_batch`` eagerly on
    CUDA too (the counterpart of ``jax.disable_jit()``): the reference the
    graphs are held to."""
    global _eager
    prev = _eager
    _eager = True
    try:
        yield
    finally:
        _eager = prev


def graph_key(index, batch: int, pos, kw) -> tuple:
    """The cache key of a map_batch call: the identity of every field of
    the index, the batch size, the values of ``Mapper._batch_call_args``'s
    positional arguments (matrix, gap costs, thresholds) and every static
    keyword, the key the JAX ``Mapper.warmup`` builds."""
    submat, gaps, *scalars = pos
    return (tuple(v if isinstance(v, int) else id(v) for v in index), batch,
            tuple(np.asarray(submat, np.float32).reshape(-1).tolist()),
            tuple(float(g) for g in gaps), tuple(float(x) for x in scalars),
            tuple(sorted(kw.items())))


class IndexGraphs:
    """The graphs captured on one index, by :func:`graph_key`, and their
    one memory pool."""

    def __init__(self):
        self.graphs: Dict[tuple, "BatchGraph"] = {}
        self.pool = None


_CACHES: Dict[int, IndexGraphs] = {}


def _drop(key: int) -> None:
    cache = _CACHES.pop(key, None)
    if cache is not None and cache.graphs:
        # a replay may still run: free its graph and pool after it
        torch.cuda.synchronize()


def cache_for(index) -> IndexGraphs:
    """The graph cache of ``index``, made at its first use and dropped when
    the index's genome tensor is freed."""
    key = id(index.genome)
    cache = _CACHES.get(key)
    if cache is None:
        cache = _CACHES[key] = IndexGraphs()
        weakref.finalize(index.genome, _drop, key)
    return cache


class _CaptureMarks:
    """StageTimer's stand-in during a capture: each stage mark becomes an
    event record node of the graph (an external event), so a replay's
    spans can be read after it."""

    def __init__(self):
        self.marks: List[tuple] = []

    def record(self, name) -> None:
        ev = torch.cuda.Event(enable_timing=True, external=True)
        ev.record()
        self.marks.append((name, ev))


class BatchGraph:
    """One captured ``map_batch``: static input buffers (reads int8 [B, L],
    lens int32 [B]; with QVs qv1/qv2 int32 [B, L] and the rescore row
    float32 [4]), the captured :class:`PackedBatch`, the kernel launches
    the graph holds (``cuda_ops.LAUNCHES`` keys) and K7's paths among them
    (``cuda_ops.MEMBER_PATHS`` keys), and its stage marks."""

    def __init__(self, graph, reads, lens, out, launches: Dict[str, int],
                 qv: Optional[Tuple] = None, qv_rescore=None, marks=(),
                 keep=(), member_paths: Optional[Dict[str, int]] = None,
                 indexed_walks: int = 0):
        self.graph = graph
        self.reads, self.lens = reads, lens
        self.qv, self.qv_rescore = qv, qv_rescore
        self.out = out
        self.launches = {k: n for k, n in launches.items() if n}
        self.member_paths = {k: n for k, n in (member_paths or {}).items()
                             if n}
        self.indexed_walks = indexed_walks
        self.marks = list(marks)
        self._keep = keep       # index tensors the graph reads

    def replay(self, reads, lens, qv=None, qv_rescore=None):
        """Copy the inputs into the static buffers and replay, all on the
        current stream; count the graph's launches.  The returned batch's
        device tensors (``ints``, ``ops``, ``clusters``, ``flat``) are the
        graph's own, in the index's pool: valid until the next replay on
        the index, which the stream orders after any copy queued behind
        this one (``start_fetch``)."""
        from blasr_tpu_torch.pipeline.map_read import StageTimer
        self.reads.copy_(reads, non_blocking=True)
        self.lens.copy_(lens, non_blocking=True)
        if self.qv is not None:
            for static, x in zip(self.qv, qv):
                static.copy_(x, non_blocking=True)
            self.qv_rescore.copy_(qv_rescore, non_blocking=True)
        self.graph.replay()
        for k, n in self.launches.items():
            cuda_ops.LAUNCHES[k] += n
        for k, n in self.member_paths.items():
            cuda_ops.MEMBER_PATHS[k] += n
        cuda_ops.INDEXED_WALKS += self.indexed_walks
        timer = StageTimer.active
        if timer is not None and self.marks:
            # the spans of this replay, read before the next one
            self.marks[-1][1].synchronize()
            timer.add(StageTimer.spans(self.marks))
        return self.out


def _map_batch(index, reads, lens, pos, kw, qv, qv_rescore):
    from blasr_tpu_torch.pipeline.map_read import map_batch
    DISPATCHES["dense_reruns" if kw.get("tb_cap") else "batches"] += 1
    if qv is None:
        return map_batch(index, reads, lens, *pos, **kw)
    return map_batch(index, reads, lens, *pos, qv1=qv[0], qv2=qv[1],
                     qv_rescore=qv_rescore, **kw)


def capture(index, reads, lens, pos, kw, qv=None,
            qv_rescore=None) -> BatchGraph:
    """Capture ``map_batch`` on static copies of the given inputs, after one
    eager pass on them (every kernel and library routine loaded before the
    capture; it counts as a pass).  The graph's allocations come from the
    index's pool.  Records the capture's ms, the warm-up's and the bytes
    the pool grew by in :data:`CAPTURES`."""
    from blasr_tpu_torch.pipeline.map_read import StageTimer
    dev = reads.device
    t_warm = time.perf_counter()
    cuda_ops._load(dev)
    s_reads, s_lens = reads.clone(), lens.clone()
    s_qv = s_rescore = None
    if qv is not None:
        s_qv = tuple(q.clone() for q in qv)
        s_rescore = qv_rescore.clone()
    _map_batch(index, s_reads, s_lens, pos, kw, s_qv, s_rescore)
    cache = cache_for(index)
    if cache.pool is None:
        cache.pool = torch.cuda.graph_pool_handle()
    torch.cuda.synchronize(dev)
    warmup_ms = 1e3 * (time.perf_counter() - t_warm)
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved(dev)
    before = dict(cuda_ops.LAUNCHES)
    paths_before = dict(cuda_ops.MEMBER_PATHS)
    walks_before = cuda_ops.INDEXED_WALKS
    marks = _CaptureMarks()
    timer, StageTimer.active = StageTimer.active, marks
    graph = torch.cuda.CUDAGraph()
    t0 = time.perf_counter()
    try:
        with torch.cuda.graph(graph, pool=cache.pool):
            out = _map_batch(index, s_reads, s_lens, pos, kw, s_qv,
                             s_rescore)
    finally:
        StageTimer.active = timer
        launches = {k: cuda_ops.LAUNCHES[k] - before[k] for k in before}
        paths = {k: cuda_ops.MEMBER_PATHS[k] - paths_before[k]
                 for k in paths_before}
        walks = cuda_ops.INDEXED_WALKS - walks_before
        # the capture recorded those launches; replays run them
        cuda_ops.LAUNCHES.update(before)
        cuda_ops.MEMBER_PATHS.update(paths_before)
        cuda_ops.INDEXED_WALKS = walks_before
        # the warm-up pass above is the dispatch's; the capture is not one
        DISPATCHES["dense_reruns" if kw.get("tb_cap") else "batches"] -= 1
    ms = 1e3 * (time.perf_counter() - t0)
    DISPATCHES["captures"] += 1
    CAPTURES.append(dict(
        L=kw["L"], batch=int(reads.shape[0]), tb_cap=kw.get("tb_cap", 0),
        use_qv=bool(kw.get("use_qv")), use_hp=bool(kw.get("use_hp")),
        ms=ms, warmup_ms=warmup_ms,
        pool_bytes=torch.cuda.memory_reserved(dev) - reserved))
    keep = tuple(v for v in index
                 if isinstance(v, torch.Tensor) and v is not index.genome)
    return BatchGraph(graph, s_reads, s_lens, out, launches, s_qv, s_rescore,
                      marks.marks, keep, paths, walks)


def prepare(index, reads, lens, pos, kw, qv=None,
            qv_rescore=None) -> BatchGraph:
    """The call's graph from the index's cache, captured on these inputs
    if it is not there (``Mapper.warmup`` and :func:`dispatch`)."""
    cache = cache_for(index)
    key = graph_key(index, int(reads.shape[0]), pos, kw)
    graph = cache.graphs.get(key)
    if graph is None:
        graph = cache.graphs[key] = capture(index, reads, lens, pos, kw, qv,
                                            qv_rescore)
    return graph


def dispatch(index, reads, lens, pos, kw, qv=None, qv_rescore=None):
    """``map_batch(index, reads, lens, *pos, **kw)`` (with ``qv`` = (qv1,
    qv2) and ``qv_rescore`` in QV mode): a replay of the call's graph on
    CUDA, captured at the key's first dispatch; an eager call on the CPU
    or inside :func:`eager_dispatch`.  On CUDA the pass's indexed walks
    (``cuda_ops.INDEXED_WALKS``) go to the counter ``indexed_walks``."""
    if reads.device.type != "cuda":
        return _map_batch(index, reads, lens, pos, kw, qv, qv_rescore)
    walks = cuda_ops.INDEXED_WALKS
    if _eager:
        out = _map_batch(index, reads, lens, pos, kw, qv, qv_rescore)
    else:
        graph = prepare(index, reads, lens, pos, kw, qv, qv_rescore)
        DISPATCHES["dense_reruns" if kw.get("tb_cap") else "batches"] += 1
        DISPATCHES["replays"] += 1
        out = graph.replay(reads, lens, qv, qv_rescore)
    count("indexed_walks", cuda_ops.INDEXED_WALKS - walks)
    return out

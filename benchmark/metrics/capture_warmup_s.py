"""The eager warm-up before each CUDA graph capture of the warm call
(``graphs.CAPTURES``' ``warmup_ms``: the kernel library's load and one
eager ``map_batch`` pass on the capture's inputs, then a sync), summed
over the graphs the pool's buckets needed: the part of the warm call
that ``capture_s`` leaves out."""

UNIT = "s"
LAYER = "graphs (pipeline/graphs.py)"
MOVES = "setup_s"


def read(ctx):
    caps = [c for c in ctx["captures"] if "warmup_ms" in c]
    if not caps:
        return None
    return sum(c["warmup_ms"] for c in caps) / 1e3

"""The CUDA graph captures of the warm call: ``graphs.CAPTURES``' ms
summed over the graphs the pool's buckets needed (their eager warm-up
passes not included)."""

UNIT = "s"
LAYER = "graphs (pipeline/graphs.py)"
MOVES = "setup_s"


def read(ctx):
    caps = ctx["captures"]
    if not caps:
        return None
    return sum(c["ms"] for c in caps) / 1e3

"""Device time of map_batch's ``traceback`` stage, the traceback compaction
and the run-length traceback (K2), per million read bases mapped: the
program's ``StageTimer`` (event nodes inside each CUDA graph, so device
time only) summed over the StageTimer half of the window."""

UNIT = "ms/Mbase"
LAYER = "traceback (K2, kernels/banded.py)"
MOVES = "device_s_per_gbase"
STAGE = "traceback"


def read(ctx):
    st = ctx.get("staged")
    if not st or not st["bases"] or not st["stages_ms"].get(STAGE):
        return None
    return st["stages_ms"][STAGE] / (st["bases"] / 1e6)

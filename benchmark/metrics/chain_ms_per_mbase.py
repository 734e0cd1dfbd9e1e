"""Device time of map_batch's ``chain`` stage, the chain DP and selection
(K3, twice) and the chain members (K7), per million read bases mapped:
the program's ``StageTimer`` (event nodes inside each CUDA graph, so
device time only) summed over the StageTimer half of the window."""

UNIT = "ms/Mbase"
LAYER = "chain (K3, K7, kernels/chain.py)"
MOVES = "device_s_per_gbase"
STAGE = "chain"


def read(ctx):
    st = ctx.get("staged")
    if not st or not st["bases"] or not st["stages_ms"].get(STAGE):
        return None
    return st["stages_ms"][STAGE] / (st["bases"] / 1e6)

"""Device time of map_batch's ``banded_dp`` stage, the guided banded DP
(K1, K1-QV or K1-HP) and its slope flag, per million read bases mapped:
the program's ``StageTimer`` (event nodes inside each CUDA graph, so
device time only) summed over the StageTimer half of the window."""

UNIT = "ms/Mbase"
LAYER = "banded DP (K1 family, kernels/banded.py, kernels/cuda_ops.py)"
MOVES = "device_s_per_gbase"
STAGE = "banded_dp"


def read(ctx):
    st = ctx.get("staged")
    if not st or not st["bases"] or not st["stages_ms"].get(STAGE):
        return None
    return st["stages_ms"][STAGE] / (st["bases"] / 1e6)

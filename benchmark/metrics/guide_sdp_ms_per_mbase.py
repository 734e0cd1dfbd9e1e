"""Device time of map_batch's ``guide_sdp`` stage, the candidate windows,
the band offsets (K6, twice), the SDP window pass (K4) and the plain
torch between them, per million read bases mapped: the program's
``StageTimer`` (event nodes inside each CUDA graph, so device time only)
summed over the StageTimer half of the window."""

UNIT = "ms/Mbase"
LAYER = "guide/SDP (K6, K4, kernels/sdp.py, plain torch)"
MOVES = "device_s_per_gbase"
STAGE = "guide_sdp"


def read(ctx):
    st = ctx.get("staged")
    if not st or not st["bases"] or not st["stages_ms"].get(STAGE):
        return None
    return st["stages_ms"][STAGE] / (st["bases"] / 1e6)

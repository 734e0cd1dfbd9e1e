"""Device time of map_batch's ``pack`` stage, the packing of the batch's
result into one int32 buffer, per million read bases mapped: the
program's ``StageTimer`` (event nodes inside each CUDA graph, so device
time only) summed over the StageTimer half of the window."""

UNIT = "ms/Mbase"
LAYER = "pack (the map_batch tail)"
MOVES = "device_s_per_gbase"
STAGE = "pack"


def read(ctx):
    st = ctx.get("staged")
    if not st or not st["bases"] or not st["stages_ms"].get(STAGE):
        return None
    return st["stages_ms"][STAGE] / (st["bases"] / 1e6)

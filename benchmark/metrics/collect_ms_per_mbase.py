"""The host's collection of the batches' alignments (``MappingMetrics``
clock ``collectAlignments``: unpacking, the dense reruns it waits for,
CIGAR assembly, pruning) per million read bases mapped, in the
StageTimer half of the window."""

UNIT = "ms/Mbase"
LAYER = "Mapper (pipeline/map_read.py::Mapper, pipeline/select.py)"
MOVES = "device_s_per_gbase"


def read(ctx):
    st = ctx.get("staged")
    if not st or not st["bases"] or "collectAlignments" not in st["clocks"]:
        return None
    return 1e3 * st["clocks"]["collectAlignments"] / (st["bases"] / 1e6)

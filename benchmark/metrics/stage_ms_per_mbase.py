"""The Mapper's staging of a batch (``_run_bucket``'s ``stage``: the
reads packed into [B, L], their pinned uploads enqueued), the
program's span ``map.stage``,
per million read bases mapped, in the StageTimer half of the window
(``MappingMetrics`` clocks)."""

from benchmark.program_spans import span_ms_per_mbase

UNIT = "ms/Mbase"
LAYER = "Mapper (pipeline/map_read.py::Mapper, pipeline/select.py)"
MOVES = "device_s_per_gbase"
SPAN = "map.stage"


def read(ctx):
    return span_ms_per_mbase(ctx, SPAN)

"""The Mapper's survey of a batch's candidates
(``Mapper._collect_batch`` up to the CIGARs: the contig lookup, one
Alignment a surviving candidate, pruning, the significance gate),
the program's span ``collect.survey``,
per million read bases mapped, in the StageTimer half of the window
(``MappingMetrics`` clocks)."""

from benchmark.program_spans import span_ms_per_mbase

UNIT = "ms/Mbase"
LAYER = "Mapper (pipeline/map_read.py::Mapper, pipeline/select.py)"
MOVES = "device_s_per_gbase"
SPAN = "collect.survey"


def read(ctx):
    return span_ms_per_mbase(ctx, SPAN)

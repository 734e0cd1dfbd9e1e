"""The Mapper's CIGAR assembly of a batch's kept alignments
(``Mapper._materialize_cigars``, one native call a batch), the
program's span ``collect.cigars``,
per million read bases mapped, in the StageTimer half of the window
(``MappingMetrics`` clocks)."""

from benchmark.program_spans import span_ms_per_mbase

UNIT = "ms/Mbase"
LAYER = "Mapper (pipeline/map_read.py::Mapper, pipeline/select.py)"
MOVES = "device_s_per_gbase"
SPAN = "collect.cigars"


def read(ctx):
    return span_ms_per_mbase(ctx, SPAN)

"""The CLI output's choice of the printed alignments (``emit``'s pass
1 around ``zmw_rand_int`` and ``select_alignments``: the filters,
the hit policy), the program's span ``emit.select`` (one a read),
per million read bases mapped, in the StageTimer half of the window
(``MappingMetrics`` clocks)."""

from benchmark.program_spans import span_ms_per_mbase

UNIT = "ms/Mbase"
LAYER = "CLI output (cli/blasr.py::emit, pipeline/select.py, io/formats.py)"
MOVES = "device_s_per_gbase"
SPAN = "emit.select"


def read(ctx):
    return span_ms_per_mbase(ctx, SPAN)

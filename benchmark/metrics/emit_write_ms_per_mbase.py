"""The CLI output's writing (``emit``'s pass 2: the SAM links and the
format writers, here the m1 lines), the program's span
``emit.write``,
per million read bases mapped, in the StageTimer half of the window
(``MappingMetrics`` clocks)."""

from benchmark.program_spans import span_ms_per_mbase

UNIT = "ms/Mbase"
LAYER = "CLI output (cli/blasr.py::emit, pipeline/select.py, io/formats.py)"
MOVES = "device_s_per_gbase"
SPAN = "emit.write"


def read(ctx):
    return span_ms_per_mbase(ctx, SPAN)

"""The CLI output's mapQVs (``cli/blasr.py::emit``'s pass 1 around
``store_map_qvs``: the overlap groups and each multi-member group's
likelihood rescore), the program's span ``emit.map_qv`` (one a read),
per million read bases mapped, in the StageTimer half of the window
(``MappingMetrics`` clocks)."""

from benchmark.program_spans import span_ms_per_mbase

UNIT = "ms/Mbase"
LAYER = "CLI output (cli/blasr.py::emit, pipeline/select.py, io/formats.py)"
MOVES = "device_s_per_gbase"
SPAN = "emit.map_qv"


def read(ctx):
    return span_ms_per_mbase(ctx, SPAN)

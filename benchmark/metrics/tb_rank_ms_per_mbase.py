"""Device time of map_batch's ``traceback``'s first part, the rank of the
DP rows within each read ([n_rows, n_rows]) and the choice of the traced
rows, per million read bases mapped: the program's ``StageTimer`` part
``traceback.rank`` (event nodes inside each CUDA graph, so device time
only) summed over the StageTimer half of the window."""

from benchmark.program_spans import part_ms_per_mbase

UNIT = "ms/Mbase"
LAYER = "traceback (K2, kernels/banded.py)"
MOVES = "device_s_per_gbase"
STAGE = "traceback.rank"


def read(ctx):
    return part_ms_per_mbase(ctx, STAGE)

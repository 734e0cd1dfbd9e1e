"""Device time of map_batch's ``traceback``'s last part, the run-length
traceback walk (K2), per million read bases mapped: the program's
``StageTimer`` part ``traceback.k2`` (event nodes inside each CUDA
graph, so device time only) summed over the StageTimer half of the
window."""

from benchmark.program_spans import part_ms_per_mbase

UNIT = "ms/Mbase"
LAYER = "traceback (K2, kernels/banded.py)"
MOVES = "device_s_per_gbase"
STAGE = "traceback.k2"


def read(ctx):
    return part_ms_per_mbase(ctx, STAGE)

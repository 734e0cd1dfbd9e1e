"""Device time of map_batch's ``traceback``'s second part, the traced rows'
gathers: K1's cell words ``tbbits[tb_rows]`` and their scores, offsets
and bounds, per million read bases mapped: the program's ``StageTimer``
part ``traceback.gather`` (event nodes inside each CUDA graph, so device
time only) summed over the StageTimer half of the window."""

from benchmark.program_spans import part_ms_per_mbase

UNIT = "ms/Mbase"
LAYER = "traceback (K2, kernels/banded.py)"
MOVES = "device_s_per_gbase"
STAGE = "traceback.gather"


def read(ctx):
    return part_ms_per_mbase(ctx, STAGE)

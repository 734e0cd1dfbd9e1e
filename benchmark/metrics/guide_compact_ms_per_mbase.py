"""Device time of map_batch's ``guide_sdp``'s first part, the candidate
compaction (the DP rows' rank and order), the widening toward the read
ends and the contig lookup, per million read bases mapped: the program's
``StageTimer`` part ``guide_sdp.compact`` (event nodes inside each CUDA
graph, so device time only) summed over the StageTimer half of the
window."""

from benchmark.program_spans import part_ms_per_mbase

UNIT = "ms/Mbase"
LAYER = "guide/SDP (K6, K4, kernels/sdp.py, plain torch)"
MOVES = "device_s_per_gbase"
STAGE = "guide_sdp.compact"


def read(ctx):
    return part_ms_per_mbase(ctx, STAGE)

"""Device time of map_batch's ``guide_sdp``'s last part, the short-tuple
SDP pass: the read k-mer keys, K4, the second band offsets (K6) and
their scatter into the offsets (absent where the options run no such
pass), per million read bases mapped: the program's ``StageTimer`` part
``guide_sdp.sdp`` (event nodes inside each CUDA graph, so device time
only) summed over the StageTimer half of the window."""

from benchmark.program_spans import part_ms_per_mbase

UNIT = "ms/Mbase"
LAYER = "guide/SDP (K6, K4, kernels/sdp.py, plain torch)"
MOVES = "device_s_per_gbase"
STAGE = "guide_sdp.sdp"


def read(ctx):
    return part_ms_per_mbase(ctx, STAGE)

"""Device time of map_batch's ``guide_sdp``'s third part, the fragment
arrays (``frag_diag``, ``frag_ok``), the guide's members and the first
band offsets (K6), per million read bases mapped: the program's
``StageTimer`` part ``guide_sdp.fragments`` (event nodes inside each
CUDA graph, so device time only) summed over the StageTimer half of the
window."""

from benchmark.program_spans import part_ms_per_mbase

UNIT = "ms/Mbase"
LAYER = "guide/SDP (K6, K4, kernels/sdp.py, plain torch)"
MOVES = "device_s_per_gbase"
STAGE = "guide_sdp.fragments"


def read(ctx):
    return part_ms_per_mbase(ctx, STAGE)

"""The banded DP's share of its roofline: the least time the chip could
take for the DP's cells (``roofline/banded_dp.py``: the larger of the
operations over 67 TFLOP/s, float32 outside the tensor cores, and the
bytes over 3.35 TB/s) over the ``banded_dp`` stage's device time, both
over the StageTimer half of the window.  The cells are the port's
``MappingMetrics`` counter ``cells``: the query span times the band of
every valid candidate."""

from benchmark.roofline import banded_dp

UNIT = "%"
LAYER = "banded DP (K1 family, kernels/banded.py, kernels/cuda_ops.py)"
MOVES = "device_s_per_gbase"


def read(ctx):
    st, peak = ctx.get("staged"), ctx.get("peaks")
    if not st or peak is None:
        return None
    ms = st["stages_ms"].get("banded_dp", 0.0)
    return banded_dp.roofline_pct(st["counters"].get("cells", 0),
                                  ctx["mode"], ms / 1e3, peak,
                                  ctx["band_width"])

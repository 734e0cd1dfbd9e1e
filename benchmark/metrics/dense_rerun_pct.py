"""The Mapper's dense reruns (a batch mapped again at t_max = T because
an overflowed traceback reached the output) as a share of its batches,
``graphs.DISPATCHES``, in the StageTimer half of the window."""

UNIT = "%"
LAYER = "Mapper (pipeline/map_read.py::Mapper, pipeline/select.py)"
MOVES = "device_s_per_gbase"


def read(ctx):
    st = ctx.get("staged")
    if not st or not st["dispatches"]["batches"]:
        return None
    d = st["dispatches"]
    return 100.0 * d["dense_reruns"] / d["batches"]

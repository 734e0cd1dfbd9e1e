"""The read bases of every call completed in the profiled half of a traced
run's window, over the time from that half's start to the end of its last
completed call (``run.bases_per_s``): the job's rate, which the host
paces (a call is ~80% host work), read under torch.profiler."""

UNIT = "bases/s"
LAYER = "job (benchmark/run.py: Mapper.map_reads, then cli/blasr.py::emit, call after call)"
MOVES = "device_s_per_gbase"


def read(ctx):
    prof = ctx.get("profiled")
    if not prof or not prof.get("bases_per_s"):
        return None
    return prof["bases_per_s"]

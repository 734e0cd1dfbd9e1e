"""The device index's set-up on the card: the three spans of
``DeviceIndex.from_host`` (``pipeline/map_read.py::INDEX_SPANS``: the
upload, the packed words, the records table, each ended by a device
sync) summed, in seconds; the part of ``index_build_s`` after the host's
k-mer index."""

UNIT = "s"
LAYER = "index (index/genome.py, DeviceIndex.from_host)"
MOVES = "setup_s"


def read(ctx):
    from blasr_tpu_torch.pipeline import map_read
    spans = getattr(map_read, "INDEX_SPANS", None)
    if not spans:
        return None
    return sum(spans.values())

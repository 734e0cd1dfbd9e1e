"""Set-up's genome index: the host's k-mer index of the genome
(``index.genome.build_genome_index``) and the ``Mapper`` built on it,
whose ``DeviceIndex.from_host`` uploads it and derives the packed words
and records on the card; the benchmark's host clock around both."""

UNIT = "s"
LAYER = "index (index/genome.py, DeviceIndex.from_host)"
MOVES = "setup_s"


def read(ctx):
    return ctx["setup"].get("index")

# Copied from blasr_tpu/index/__init__.py; only the imports differ (blasr_tpu -> blasr_tpu_torch).
from blasr_tpu_torch.index.genome import GenomeIndex, SeqDB, build_genome_index  # noqa: F401
from blasr_tpu_torch.index.suffix_array import build_suffix_array  # noqa: F401

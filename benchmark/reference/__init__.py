"""The benchmark's plain reference: a frozen copy of the port's plain
PyTorch mapping path (``blasr_tpu_torch``'s CPU path, which the port's
tests hold every hand-written kernel to), taken into the benchmark so
that later changes to the port cannot move it.

It imports nothing of ``blasr_tpu_torch``: every module here is a copy
of the port module named in its first line, its imports pointed at this
package, each public kernel name calling its plain version on any device
(so it runs on the card's tensors without a kernel of the port), and the
departures each module's docstring lists: ``map_read.Mapper`` maps only
sampled batches of a call's first pass and names the reads the ambiguity
rescue would send on (``map_read``'s docstring), and ``banded.cost_dtype``
lets the lower-precision control hold the DP's costs in bfloat16.
"""

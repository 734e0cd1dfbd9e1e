# Frozen copy of blasr_tpu_torch/kernels/dispatch.py: the plain PyTorch path only,
# imports pointed inside benchmark/reference (see __init__.py).
"""``per_distinct_row``: a plain version run once per distinct row of its
batch, as in the port.  (The port's ``on_device``, which sends CUDA
tensors to its hand-written kernels, has no counterpart here: every
public name of this package calls its plain version, on any device.)
"""

from __future__ import annotations

from typing import Callable, TypeVar

import torch

T = TypeVar("T")


# the most elements a row of per_distinct_row's inputs may have to be
# hashed
DISTINCT_ROW_MAX = 1 << 16


def per_distinct_row(fn: Callable[..., T], *rows: torch.Tensor) -> T:
    """``fn(*rows)`` for a function whose output rows depend each on its
    own input rows only: ``fn`` runs once per distinct row (equal bits
    in every tensor) and each output row is copied to the rows that repeat
    it.  ``fn`` returns a tuple (or named tuple) of tensors with the
    inputs' leading dimension, or None in its place.  A plain version's
    work is its rows; a mapping batch's empty read slots and dropped
    candidates repeat one input, most of the rows of a batch of a few
    reads.  Rows are grouped by a hash of their bits, and every row is
    then checked equal to its group's first, so a collision only costs
    the saving.  Rows of more than ``DISTINCT_ROW_MAX`` elements (the
    ambiguity rescue's [N, L, L] fragment arrays) are not hashed: reading
    them twice costs about what ``fn`` does."""
    N = rows[0].shape[0]
    if 1 < N and sum(x[0].numel() for x in rows) <= DISTINCT_ROW_MAX:
        flat = [_bits(x).reshape(N, -1) for x in rows]
        gen = torch.Generator(device="cpu").manual_seed(0x5EED)
        h = torch.zeros(N, dtype=torch.int64, device=flat[0].device)
        for x in flat:
            w = torch.randint(1, 1 << 62, (x.shape[1],), generator=gen,
                              dtype=torch.int64).to(x.device) | 1
            h = h * 1000003 + (x * w).sum(dim=1)
        uniq, inverse = torch.unique(h, return_inverse=True)
        if uniq.shape[0] < N:
            first = torch.full((uniq.shape[0],), N, dtype=torch.int64,
                               device=h.device).scatter_reduce(
                0, inverse, torch.arange(N, device=h.device), "amin")
            rep = first[inverse]
            if all(bool((x == x[rep]).all()) for x in flat):
                out = fn(*(x[first] for x in rows))
                back = (None if x is None else x[inverse] for x in out)
                return (type(out)(*back) if hasattr(out, "_fields")
                        else type(out)(back))
    return fn(*rows)


def _bits(x: torch.Tensor) -> torch.Tensor:
    """``x`` as int64 values that are equal exactly where ``x``'s bits
    are (a float by its bit pattern, not its value)."""
    if x.is_floating_point():
        x = x.contiguous().view({2: torch.int16, 4: torch.int32,
                                 8: torch.int64}[x.element_size()])
    return x.to(torch.int64)

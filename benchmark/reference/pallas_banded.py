# Frozen copy of blasr_tpu_torch/kernels/pallas_banded.py: the plain PyTorch path only,
# imports pointed inside benchmark/reference (see __init__.py).
"""K1's entry (``banded_align_cuda``) and its slope limit: here the plain
forward pass, :func:`benchmark.reference.banded.banded_align`, on any
device; ``map_batch`` carries K1's slope fault as the port does.
"""

from __future__ import annotations

import torch

from benchmark.reference.banded import BandedResult, banded_align


SLOPE_ERROR = ("banded_align_cuda needs band offsets that advance by 0, 1 "
               "or 2 per row")


def slope_fault(offsets: torch.Tensor, qa: torch.Tensor,
                qb: torch.Tensor) -> torch.Tensor:
    """A bool scalar on the offsets' device: true where some active row
    (qa < r < qb) advances the band by other than 0, 1 or 2, the rows
    where K1's shift registers are used.  Computing it does not wait on
    the device."""
    s = offsets[:, 1:] - offsets[:, :-1]                     # s at row r+1
    r = torch.arange(1, offsets.shape[1], device=offsets.device)
    act = (r[None, :] > qa[:, None]) & (r[None, :] < qb[:, None])
    return (((s < 0) | (s > 2)) & act).any()


def banded_align_cuda(reads, windows, offsets, qa, qb, ta, tb, submat,
                      ins_open, ins_ext, del_open, del_ext, *,
                      w_b: int = 128, use_hp: bool = False, hp_open=0.0,
                      hp_ext=0.0, qv1=None, qv2=None,
                      slope_checked: bool = False) -> BandedResult:
    """Same contract as ``banded_align`` (forward pass in any of its
    modes), plus K1's slope limit at band width 128 (module docstring).
    A two-valued matrix runs the kernel's two-valued form, any other its
    GEN form.  On CUDA at band 128 the call checks the slope, which waits
    on the device, unless the caller did so already (``slope_checked``:
    ``map_batch`` computes :func:`slope_fault` and raises when its batch
    is unpacked); K1-W has no limit to check."""
    return banded_align(reads, windows, offsets, qa, qb, ta, tb, submat,
                        ins_open, ins_ext, del_open, del_ext, w_b=w_b,
                        use_hp=use_hp, hp_open=hp_open, hp_ext=hp_ext,
                        qv1=qv1, qv2=qv2)

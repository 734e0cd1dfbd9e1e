"""The banded DP on the card (port of ``blasr_tpu/kernels/pallas_banded.py``
and of the forms of ``blasr_tpu/kernels/banded.py::banded_align`` that the
Pallas kernel does not take).

``banded_align_cuda`` has ``banded_align``'s contract.  On CUDA tensors
at band width 128 it launches the hand-written kernel K1
(``csrc/banded_dp.cu``), whose band offset must advance by 0, 1 or 2 per
row, and at any other width K1-W (``csrc/banded_dp_wide.cu``), which takes
any offsets; each in the mode its arguments ask for: distance (K1), the
packed QV tracks ``qv1``/``qv2`` (K1-QV), the homopolymer-insertion band
``use_hp`` (K1-HP), each with a two-valued score matrix (match on the ACGT
diagonal, one mismatch value elsewhere) or, in its GEN form, any 5x5
matrix.  On CPU tensors it runs the plain version,
:func:`blasr_tpu_torch.kernels.banded.banded_align`.
"""

from __future__ import annotations

import numpy as np
import torch

from blasr_tpu_torch.kernels.banded import BandedResult, banded_align
from blasr_tpu_torch.kernels.dispatch import on_device


def slope_limit_offsets(offs: torch.Tensor, w_b: int) -> torch.Tensor:
    """Clamp a monotone band-offset path to per-row slope in {0, 1, 2}.
    offs: int [..., L]."""
    L = offs.shape[-1]
    r = torch.arange(L, dtype=offs.dtype, device=offs.device)
    offs = torch.cummax(offs, dim=-1).values
    return 2 * r + torch.cummin(offs - 2 * r, dim=-1).values


def two_valued(submat) -> bool:
    """True for a 5x5 matrix with one match value on the ACGT diagonal and
    one mismatch value everywhere else (N included): what K1's forms
    without GEN take (match and mismatch as two scalars)."""
    m5 = np.asarray(torch.as_tensor(submat).detach().cpu(),
                    dtype=np.float32).reshape(5, 5)
    return bool(np.all(np.diag(m5)[:4] == m5[0, 0])
                and np.all(m5[~np.eye(5, dtype=bool)] == m5[0, 1])
                and m5[4, 4] == m5[0, 1])


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


def check_slope(offsets: torch.Tensor, qa: torch.Tensor,
                qb: torch.Tensor) -> None:
    """Raise unless every active row advances the band by 0, 1 or 2
    (waits for :func:`slope_fault`)."""
    if bool(slope_fault(offsets, qa, qb)):
        raise ValueError(SLOPE_ERROR)


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
    def launch(ops):
        if w_b == ops.K1_WIDTH and not slope_checked:
            check_slope(offsets, qa, qb)
        m = np.asarray(torch.as_tensor(submat).detach().cpu(),
                       dtype=np.float32).reshape(25)
        return ops.banded_dp_launch(
            reads, windows, offsets, qa, qb, ta, tb,
            match=float(m[0]), mismatch=float(m[1]), ins_open=float(ins_open),
            ins_ext=float(ins_ext), del_open=float(del_open),
            del_ext=float(del_ext), qv1=qv1, qv2=qv2,
            submat=None if two_valued(m) else m, use_hp=use_hp,
            hp_open=float(hp_open), hp_ext=float(hp_ext), w_b=w_b)

    return on_device(
        "banded_align_cuda", reads.device,
        lambda: banded_align(reads, windows, offsets, qa, qb, ta, tb, submat,
                             ins_open, ins_ext, del_open, del_ext, w_b=w_b,
                             use_hp=use_hp, hp_open=hp_open, hp_ext=hp_ext,
                             qv1=qv1, qv2=qv2),
        launch)

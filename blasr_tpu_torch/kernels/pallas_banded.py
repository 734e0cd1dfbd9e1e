"""The banded-DP fast path (port of ``blasr_tpu/kernels/pallas_banded.py``).

``banded_align_cuda`` has ``pallas_banded_align``'s contract: band width
128, a two-valued score matrix (match on the ACGT diagonal, one mismatch
value elsewhere) and a band offset that advances by 0, 1 or 2 per row.  On
CUDA tensors it launches the hand-written kernel K1
(``csrc/banded_dp.cu``) in its distance mode, or K1-QV when the packed
QV tracks ``qv1``/``qv2`` are given; on CPU tensors it runs the plain
version, :func:`blasr_tpu_torch.kernels.banded.banded_align`.
"""

from __future__ import annotations

import numpy as np
import torch

from blasr_tpu_torch.kernels.banded import BandedResult, banded_align


def slope_limit_offsets(offs: torch.Tensor, w_b: int) -> torch.Tensor:
    """Clamp a monotone band-offset path to per-row slope in {0, 1, 2}.
    offs: int [..., L]."""
    L = offs.shape[-1]
    r = torch.arange(L, dtype=offs.dtype, device=offs.device)
    offs = torch.cummax(offs, dim=-1).values
    return 2 * r + torch.cummin(offs - 2 * r, dim=-1).values


def two_valued(submat) -> bool:
    """True for a 5x5 matrix with one match value on the ACGT diagonal and
    one mismatch value everywhere else (N included): the fast path's
    scoring contract."""
    m5 = np.asarray(torch.as_tensor(submat).detach().cpu(),
                    dtype=np.float32).reshape(5, 5)
    return bool(np.all(np.diag(m5)[:4] == m5[0, 0])
                and np.all(m5[~np.eye(5, dtype=bool)] == m5[0, 1])
                and m5[4, 4] == m5[0, 1])


def check_slope(offsets: torch.Tensor, qa: torch.Tensor,
                qb: torch.Tensor) -> None:
    """Raise unless every active row (qa < r < qb) advances the band by
    0, 1 or 2 — the rows where K1's shift registers are used."""
    s = offsets[:, 1:] - offsets[:, :-1]                     # s at row r+1
    r = torch.arange(1, offsets.shape[1], device=offsets.device)
    act = (r[None, :] > qa[:, None]) & (r[None, :] < qb[:, None])
    if bool((((s < 0) | (s > 2)) & act).any()):
        raise ValueError("banded_align_cuda needs band offsets that "
                         "advance by 0, 1 or 2 per row")


def banded_align_cuda(reads, windows, offsets, qa, qb, ta, tb, submat,
                      ins_open, ins_ext, del_open, del_ext, *,
                      w_b: int = 128, qv1=None, qv2=None) -> BandedResult:
    """Same contract as ``banded_align`` (forward pass, distance or QV
    mode) plus the fast path's requirements (module docstring)."""
    if w_b != 128:
        raise ValueError(f"banded_align_cuda needs w_b == 128, got {w_b}")
    if not two_valued(submat):
        raise ValueError("banded_align_cuda needs a two-valued score matrix")
    dev = reads.device
    if dev.type == "cpu":
        return banded_align(reads, windows, offsets, qa, qb, ta, tb, submat,
                            ins_open, ins_ext, del_open, del_ext, w_b=w_b,
                            qv1=qv1, qv2=qv2)
    if dev.type != "cuda":
        raise NotImplementedError(f"banded_align_cuda on {dev.type}")
    from blasr_tpu_torch.kernels import cuda_ops
    check_slope(offsets, qa, qb)
    m = np.asarray(torch.as_tensor(submat).detach().cpu(),
                   dtype=np.float32).reshape(25)
    return cuda_ops.banded_dp_launch(
        reads, windows, offsets, qa, qb, ta, tb,
        match=float(m[0]), mismatch=float(m[1]), ins_open=float(ins_open),
        ins_ext=float(ins_ext), del_open=float(del_open),
        del_ext=float(del_ext), qv1=qv1, qv2=qv2)

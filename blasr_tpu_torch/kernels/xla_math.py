"""Float32 arithmetic that rounds the way the JAX package's XLA CPU build
does, so float-ranked outputs (chain significance, anchor -log P) agree
bit for bit.

Two differences from eager PyTorch matter:

* XLA contracts ``a * b + c`` into one fused multiply-add (a single
  rounding); eager PyTorch rounds the product and the sum separately.
  :func:`fma_f32` computes the product and the sum in float64 and rounds
  once to float32.  The float32 product is exact in float64; the float64
  sum can differ from a true single rounding only when it lands on a
  float32 rounding midpoint, which the parity tests have not met.
* XLA's float32 ``log`` is not correctly rounded: it is the Cephes
  polynomial with fused multiply-adds.  :func:`log_f32` reproduces that
  polynomial step for step (matched against ``jnp.log`` on 220,000
  inputs, tests/test_torch_stages.py).
"""

from __future__ import annotations

import numpy as np
import torch

_F32 = torch.float32


def fma_f32(a: torch.Tensor, b, c) -> torch.Tensor:
    """round_f32(a * b + c) with one rounding (a, b, c float32)."""
    a = torch.as_tensor(a, dtype=_F32)
    b = torch.as_tensor(b, dtype=_F32, device=a.device)
    c = torch.as_tensor(c, dtype=_F32, device=a.device)
    return (a.double() * b.double() + c.double()).to(_F32)


def _c(v: float) -> float:
    return float(np.float32(v))


_P = [_c(v) for v in (7.0376836292E-2, -1.1514610310E-1, 1.1676998740E-1,
                      -1.2420140846E-1, 1.4249322787E-1, -1.6668057665E-1,
                      2.0000714765E-1, -2.4999993993E-1, 3.3333331174E-1)]
_Q1, _Q2 = _c(-2.12194440e-4), _c(0.693359375)
_SQRTHF = _c(0.707106781186547524)
_MIN_NORM = float(np.frombuffer(np.int32(0x00800000).tobytes(),
                                dtype=np.float32)[0])


def log_f32(x: torch.Tensor) -> torch.Tensor:
    """Natural log of positive float32 values, rounded as XLA's CPU
    kernel rounds them."""
    x = torch.clamp(x.to(_F32), min=_MIN_NORM)
    bits = x.view(torch.int32)
    e = ((bits >> 23) - 0x7F).to(_F32) + 1.0
    m = ((bits & 0x007FFFFF) | 0x3F000000).view(_F32)     # mantissa in [.5,1)
    mask = m < _SQRTHF
    tmp = torch.where(mask, m, 0.0)                       # x + x - 1 below
    m = m - 1.0                                           # sqrt(1/2)
    e = e - mask.to(_F32)
    m = m + tmp
    x2 = m * m
    x3 = x2 * m
    y = fma_f32(m, _P[0], _P[1])
    y1 = fma_f32(m, _P[3], _P[4])
    y2 = fma_f32(m, _P[6], _P[7])
    y = fma_f32(y, m, _P[2])
    y1 = fma_f32(y1, m, _P[5])
    y2 = fma_f32(y2, m, _P[8])
    y = fma_f32(y, x3, y1)
    y = fma_f32(y, x3, y2)
    y = fma_f32(y, x3, e * _Q1)
    m = fma_f32(x2, -0.5, m)
    m = m + y
    return fma_f32(e, _Q2, m)

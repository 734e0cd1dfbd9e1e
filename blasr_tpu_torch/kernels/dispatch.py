"""Device dispatch of the kernels' public names.

CPU tensors go to the plain PyTorch version, CUDA tensors to the
hand-written kernel through :mod:`blasr_tpu_torch.kernels.cuda_ops`, and
any other device raises.  There is no fallback: a kernel that fails to
build or launch raises.  The CPU branch never imports ``cuda_ops``, so it
needs neither ``nvcc`` nor a card.
"""

from __future__ import annotations

from types import ModuleType
from typing import Callable, TypeVar

import torch

T = TypeVar("T")


def on_device(name: str, dev: torch.device, plain: Callable[[], T],
              launch: Callable[[ModuleType], T]) -> T:
    """``plain()`` on the CPU, ``launch(cuda_ops)`` on CUDA."""
    if dev.type == "cpu":
        return plain()
    if dev.type != "cuda":
        raise NotImplementedError(f"{name} on {dev.type}")
    from blasr_tpu_torch.kernels import cuda_ops
    return launch(cuda_ops)

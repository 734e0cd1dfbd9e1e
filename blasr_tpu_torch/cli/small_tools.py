# Copied from blasr_tpu/cli/small_tools.py: load_ctab only (the mapper's
# --ctab input); the companion tools themselves are not part of the port.
"""Helpers of the companion tools that the mapper's ``--ctab`` input needs."""

from __future__ import annotations


def load_ctab(path: str):
    """Reference binary .ctab (Blasr.cpp:1136-1147 ct.Read) or our .npz."""
    from blasr_tpu_torch.io.refbin import load_any_ctab
    return load_any_ctab(path)

"""hairpt_torch — the PyTorch/CUDA port of hairpt for one NVIDIA H100.

The package mirrors `hairpt/`'s layout module for module. It imports
torch and numpy only: the JAX package is the reference the tests compare
against, never a dependency. Entry points run on the card ("cuda") unless
the caller passes `device="cpu"`; asking for CUDA on a machine without it
raises instead of silently falling back.

The hand-written CUDA kernels live in `csrc/`: the tiled intersector's
phase-A tile cull and phase-B miter-cylinder test (`tiled.cu`, kernels A
and B) and its octet and stream modes (`octets.cu`, C and D), bound
through `ops/tiled_kernels.py`; the swept traversal's phase A
(`swept_cull.cu`) and chunk test (`phaseb.cu`, kernel E), bound through
`ops/phaseb_kernels.py`.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` means the card. CPU only when asked for explicitly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("hairpt_torch: CUDA was requested but "
                           "torch.cuda.is_available() is False; pass "
                           "device='cpu' to run the plain versions")
    return dev

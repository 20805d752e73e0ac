"""Reconstruction filter (port of the tent filter of hairpt/film/rfilter.py)."""
from __future__ import annotations

import torch

TENT = 1

FILTERS = {
    "tent": (TENT, 1.0),
}


def filter_eval(kind: int, radius: float, dx, dy):
    """The separable 2D filter at offsets (dx, dy) from the sample."""
    if kind == TENT:
        return torch.clamp(1.0 - torch.abs(dx) / radius, min=0.0) * \
            torch.clamp(1.0 - torch.abs(dy) / radius, min=0.0)
    raise NotImplementedError(f"filter kind {kind} is not ported")

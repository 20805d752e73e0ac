"""Quadrature rules (numpy copy of hairpt/core/quad.py::gauss_legendre,
host-side precompute)."""
from __future__ import annotations

import numpy as np


def gauss_legendre(n: int):
    """Nodes and weights on [-1, 1] (float64)."""
    x, w = np.polynomial.legendre.leggauss(n)
    return x.astype(np.float64), w.astype(np.float64)

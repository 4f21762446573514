"""Quadrature rules (host-side precomputation, static node counts)."""

from __future__ import annotations

from functools import lru_cache

import numpy as np


@lru_cache(maxsize=None)
def gauss_legendre(n: int):
    """Gauss-Legendre nodes/weights on [-1, 1] as float64 numpy arrays.

    Computed once per order on the host (the reference computes the same
    rule at emitter-precompute time, `include/mitsuba/core/quad.h:27`).
    """
    x, w = np.polynomial.legendre.leggauss(n)
    return x, w

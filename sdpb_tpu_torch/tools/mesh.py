"""Adaptive 5-point 1-D refinement mesh (the reference's Mesh,
Mesh/Mesh.cxx:5-44) plus the quadratic-fit zero finder
(spectrum/get_zeros.cxx:12-38): the port's copy of sdpb_tpu/tools/mesh.py.
Host-side mpmath; used by outer_limits."""
from __future__ import annotations

from typing import Callable, List, Optional

import mpmath


def _need_refine(f_m, f_x_bar, f_p, mesh_threshold, block_epsilon) -> bool:
    f_bar = (f_m + f_p) / 2
    diff = abs(f_bar - f_x_bar)
    return diff > mesh_threshold * (abs(f_bar) + abs(f_x_bar)) and diff > block_epsilon


class Mesh:
    """5 points [x0, (x0+x2)/2, x2, (x2+x4)/2, x4]; children refine halves
    where the midpoint deviates from linear interpolation."""

    __slots__ = ("x", "f", "lower", "upper")

    def __init__(self, x0, x2, x4, f0, f2, f4, fn: Callable,
                 mesh_threshold, block_epsilon):
        x1 = (x0 + x2) / 2
        x3 = (x2 + x4) / 2
        self.x = [x0, x1, x2, x3, x4]
        self.f = [f0, fn(x1), f2, fn(x3), f4]
        self.lower: Optional[Mesh] = None
        self.upper: Optional[Mesh] = None
        # stop once coordinate differences are unresolvable
        eps = mpmath.mpf(2) ** (1 - mpmath.mp.prec)
        if abs(x0 - x1) < mpmath.sqrt(eps):
            return
        if _need_refine(self.f[0], self.f[1], self.f[2], mesh_threshold, block_epsilon):
            self.lower = Mesh(self.x[0], self.x[1], self.x[2],
                              self.f[0], self.f[1], self.f[2],
                              fn, mesh_threshold, block_epsilon)
        if _need_refine(self.f[2], self.f[3], self.f[4], mesh_threshold, block_epsilon):
            self.upper = Mesh(self.x[2], self.x[3], self.x[4],
                              self.f[2], self.f[3], self.f[4],
                              fn, mesh_threshold, block_epsilon)

    @classmethod
    def create(cls, x0, x4, fn: Callable, mesh_threshold, block_epsilon):
        x2 = (x0 + x4) / 2
        return cls(x0, x2, x4, fn(x0), fn(x2), fn(x4), fn,
                   mesh_threshold, block_epsilon)


def _maybe_add_point(x_minus, x_bar, x_plus, f_minus, f_bar, f_plus,
                     threshold, points: List) -> None:
    """Quadratic fit through 3 points; record the interior minimum if it
    dips below threshold * f'' (get_zeros.cxx:12-38)."""
    dx = x_plus - x_minus
    a = f_bar
    b = (f_plus - f_minus) / dx
    c = (f_plus - 2 * f_bar + f_minus) / (dx * dx / 4)
    if x_minus == 0:
        # special case: the function may legitimately cross zero at x=0
        if f_minus <= threshold * b:
            points.append(x_minus)
    elif c > 0:
        x_min = -b / c + x_bar
        f_min = a - b * b / (2 * c)
        if x_minus <= x_min <= x_plus and f_min < c * threshold:
            points.append(x_min)


def get_zeros(mesh: Mesh, threshold) -> List:
    result: List = []
    if mesh.lower is not None:
        result.extend(get_zeros(mesh.lower, threshold))
    else:
        _maybe_add_point(mesh.x[0], mesh.x[1], mesh.x[2],
                         mesh.f[0], mesh.f[1], mesh.f[2], threshold, result)
    if mesh.upper is not None:
        result.extend(get_zeros(mesh.upper, threshold))
    else:
        _maybe_add_point(mesh.x[2], mesh.x[3], mesh.x[4],
                         mesh.f[2], mesh.f[3], mesh.f[4], threshold, result)
    return result

"""User-defined surfaces from mathematical functions
(reference function_surface_2d.py / function_surface_1d.py).

For the surface to participate in the jitted device trace, ``func`` (and
``deriv_func``/``mask_func`` if given) must be expressible with jnp
operations. Plain numpy functions still work for the host-side API
(values/plotting), and the trace falls back to calling them under jax's
numpy compatibility where possible.
"""

from typing import Any, Callable

import copy as _copy
import numpy as np
import jax.numpy as jnp

from .surface import Surface
from ...ops import geom
from ...utils.property_checker import PropertyChecker as pc
from ...utils.warnings import warning


class FunctionSurface2D(Surface):

    rotational_symmetry: bool = False
    _1D: bool = False

    def __init__(self, r: float,
                 func: Callable,
                 mask_func: Callable = None,
                 deriv_func: Callable = None,
                 func_args: dict = None,
                 mask_args: dict = None,
                 deriv_args: dict = None,
                 z_min: float = None,
                 z_max: float = None,
                 parax_roc: float = None,
                 **kwargs) -> None:
        self._lock = False
        super().__init__(r, **kwargs)

        self._sign = 1.0
        self._angle = 0.0

        self.func = func
        self.mask_func = mask_func
        self.deriv_func = deriv_func
        self.func_args = _copy.deepcopy(func_args) if func_args else {}
        self.mask_args = _copy.deepcopy(mask_args) if mask_args else {}
        self.deriv_args = _copy.deepcopy(deriv_args) if deriv_args else {}
        self.parax_roc = parax_roc

        # offset so the surface center sits at z=0 relative coordinates
        # (reference function_surface_2d.py:73-74)
        self._offset = 0.0
        self._offset = float(self._values(np.array([0.]), np.array([0.]))[0])

        # z-bounds: probe unless provided (reference :81-131)
        z_min_p, z_max_p = self._find_bounds()
        if z_min is not None and z_max is not None:
            pc.check_type("z_min", z_min, (float, int))
            pc.check_type("z_max", z_max, (float, int))
            z_min, z_max = float(z_min), float(z_max)
            if abs(z_min - (self.pos[2] + z_min_p)) > 100 * self.N_EPS + 5 * (z_max_p - z_min_p) / 1000 \
                    or abs(z_max - (self.pos[2] + z_max_p)) > 100 * self.N_EPS + 5 * (z_max_p - z_min_p) / 1000:
                warning(f"Provided z-bounds [{z_min}, {z_max}] deviate from probed "
                        f"bounds [{self.pos[2] + z_min_p}, {self.pos[2] + z_max_p}].")
            self.z_min, self.z_max = z_min, z_max
        else:
            if z_min is not None or z_max is not None:
                warning("Provide both z_min and z_max, falling back to probed values.")
            self.z_min, self.z_max = self.pos[2] + z_min_p, self.pos[2] + z_max_p

        self.lock()

    # ------------------------------------------------------------------
    def _sag(self, x, y):
        if self._1D:
            vals = self.func(jnp.sqrt(x * x + y * y), **self.func_args)
        else:
            xr, yr = self._rot_args(x, y)
            vals = self.func(xr, yr, **self.func_args)
        return self._sign * (jnp.asarray(vals) - self._offset)

    def _rot_args(self, x, y):
        if self._angle:
            c, s = np.cos(-self._angle), np.sin(-self._angle)
            x, y = x * c - y * s, x * s + y * c
        if self._sign < 0:
            x = -x
        return x, y

    def _normals_rel(self, x, y):
        if self.deriv_func is not None:
            xr, yr = self._rot_args(x, y)
            if self._1D:
                r = jnp.sqrt(x * x + y * y)
                m = jnp.asarray(self.deriv_func(r, **self.deriv_args)) * self._sign
                safe_r = jnp.where(r > 0, r, 1.0)
                return geom.normal_from_radial_deriv(x, y, jnp.where(r > 0, m / safe_r, 0.0))
            dx, dy = self.deriv_func(xr, yr, **self.deriv_args)
            dx = jnp.asarray(dx) * self._sign
            dy = jnp.asarray(dy) * self._sign
            if self._sign < 0:
                dx = -dx
            if self._angle:
                c, s = np.cos(self._angle), np.sin(self._angle)
                dx, dy = dx * c - dy * s, dx * s + dy * c
            n = jnp.stack([-dx, -dy, jnp.ones_like(dx)], axis=-1)
            return n / jnp.linalg.norm(n, axis=-1, keepdims=True)
        return geom.normal_numeric(self._sag, x, y)

    def mask(self, x, y) -> np.ndarray:
        m = super().mask(x, y)
        if self.mask_func is not None:
            xr = np.asarray(x, dtype=np.float64) - self.pos[0]
            yr = np.asarray(y, dtype=np.float64) - self.pos[1]
            if self._angle:
                c, s = np.cos(-self._angle), np.sin(-self._angle)
                xr, yr = xr * c - yr * s, xr * s + yr * c
            if self._sign < 0:
                xr = -xr
            if self._1D:
                mf = self.mask_func(np.hypot(xr, yr), **self.mask_args)
            else:
                mf = self.mask_func(xr, yr, **self.mask_args)
            m = m & np.asarray(mf, dtype=bool)
        return m

    def flip(self) -> None:
        self._lock = False
        self._sign *= -1.0
        if self.parax_roc is not None:
            self.parax_roc *= -1
        a = self.pos[2] - (self.z_max - self.pos[2])
        b = self.pos[2] + (self.pos[2] - self.z_min)
        self.z_min, self.z_max = a, b
        self.lock()

    def rotate(self, angle: float) -> None:
        self._lock = False
        self._angle += np.deg2rad(angle)
        self.lock()

    def __setattr__(self, key: str, val: Any) -> None:
        if key in ("func", "mask_func", "deriv_func") and key != "func":
            pc.check_none_or_callable(key, val)
        elif key == "func" and val is not None:
            pc.check_callable(key, val)
        super().__setattr__(key, val)


class FunctionSurface1D(FunctionSurface2D):
    """Radially symmetric function surface: func takes r = √(x²+y²)
    (reference function_surface_1d.py)."""

    rotational_symmetry: bool = True
    _1D: bool = True

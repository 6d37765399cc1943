"""CIE 1931 2° standard observer colour-matching functions.

Data: CIE 2018 1 nm tables (DOI:10.25039/CIE.DS.xvudnb9b), stored in
``resources/cie_data.npz`` (see tools/make_cie_data.py). Parity with
reference ``optrace/tracer/color/observers.py:10-42`` (linear interpolation,
zero outside the tabulated range).
"""

import pathlib

import numpy as np
import jax.numpy as jnp

_RES = pathlib.Path(__file__).resolve().parent.parent / "resources" / "cie_data.npz"

with np.load(_RES, allow_pickle=False) as _d:
    _OBS_WL = np.asarray(_d["observer_wl"], dtype=np.float32)      # (n,)
    _OBS_XYZ = np.asarray(_d["observer_xyz"], dtype=np.float32)    # (3, n)


def observers():
    """Return (wl, xbar, ybar, zbar) raw 1 nm observer tables as numpy."""
    return _OBS_WL, _OBS_XYZ[0], _OBS_XYZ[1], _OBS_XYZ[2]


_WL0 = float(_OBS_WL[0])
_WL1 = float(_OBS_WL[-1])
# zero-padded table so index clamping also zeroes out-of-range wavelengths
_OBS_PAD = np.pad(_OBS_XYZ, ((0, 0), (1, 1)))


def _interp(wl, row: int):
    """Uniform-grid linear interpolation (1 nm steps): direct index
    arithmetic instead of jnp.interp's binary search — the observer lookup
    sits on the per-ray hot path of detector binning, where a binary
    search per channel per ray is pure overhead. Host inputs evaluate in
    numpy (ops/xp.py) so spectrum presets and scene building never touch
    the device."""
    from ..ops.xp import get_xp
    xp = get_xp(wl)
    wl = xp.asarray(wl)
    g = wl - _WL0
    idx = xp.floor(g)
    frac = g - idx
    n = _OBS_PAD.shape[1]
    # +1 accounts for the zero padding at the front
    i0 = xp.clip(idx.astype(xp.int32) + 1, 0, n - 2)
    table = xp.asarray(_OBS_PAD[row])
    v0 = table[i0]
    v1 = table[i0 + 1]
    inside = (g >= 0) & (wl <= _WL1)
    return xp.where(inside, v0 * (1.0 - frac) + v1 * frac, 0.0)


def x_observer(wl) -> jnp.ndarray:
    """CIE 1931 x̄(λ), linearly interpolated; zero outside the table."""
    return _interp(wl, 0)


def y_observer(wl) -> jnp.ndarray:
    """CIE 1931 ȳ(λ)."""
    return _interp(wl, 1)


def z_observer(wl) -> jnp.ndarray:
    """CIE 1931 z̄(λ)."""
    return _interp(wl, 2)

"""Fast interpolation primitives for per-ray hot paths.

jnp.interp lowers to a binary search (searchsorted) plus gathers per
value. Every tabulated quantity in this package
(observers, illuminants, Data spectra/indices, resampled inverse CDFs)
lives on a *uniform* grid, where interpolation is pure index arithmetic.
"""

import jax.numpy as jnp


def uniform_interp(x, table, x0: float, dx: float, left=0.0, right=0.0):
    """Linear interpolation of ``table`` sampled at x0 + i·dx.

    Out-of-range queries return ``left``/``right``.
    """
    x = jnp.asarray(x)
    table = jnp.asarray(table)
    n = table.shape[0]
    g = (x - x0) / dx
    idx = jnp.floor(g)
    frac = g - idx
    i0 = jnp.clip(idx.astype(jnp.int32), 0, n - 2)
    v = table[i0] * (1.0 - frac) + table[i0 + 1] * frac
    v = jnp.where(g < 0, left, v)
    v = jnp.where(g > n - 1, right, v)
    return v


def invert_cdf_uniform(x, cdf, M: int = 4096):
    """Resample an inverse CDF onto a uniform u-grid of M points.

    One M-sized searchsorted at build time replaces a per-ray binary
    search; afterwards sampling is ``uniform_interp(u, table, 0, 1/(M-1))``.
    """
    u_grid = jnp.linspace(0.0, 1.0, M)
    return jnp.interp(u_grid, cdf, x)

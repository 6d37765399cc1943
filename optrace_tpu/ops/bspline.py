"""Tensor-product B-spline evaluation in jnp.

Device replacement for the reference's scipy spline surfaces
(optrace/tracer/geometry/surface/data_surface_2d.py:60-126): the spline is
fitted host-side with scipy (f64 coefficients), then evaluated *exactly*
inside traced code with a vectorized de Boor basis — no dense-grid
resampling, C^(k−1)-smooth sag and analytically consistent normals.

The basis computation is the classic knot-span algorithm (The NURBS Book,
alg. A2.2) with the degree fixed at compile time, so the inner loops
unroll into straight-line jnp code: one `searchsorted` per query axis plus
(k+1)² coefficient gathers for a 2D surface — gather-friendly and
jit/vmap/grad-safe.
"""

import numpy as np
import jax.numpy as jnp


def basis(knots, k: int, x):
    """Nonzero B-spline basis functions at x.

    :param knots: (n_knots,) non-decreasing knot vector (jnp or np array)
    :param k: spline degree (static Python int)
    :param x: query points, any shape
    :return: (span, N) — span index array (same shape as x) and basis
        values of shape x.shape + (k+1,): N[..., j] is the value of basis
        function ``span − k + j`` at x.
    """
    knots = jnp.asarray(knots)
    x = jnp.asarray(x)
    n = knots.shape[0]
    # valid spans are [k, n-k-2]; clamping also clamps out-of-range queries
    # to the boundary polynomial piece (= spline extrapolation, like scipy)
    span = jnp.clip(jnp.searchsorted(knots, x, side="right") - 1, k, n - k - 2)

    N = [jnp.ones_like(x)]
    left = []    # left[j] = x − knots[span+1−(j+1)]
    right = []   # right[j] = knots[span+(j+1)] − x
    for d in range(1, k + 1):
        left.append(x - knots[span + 1 - d])
        right.append(knots[span + d] - x)
        saved = jnp.zeros_like(x)
        N_new = []
        for j in range(d):
            den = right[j] + left[d - 1 - j]
            tmp = N[j] / jnp.where(den != 0, den, 1.0)
            N_new.append(saved + right[j] * tmp)
            saved = left[d - 1 - j] * tmp
        N_new.append(saved)
        N = N_new
    return span, jnp.stack(N, axis=-1)


def eval_1d(knots, coeffs, k: int, x):
    """Evaluate a 1D B-spline Σ c_i B_{i,k}(x)."""
    coeffs = jnp.asarray(coeffs)
    span, N = basis(knots, k, x)
    out = jnp.zeros_like(N[..., 0])
    for j in range(k + 1):
        out = out + coeffs[span - k + j] * N[..., j]
    return out


def eval_2d(tx, ty, coeffs, kx: int, ky: int, x, y):
    """Evaluate a tensor-product spline Σ c_ij B_{i,kx}(x) B_{j,ky}(y).

    ``coeffs`` has shape (tx.size − kx − 1, ty.size − ky − 1), matching
    scipy.interpolate.RectBivariateSpline.tck.
    """
    coeffs = jnp.asarray(coeffs)
    sx, Nx = basis(tx, kx, x)
    sy, Ny = basis(ty, ky, y)
    out = jnp.zeros_like(Nx[..., 0])
    for a in range(kx + 1):
        for b in range(ky + 1):
            out = out + coeffs[sx - kx + a, sy - ky + b] * Nx[..., a] * Ny[..., b]
    return out


class Spline1D:
    """Host-fitted 1D spline with jnp evaluation and exact derivative.

    Wraps scipy tck arrays (f64); ``__call__``/``deriv`` run in traced code.
    """

    def __init__(self, scipy_spline):
        t, c, k = (np.asarray(scipy_spline._eval_args[0]),
                   np.asarray(scipy_spline._eval_args[1]),
                   int(scipy_spline._eval_args[2]))
        self.t, self.c, self.k = t, c[:t.size - k - 1], k
        d = scipy_spline.derivative()
        td, cd, kd = d._eval_args
        self.td, self.cd, self.kd = (np.asarray(td),
                                     np.asarray(cd)[:np.asarray(td).size - int(kd) - 1],
                                     int(kd))

    def __call__(self, x):
        return eval_1d(self.t, self.c, self.k, x)

    def deriv(self, x):
        return eval_1d(self.td, self.cd, self.kd, x)


class Spline2D:
    """Host-fitted RectBivariateSpline with jnp evaluation and exact
    partial derivatives (each an exact lower-order spline, via scipy)."""

    def __init__(self, scipy_spline):
        tx, ty, c = scipy_spline.tck
        kx, ky = scipy_spline.degrees
        self.tx, self.ty = np.asarray(tx), np.asarray(ty)
        self.kx, self.ky = int(kx), int(ky)
        self.c = np.asarray(c).reshape(self.tx.size - self.kx - 1,
                                       self.ty.size - self.ky - 1)

        dx = scipy_spline.partial_derivative(1, 0)
        self.dx_tck = (np.asarray(dx.tck[0]), np.asarray(dx.tck[1]),
                       np.asarray(dx.tck[2]).reshape(dx.tck[0].size - int(dx.degrees[0]) - 1,
                                                     dx.tck[1].size - int(dx.degrees[1]) - 1),
                       int(dx.degrees[0]), int(dx.degrees[1]))
        dy = scipy_spline.partial_derivative(0, 1)
        self.dy_tck = (np.asarray(dy.tck[0]), np.asarray(dy.tck[1]),
                       np.asarray(dy.tck[2]).reshape(dy.tck[0].size - int(dy.degrees[0]) - 1,
                                                     dy.tck[1].size - int(dy.degrees[1]) - 1),
                       int(dy.degrees[0]), int(dy.degrees[1]))

    def __call__(self, x, y):
        return eval_2d(self.tx, self.ty, self.c, self.kx, self.ky, x, y)

    def deriv_x(self, x, y):
        tx, ty, c, kx, ky = self.dx_tck
        return eval_2d(tx, ty, c, kx, ky, x, y)

    def deriv_y(self, x, y):
        tx, ty, c, kx, ky = self.dy_tck
        return eval_2d(tx, ty, c, kx, ky, x, y)

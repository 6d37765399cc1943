"""Axial focus metrics, evaluated as one vmapped device kernel.

Device replacement for the reference's focus-search cost sampling
(``optrace/tracer/raytracer.py:1354-1632``): where the reference evaluates
320 z-positions one at a time through a thread pool, here every candidate
plane is a lane of a single ``jax.vmap`` over the jitted cost function —
one device dispatch per sweep, differentiable, and reusable for the
coarse-to-fine refinement loop.

Ray model: each surviving ray is reduced to an affine line
``q(z) = q0 + m * z`` in the transverse plane (``m`` = direction scaled to
unit z-step). Costs:

- **RMS Spot Size** — weighted transverse standard deviation; its minimum
  also has a closed form (:func:`rms_focus_direct`).
- **Image Sharpness** — negative gradient energy of a binned irradiance
  histogram.
- **Image Center Sharpness** — same, after a raised-cosine radial window
  and renormalization.
- **Irradiance Variance** — ``-log`` of the variance of the non-empty
  histogram bins, normalized by pixel area.
"""

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from ..ops import binning

SWEEP_SAMPLES = 320          # planes per coarse sweep (parity w/ reference)
REFINE_ROUNDS = 3            # zoom iterations after the coarse sweep
REFINE_SAMPLES = 33


def histogram_side(n_rays: int) -> int:
    """Odd histogram resolution that grows with the ray count
    (reference raytracer.py:1390-1393 sizing rule)."""
    side = 100 * int(1 + np.sqrt(n_rays) / 1500)
    return side + (0 if side % 2 else 1)


def _spot_histogram(q0, m, w, z, n_px: int):
    """Bin ray positions at plane z into an (n_px, n_px) power histogram
    spanning the instantaneous bundle extent; also return the pixel area."""
    q = q0 + m * z
    x, y = q[:, 0], q[:, 1]
    ext = jnp.stack([x.min(), x.max(), y.min(), y.max()])
    img = binning.bin_scalar(x, y, w, n_px, n_px, ext)
    apx = (ext[1] - ext[0]) * (ext[3] - ext[2]) / n_px ** 2
    return img, apx


def _rms_cost(q0, m, w, z):
    q = q0 + m * z
    mean = jnp.average(q, axis=0, weights=w)
    var = jnp.average((q - mean) ** 2, axis=0, weights=w)
    return jnp.sqrt(var[0] + var[1])


def _gradient_energy(img):
    return ((img[1:] - img[:-1]) ** 2).sum() + ((img[:, 1:] - img[:, :-1]) ** 2).sum()


def _sharpness_cost(q0, m, w, z, n_px, windowed: bool):
    img, _ = _spot_histogram(q0, m, w, z, n_px)
    if windowed:
        ax = jnp.linspace(-1.0, 1.0, n_px)
        rad = jnp.sqrt(ax[None, :] ** 2 + ax[:, None] ** 2)
        img = img * jnp.where(rad > 1, 0.0, 1.0 + jnp.cos(rad * jnp.pi))
        total = img.sum()
        img = jnp.where(total > 0, img / jnp.where(total > 0, total, 1.0), img)
    return -_gradient_energy(img)


def _variance_cost(q0, m, w, z, n_px):
    img, apx = _spot_histogram(q0, m, w, z, n_px)
    filled = img > 0
    cnt = jnp.maximum(filled.sum(), 1)
    mean = jnp.sum(jnp.where(filled, img, 0.0)) / cnt
    var = jnp.sum(jnp.where(filled, (img - mean) ** 2, 0.0)) / cnt
    return -jnp.log(var / apx ** 2)


@partial(jax.jit, static_argnames=("mode", "n_px"))
def cost_sweep(z_arr, q0, m, w, mode: str, n_px: int):
    """Evaluate the focus cost at every plane of ``z_arr`` in parallel."""
    kernels = {
        "RMS Spot Size": lambda z: _rms_cost(q0, m, w, z),
        "Image Sharpness": lambda z: _sharpness_cost(q0, m, w, z, n_px, False),
        "Image Center Sharpness": lambda z: _sharpness_cost(q0, m, w, z, n_px, True),
        "Irradiance Variance": lambda z: _variance_cost(q0, m, w, z, n_px),
    }
    return jax.vmap(kernels[mode])(z_arr)


def rms_focus_direct(q0, m, w, bounds) -> float:
    """Closed-form minimizer of the weighted RMS spot size.

    var_x(z) + var_y(z) is quadratic in z with minimum
    z* = -(cov(x0, mx) + cov(y0, my)) / (var(mx) + var(my))
    over the w-weighted central moments of the line parameters.
    """
    wsum = np.sum(w)
    qc = q0 - np.average(q0, axis=0, weights=w)
    mc = m - np.average(m, axis=0, weights=w)
    curv = np.sum(w * (mc[:, 0] ** 2 + mc[:, 1] ** 2)) / wsum
    slope = np.sum(w * (qc[:, 0] * mc[:, 0] + qc[:, 1] * mc[:, 1])) / wsum
    z_opt = -slope / curv if curv else np.mean(bounds)
    return float(np.clip(z_opt, bounds[0], bounds[1]))


def minimize_on_interval(q0, m, w, bounds, mode: str, n_px: int) -> float:
    """Coarse sweep + shrinking-window refinement, all device-vectorized."""
    jq0, jm, jw = jnp.asarray(q0), jnp.asarray(m), jnp.asarray(w)
    lo, hi = float(bounds[0]), float(bounds[1])
    z = jnp.linspace(lo, hi, SWEEP_SAMPLES)
    vals = cost_sweep(z, jq0, jm, jw, mode, n_px)
    best = float(z[int(jnp.nanargmin(vals))])

    half = (hi - lo) / SWEEP_SAMPLES
    for _ in range(REFINE_ROUNDS):
        z = jnp.linspace(max(lo, best - half), min(hi, best + half), REFINE_SAMPLES)
        vals = cost_sweep(z, jq0, jm, jw, mode, n_px)
        best = float(z[int(jnp.nanargmin(vals))])
        half /= 8.0
    return best

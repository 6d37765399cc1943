"""Detector binning: scatter-add of observer-weighted ray hits into XYZW
image tiles.

Device equivalent of reference ``misc.binning_indices_2d``
(misc.py:59-91) + the ``np.add.at`` scatter in RenderImage.render
(render_image.py:394-418). Pure jnp; in the sharded render path each shard
accumulates a local tile which is then ``psum``-merged (SURVEY.md §2.10).
"""

import jax.numpy as jnp

from ..color.observers import x_observer, y_observer, z_observer


def binning_indices_2d(x, y, w, Nx: int, Ny: int, extent):
    """Bin indices for a 2D histogram over ``extent`` = [x0, x1, y0, y1].

    Rays outside the extent get index (0, 0) and zero weight; the positive
    edges are inclusive (reference misc.py:59-91 semantics).
    :return: (xi, yi, wm)
    """
    x0, x1, y0, y1 = extent[0], extent[1], extent[2], extent[3]
    sx = x1 - x0
    sy = y1 - y0

    xi = jnp.floor(Nx / sx * (x - x0)).astype(jnp.int32)
    yi = jnp.floor(Ny / sy * (y - y0)).astype(jnp.int32)

    xi = jnp.where(x == x1, Nx - 1, xi)
    yi = jnp.where(y == y1, Ny - 1, yi)

    outside = (xi < 0) | (yi < 0) | (yi >= Ny) | (xi >= Nx)
    wm = jnp.where(outside, 0.0, w)
    xi = jnp.where(outside, 0, xi)
    yi = jnp.where(outside, 0, yi)
    return xi, yi, wm


def bin_xyzw(px, py, w, wl, Nx: int, Ny: int, extent) -> jnp.ndarray:
    """Accumulate rays into an (Ny, Nx, 4) image of X̄w, Ȳw, Z̄w, w.

    Observer weighting happens inline so wavelengths never need to be
    stored; on the GPU XLA lowers the scatter-add to atomic adds.
    """
    xi, yi, wm = binning_indices_2d(px, py, w, Nx, Ny, extent)
    xyzw = jnp.stack([x_observer(wl) * wm, y_observer(wl) * wm,
                      z_observer(wl) * wm, wm], axis=-1)
    flat = yi * Nx + xi
    img = jnp.zeros((Ny * Nx, 4), dtype=xyzw.dtype)
    img = img.at[flat].add(xyzw)
    return img.reshape(Ny, Nx, 4)


def bin_scalar(px, py, w, Nx: int, Ny: int, extent) -> jnp.ndarray:
    """Accumulate plain weights into an (Ny, Nx) histogram."""
    xi, yi, wm = binning_indices_2d(px, py, w, Nx, Ny, extent)
    flat = yi * Nx + xi
    img = jnp.zeros((Ny * Nx,), dtype=wm.dtype)
    img = img.at[flat].add(wm)
    return img.reshape(Ny, Nx)


def bin_xyzw_soft(px, py, w, wl, Nx: int, Ny: int, extent) -> jnp.ndarray:
    """Differentiable XYZW binning via bilinear splatting.

    Each ray deposits into the 4 pixels around its continuous position with
    bilinear weights, making the image a smooth function of ray positions —
    this is what gives detector images usable design gradients (the hard
    histogram in :func:`bin_xyzw` is piecewise constant in position).
    """
    x0, x1, y0, y1 = extent[0], extent[1], extent[2], extent[3]
    gx = (px - x0) / (x1 - x0) * Nx - 0.5
    gy = (py - y0) / (y1 - y0) * Ny - 0.5

    ix = jnp.floor(gx)
    iy = jnp.floor(gy)
    fx = gx - ix
    fy = gy - iy
    ix = ix.astype(jnp.int32)
    iy = iy.astype(jnp.int32)

    inside = (gx >= -0.5) & (gx <= Nx - 0.5) & (gy >= -0.5) & (gy <= Ny - 0.5)
    wm = jnp.where(inside, w, 0.0)

    xyzw = jnp.stack([x_observer(wl) * wm, y_observer(wl) * wm,
                      z_observer(wl) * wm, wm], axis=-1)

    img = jnp.zeros((Ny * Nx, 4), dtype=xyzw.dtype)
    for dy, wy in ((0, 1.0 - fy), (1, fy)):
        for dx, wx in ((0, 1.0 - fx), (1, fx)):
            xi = jnp.clip(ix + dx, 0, Nx - 1)
            yi = jnp.clip(iy + dy, 0, Ny - 1)
            img = img.at[yi * Nx + xi].add(xyzw * (wx * wy)[:, None])
    return img.reshape(Ny, Nx, 4)


def histogram_1d(x, w, N: int, x0, x1) -> jnp.ndarray:
    """Weighted 1D histogram with inclusive upper edge (spectrum render)."""
    xi = jnp.floor(N / (x1 - x0) * (x - x0)).astype(jnp.int32)
    xi = jnp.where(x == x1, N - 1, xi)
    outside = (xi < 0) | (xi >= N)
    wm = jnp.where(outside, 0.0, w)
    xi = jnp.where(outside, 0, xi)
    return jnp.zeros((N,), dtype=wm.dtype).at[xi].add(wm)

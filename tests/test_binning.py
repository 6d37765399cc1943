"""XYZW detector binning (ops/binning.py) against a NumPy histogram."""

import numpy as np
import pytest

from optrace_tpu.color.observers import x_observer, y_observer, z_observer
from optrace_tpu.ops.binning import bin_xyzw, bin_scalar


def _data(N, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1.2, 1.2, N).astype(np.float32),
            rng.uniform(-1.2, 1.2, N).astype(np.float32),
            rng.uniform(0, 1, N).astype(np.float32),
            rng.uniform(380, 780, N).astype(np.float32))


def _numpy_xyzw(px, py, w, wl, Nx, Ny, ext):
    """Reference: np.histogram2d per channel (its last bin is closed, the
    inclusive positive edge of reference misc.py:59-91)."""
    chans = [np.asarray(x_observer(wl)), np.asarray(y_observer(wl)),
             np.asarray(z_observer(wl)), np.ones_like(w)]
    out = []
    for ch in chans:
        h, _, _ = np.histogram2d(py, px, bins=(Ny, Nx),
                                 range=[ext[2:], ext[:2]],
                                 weights=(ch * w).astype(np.float64))
        out.append(h)
    return np.stack(out, axis=-1)


@pytest.mark.parametrize("N,Nx,Ny", [(20000, 95, 95), (777, 31, 29)])
def test_bin_xyzw_matches_numpy_histogram(N, Nx, Ny):
    """Square and non-square grids, ray and bin counts far from any block
    size: the scatter-add equals the f64 histogram up to f32 sums."""
    px, py, w, wl = _data(N, seed=N)
    ext = (-1.0, 1.0, -1.0, 1.0)
    img = np.asarray(bin_xyzw(px, py, w, wl, Nx, Ny, ext))
    assert img.shape == (Ny, Nx, 4)
    ref = _numpy_xyzw(px, py, w, wl, Nx, Ny, ext)
    np.testing.assert_allclose(img, ref, rtol=1e-4, atol=1e-4)


def test_bin_xyzw_edge_inclusive():
    """Positive edges are inclusive; rays outside the extent drop out."""
    px = np.array([1.0, -1.0, 0.0, 1.5], dtype=np.float32)
    py = np.array([1.0, -1.0, 1.0, 0.0], dtype=np.float32)
    w = np.ones(4, dtype=np.float32)
    wl = np.full(4, 550.0, dtype=np.float32)
    img = np.asarray(bin_xyzw(px, py, w, wl, 63, 57, (-1.0, 1.0, -1.0, 1.0)))
    assert img[..., 3].sum() == pytest.approx(3.0)
    assert img[56, 62, 3] == 1.0 and img[0, 0, 3] == 1.0 and img[56, 31, 3] == 1.0


def test_bin_scalar_matches_numpy_histogram():
    px, py, w, _ = _data(5000, seed=3)
    ext = (-1.0, 1.0, -1.0, 1.0)
    img = np.asarray(bin_scalar(px, py, w, 40, 30, ext))
    ref, _, _ = np.histogram2d(py, px, bins=(30, 40), range=[ext[2:], ext[:2]],
                               weights=w.astype(np.float64))
    np.testing.assert_allclose(img, ref, rtol=1e-5, atol=1e-5)

"""Scene compilation: Surface objects → pure functional descriptors.

The device trace is a jit-compiled pure function; this module extracts from
each host-side Surface a (params, hit_fn, normal_fn, mask_fn) quadruple
where ``params`` is a pytree of jnp arrays and the fns are closures over
*static structure only*. Geometric quantities (positions, curvatures,
conic constants, polynomial coefficients, aperture radii) flow through the
params pytree, which is what makes the whole trace differentiable w.r.t.
the optical design (SURVEY.md §7 step 8).

Reference semantics: find_hit/normals/mask contracts of
optrace/tracer/geometry/surface/ (SURVEY.md §2.4).
"""

from typing import Callable, NamedTuple

import numpy as np
import jax.numpy as jnp

from ..ops import geom
from ..geometry.surface import (Surface, CircularSurface, RingSurface, ConicSurface,
                                AsphericSurface, TiltedSurface,
                                RectangularSurface, SlitSurface)


class SurfaceFns(NamedTuple):
    """Functional form of one surface. All fns take the params dict first.

    hit_fn(params, o, s) -> (t, valid, ill): o = p − pos local coords.
    normal_fn(params, x, y) -> (N, 3) unit normals (local coords).
    mask_fn(params, x, y) -> bool definition region (local coords).
    """
    params: dict
    hit_fn: Callable
    normal_fn: Callable
    mask_fn: Callable
    kind: str
    is_flat: bool


def _mask_circle_fn(params, x, y):
    return geom.mask_circle(x, y, params["r"])


def _mask_ring_fn(params, x, y):
    return geom.mask_ring(x, y, params["ri"], params["r"])


def _mask_rect_fn(params, x, y):
    return geom.mask_rect(x, y, params["hw"], params["hh"], params["angle"])


def _mask_slit_fn(params, x, y):
    return geom.mask_slit(x, y, params["hw"], params["hh"],
                          params["hwi"], params["hhi"], params["angle"])


def _flat_hit_fn(params, o, s):
    t = geom.hit_plane(o, s)
    valid = jnp.isfinite(t) & (t >= -geom.C_EPS)
    return t, valid, jnp.zeros(t.shape, dtype=bool)


def _flat_normal_fn(params, x, y):
    return geom.normal_flat(x, y)


def compile_surface(surf: Surface, dtype=np.float32) -> SurfaceFns:
    """Build the functional descriptor for a host-side surface object.

    ``dtype`` selects the parameter precision: the default f32 is the
    device path; f64 (under ``jax.enable_x64``) is the accuracy-oracle path used
    by the error-budget tests (tests/test_accuracy.py).
    """
    def sc(v):
        return jnp.asarray(np.asarray(v, dtype=dtype))

    pos = np.asarray(surf.pos, dtype=dtype)
    base = {"pos": jnp.asarray(pos),
            "z_max_rel": sc(surf.z_max - surf.pos[2]),
            "z_min_rel": sc(surf.z_min - surf.pos[2])}

    if isinstance(surf, SlitSurface):
        params = dict(base, hw=sc(surf.dim[0] / 2), hh=sc(surf.dim[1] / 2),
                      hwi=sc(surf.dimi[0] / 2), hhi=sc(surf.dimi[1] / 2),
                      angle=sc(surf._angle))
        return SurfaceFns(params, _flat_hit_fn, _flat_normal_fn, _mask_slit_fn, "slit", True)

    if isinstance(surf, RectangularSurface):
        params = dict(base, hw=sc(surf.dim[0] / 2), hh=sc(surf.dim[1] / 2),
                      angle=sc(surf._angle))
        return SurfaceFns(params, _flat_hit_fn, _flat_normal_fn, _mask_rect_fn, "rect", True)

    if isinstance(surf, RingSurface):
        params = dict(base, r=sc(surf.r), ri=sc(surf.ri))
        return SurfaceFns(params, _flat_hit_fn, _flat_normal_fn, _mask_ring_fn, "ring", True)

    if isinstance(surf, AsphericSurface):
        ncoeff = len(surf.coeff)

        def asph_hit(params, o, s):
            def sag(x, y):
                return geom.sag_asphere(x, y, params["rho"], params["k"],
                                        [params["coeff"][i] for i in range(ncoeff)])
            return geom.hit_newton(sag, o, s, params["z_min_rel"], params["z_max_rel"])

        def asph_normal(params, x, y):
            return geom.normal_asphere(x, y, params["rho"], params["k"],
                                       [params["coeff"][i] for i in range(ncoeff)])

        params = dict(base, r=sc(surf.r), rho=sc(1.0 / surf.R),
                      k=sc(surf.k),
                      coeff=sc(surf.coeff))
        return SurfaceFns(params, asph_hit, asph_normal, _mask_circle_fn, "asphere", False)

    if isinstance(surf, ConicSurface):   # includes SphericalSurface
        def conic_hit(params, o, s):
            t, valid = geom.hit_conic(o, s, params["rho"], params["k"],
                                      params["z_min_rel"], params["z_max_rel"])
            return t, valid, jnp.zeros(t.shape, dtype=bool)

        def conic_normal(params, x, y):
            return geom.normal_conic(x, y, params["rho"], params["k"])

        params = dict(base, r=sc(surf.r), rho=sc(1.0 / surf.R),
                      k=sc(surf.k))
        return SurfaceFns(params, conic_hit, conic_normal, _mask_circle_fn, "conic", False)

    if isinstance(surf, TiltedSurface):
        def tilt_hit(params, o, s):
            n = params["normal"]
            num = -(o[..., 0] * n[0] + o[..., 1] * n[1] + o[..., 2] * n[2])
            den = s[..., 0] * n[0] + s[..., 1] * n[1] + s[..., 2] * n[2]
            t = num / den
            valid = jnp.isfinite(t) & (den != 0)
            return t, valid, jnp.zeros(t.shape, dtype=bool)

        def tilt_normal(params, x, y):
            return jnp.broadcast_to(params["normal"], (*jnp.asarray(x).shape, 3))

        params = dict(base, r=sc(surf.r),
                      normal=sc(surf.normal))
        return SurfaceFns(params, tilt_hit, tilt_normal, _mask_circle_fn, "tilted", False)

    if isinstance(surf, CircularSurface):
        params = dict(base, r=sc(surf.r))
        return SurfaceFns(params, _flat_hit_fn, _flat_normal_fn, _mask_circle_fn, "circle", True)

    # generic curved surface (FunctionSurface, DataSurface): Newton over the
    # object's jnp sag closure; params carry only pos/extent (user funcs and
    # spline grids stay baked in the closure)
    if surf.is_flat():
        params = dict(base, r=sc(surf.r))
        return SurfaceFns(params, _flat_hit_fn, _flat_normal_fn, _mask_circle_fn, "flat", True)

    def gen_hit(params, o, s):
        return geom.hit_newton(surf._sag, o, s, params["z_min_rel"], params["z_max_rel"])

    def gen_normal(params, x, y):
        return surf._normals_rel(x, y)

    def gen_mask(params, x, y):
        m = geom.mask_circle(x, y, params["r"])
        if getattr(surf, "mask_func", None) is not None:
            if surf._1D:
                m = m & jnp.asarray(surf.mask_func(jnp.sqrt(x * x + y * y), **surf.mask_args), dtype=bool)
            else:
                m = m & jnp.asarray(surf.mask_func(x, y, **surf.mask_args), dtype=bool)
        return m

    params = dict(base, r=sc(surf.r))
    return SurfaceFns(params, gen_hit, gen_normal, gen_mask, "generic", False)

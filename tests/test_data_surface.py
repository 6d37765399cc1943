"""DataSurface oracle tests (VERDICT #6 / reference test philosophy
docs/source/development/testing.rst:24-54): a user-defined data surface
that models a sphere must behave identically to the built-in sphere —
in sag, normals, hit finding, and end-to-end imaging (lens-maker focal
length via focus_search, reference tests/test_tracer.py:888-918).

Also the hit-solver residual checks from VERDICT weak #8: the fixed-
iteration bracketed solve must land within the f32 accuracy floor for
every curved surface type.
"""

import numpy as np
import pytest
import jax.numpy as jnp

import optrace_tpu as ot
from optrace_tpu.ops import geom


R_SPHERE = 50.0
R_AP = 3.0


def _sphere_sag(rr, R=R_SPHERE):
    rho = 1.0 / R
    return rho * rr ** 2 / (1.0 + np.sqrt(1.0 - rho ** 2 * rr ** 2))


@pytest.fixture(scope="module")
def sphere_surfaces():
    xy = np.linspace(-R_AP, R_AP, 300)
    X, Y = np.meshgrid(xy, xy)
    Z = _sphere_sag(np.hypot(X, Y))
    with ot.global_options.no_warnings():
        d2 = ot.DataSurface2D(r=R_AP, data=Z.T)
        d1 = ot.DataSurface1D(r=R_AP, data=_sphere_sag(np.linspace(0, R_AP, 300)))
    ana = ot.SphericalSurface(r=R_AP, R=R_SPHERE)
    return d2, d1, ana


class TestDataSphereEquivalence:

    def test_sag_parity(self, sphere_surfaces, rng):
        d2, d1, ana = sphere_surfaces
        q = rng.uniform(-0.7 * R_AP, 0.7 * R_AP, (5000, 2))
        za = ana.values(q[:, 0], q[:, 1])
        assert np.abs(d2.values(q[:, 0], q[:, 1]) - za).max() < 1e-6
        assert np.abs(d1.values(q[:, 0], q[:, 1]) - za).max() < 1e-6

    def test_normal_parity(self, sphere_surfaces, rng):
        d2, d1, ana = sphere_surfaces
        q = rng.uniform(-0.7 * R_AP, 0.7 * R_AP, (5000, 2))
        na = ana.normals(q[:, 0], q[:, 1])
        assert np.abs(d2.normals(q[:, 0], q[:, 1]) - na).max() < 5e-6
        assert np.abs(d1.normals(q[:, 0], q[:, 1]) - na).max() < 5e-6

    def test_hit_parity(self, sphere_surfaces, rng):
        d2, d1, ana = sphere_surfaces
        N = 4000
        p = np.column_stack([rng.uniform(-2, 2, (N, 2)), np.full(N, -5.0)])
        s = np.column_stack([rng.uniform(-0.05, 0.05, (N, 2)), np.ones(N)])
        s /= np.linalg.norm(s, axis=1, keepdims=True)
        pa, ha, _ = ana.find_hit(p, s)
        for surf in (d2, d1):
            ph, h, _ = surf.find_hit(p, s)
            assert (h == ha).all()
            assert np.abs(ph - pa).max() < 1e-5     # f32 floor over a 5 mm throw

    def test_flip_negates_sag(self, sphere_surfaces, rng):
        d2, _, ana = sphere_surfaces
        xy = np.linspace(-R_AP, R_AP, 300)
        X, Y = np.meshgrid(xy, xy)
        Z = _sphere_sag(np.hypot(X, Y))
        with ot.global_options.no_warnings():
            d = ot.DataSurface2D(r=R_AP, data=Z.T)
        d.flip()
        q = rng.uniform(-0.7 * R_AP, 0.7 * R_AP, (2000, 2))
        assert np.allclose(d.values(q[:, 0], q[:, 1]),
                           -ana.values(q[:, 0], q[:, 1]), atol=1e-6)

    def test_asymmetric_rotate_roundtrip(self, rng):
        xy = np.linspace(-R_AP, R_AP, 220)
        X, Y = np.meshgrid(xy, xy)
        Z = 0.01 * X ** 2 + 0.03 * Y ** 2          # astigmatic, x along rows
        with ot.global_options.no_warnings():
            d = ot.DataSurface2D(r=R_AP, data=Z.T)
        q = rng.uniform(-2, 2, (1000, 2))
        z0 = d.values(q[:, 0], q[:, 1])
        d.rotate(90)
        z90 = d.values(q[:, 0], q[:, 1])
        # rotating the saddle by 90° swaps the coefficients
        assert np.allclose(z90, 0.03 * q[:, 0] ** 2 + 0.01 * q[:, 1] ** 2, atol=1e-5)
        d.rotate(270)
        assert np.allclose(d.values(q[:, 0], q[:, 1]), z0, atol=1e-7)

    def test_lens_maker_focus(self, sphere_surfaces):
        """End-to-end: plano-convex lens with a data-sphere front focuses at
        the lens-maker focal length (reference tests/test_tracer.py:888-918)."""
        d2, _, _ = sphere_surfaces
        n = ot.RefractionIndex("Constant", n=1.5)
        back = ot.CircularSurface(r=R_AP)
        d_lens = 1.0
        RT = ot.Raytracer(outline=[-10, 10, -10, 10, -10, 200])
        RT.add(ot.RaySource(ot.CircularSurface(r=2.0), spectrum=ot.LightSpectrum("Monochromatic", wl=550.),
                            pos=[0, 0, -5], s=[0, 0, 1]))
        RT.add(ot.Lens(d2, back, n=n, de=d_lens, pos=[0, 0, 0]))
        RT.trace(50000)

        # f from the system TMA of the equivalent analytic lens
        ana_lens = ot.Lens(ot.SphericalSurface(r=R_AP, R=R_SPHERE),
                           ot.CircularSurface(r=R_AP), n=n, de=d_lens, pos=[0, 0, 0])
        tma = ot.TMA([ana_lens])
        f_expect = tma.efl

        res, _ = RT.focus_search("RMS Spot Size", z_start=float(f_expect))
        # spherical aberration shifts the MC focus slightly; 1% tolerance
        assert abs(res.x - tma.focal_points[1]) < 0.01 * f_expect


class TestHitResiduals:
    """VERDICT weak #8: assert the accuracy claim of the fixed-iteration
    solver per curved surface type via the sag residual
    |z_hit − sag(x_hit, y_hit)| at the returned intersection.

    Two regimes: in f32 (the device path) the floor is coefficient rounding
    ∝ ε·throw (≈3e-6 mm over the 14 mm throw here — NOT solver error);
    in f64 the solver itself must converge below the reference's
    C_EPS = 1e-6 mm claim (surface.py:17) with margin.
    """

    def _residual(self, surf, rng, N=3000, x64=False):
        import jax
        p = np.column_stack([rng.uniform(-1.5, 1.5, (N, 2)), np.full(N, -4.0)])
        s = np.column_stack([rng.uniform(-0.1, 0.1, (N, 2)), np.ones(N)])
        s /= np.linalg.norm(s, axis=1, keepdims=True)

        def compute():
            ph, hit, _ = surf.find_hit(p, s)
            rel = ph - surf.pos
            sag = np.asarray(surf._sag(jnp.asarray(rel[:, 0]), jnp.asarray(rel[:, 1])),
                             dtype=np.float64)
            assert hit.sum() > N // 2
            return np.abs(rel[:, 2] - sag)[hit].max()

        if x64:
            with jax.enable_x64():
                return compute()
        return compute()

    def test_conic(self, rng):
        surf = ot.ConicSurface(r=R_AP, R=12.0, k=-0.7)
        surf.move_to([0, 0, 10.0])
        assert self._residual(surf, rng) < 5e-6           # f32 floor @ 14 mm throw
        assert self._residual(surf, rng, x64=True) < 1e-9  # true solver accuracy

    def test_asphere(self, rng):
        surf = ot.AsphericSurface(r=R_AP, R=15.0, k=0.3, coeff=[1e-4, -2e-6])
        surf.move_to([0, 0, 10.0])
        assert self._residual(surf, rng) < 2e-6
        assert self._residual(surf, rng, x64=True) < 1e-9

    def test_data_surface(self, sphere_surfaces, rng):
        d2, d1, _ = sphere_surfaces
        assert self._residual(d2, rng) < 2e-6
        assert self._residual(d1, rng) < 2e-6

    def test_function_surface(self, rng):
        surf = ot.FunctionSurface1D(r=R_AP, func=lambda r: r ** 2 / 40.0,
                                    z_min=0, z_max=R_AP ** 2 / 40.0)
        surf.move_to([0, 0, 10.0])
        assert self._residual(surf, rng) < 2e-6
        assert self._residual(surf, rng, x64=True) < 1e-9

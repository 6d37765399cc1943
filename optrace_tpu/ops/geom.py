"""Ray-surface intersection kernels (functional core).

Rebuild of the per-surface-type hit/normal/sag math in
``optrace/tracer/geometry/surface/`` (SURVEY.md §2.4). Everything here is a
pure, branchless jnp function over ray bundles, vectorized on the leading
axis and jit/vmap/grad-safe:

- coordinates are *relative to the surface vertex* (o = p − pos), which is
  also the f32 accuracy trick: sag values and transverse coordinates stay
  O(aperture) instead of O(system length);
- the reference's data-dependent regula-falsi loop
  (surface.py:307-414) becomes a fixed-iteration bracketed
  bisection/Newton hybrid with convergence masks — XLA unrolls it;
- no-hit / behind-surface cases are signalled via flags, the caller
  implements the reference's "clamp to z_max plane" bookkeeping
  (surface.py:436-479, conic_surface.py:126-203).
"""

import jax.numpy as jnp
import jax

C_EPS = 1e-6    #: hit precision in mm (reference surface.py:17)
N_EPS = 1e-10   #: numerical epsilon (reference surface.py:20)


# ----------------------------------------------------------------------
# sag functions (relative coords, z measured from vertex)

def _safe_sqrt(x, valid=None):
    """sqrt that never produces nan/inf *gradients*: the argument is pushed
    away from ≤0 before the sqrt (the jnp.where-both-branches pitfall).
    Host inputs evaluate in numpy (surface construction calls these with
    python floats; ops/xp.py)."""
    from .xp import get_xp
    xp = get_xp(x, valid)
    if valid is None:
        valid = x > 0
    r = xp.sqrt(xp.where(valid, x, 1.0))
    return xp.where(valid, r, 0.0)


def sag_conic(x, y, rho, k):
    """Conic-section sag z(r) = ρr² / (1 + √(1−(k+1)ρ²r²))
    (standard conicoid equation, reference conic_surface.py:57-68)."""
    r2 = x * x + y * y
    root = _safe_sqrt(1.0 - (k + 1.0) * rho * rho * r2)
    return rho * r2 / (1.0 + root)


def sag_conic_radial(r2, rho, k):
    """Conic sag as function of r²."""
    root = _safe_sqrt(1.0 - (k + 1.0) * rho * rho * r2)
    return rho * r2 / (1.0 + root)


def sag_asphere(x, y, rho, k, coeffs):
    """Even asphere: conic + Σ aᵢ·r^(2(i+1)) over the polynomial coefficients
    (reference aspheric_surface.py:51-82: polynomial starts at r²)."""
    r2 = x * x + y * y
    z = sag_conic_radial(r2, rho, k)
    # Horner in r²: a0*r2 + a1*r2² + ...
    poly = jnp.zeros_like(r2)
    for c in coeffs[::-1]:
        poly = poly * r2 + c
    return z + poly * r2


def dsag_conic_dr(r, rho, k):
    """Radial derivative m = dz/dr = ρr/√(1−(k+1)ρ²r²)."""
    root = jnp.sqrt(jnp.maximum(1.0 - (k + 1.0) * rho * rho * r * r, N_EPS))
    return rho * r / root


def dsag_asphere_dr(r, rho, k, coeffs):
    """Radial derivative of the even asphere."""
    r2 = r * r
    # d/dr Σ aᵢ r^(2(i+1)) = Σ 2(i+1) aᵢ r^(2i+1)
    dpoly = jnp.zeros_like(r2)
    n = len(coeffs)
    for i in range(n - 1, -1, -1):
        dpoly = dpoly * r2 + 2.0 * (i + 1.0) * coeffs[i]
    return dsag_conic_dr(r, rho, k) + dpoly * r


# ----------------------------------------------------------------------
# normals (unit vectors, +z oriented)

def normal_flat(x, y):
    z = jnp.zeros_like(x)
    return jnp.stack([z, z, jnp.ones_like(x)], axis=-1)


def normal_conic(x, y, rho, k):
    """Analytic conic normal: n_r = −ρr/√(1−kρ²r²), n_z = √(1−n_r²)
    (reference conic_surface.py:70-124). Host inputs evaluate in numpy
    (ops/xp.py)."""
    from .xp import get_xp
    xp = get_xp(x, y, rho, k)
    r2 = x * x + y * y
    arg = 1.0 - k * rho * rho * r2
    denom = xp.sqrt(xp.where(arg > N_EPS, arg, N_EPS))
    nx = -rho * x / denom
    ny = -rho * y / denom
    arg_z = 1.0 - (nx * nx + ny * ny)
    nz = xp.sqrt(xp.where(arg_z > N_EPS, arg_z, N_EPS))
    return xp.stack([nx, ny, nz], axis=-1)


def normal_from_radial_deriv(x, y, m_over_r):
    """Normal from radial slope divided by radius: for rotationally symmetric
    sag with m = dz/dr, n ∝ (−(m/r)x, −(m/r)y, 1)."""
    nx = -m_over_r * x
    ny = -m_over_r * y
    nz = jnp.ones_like(x)
    inv = 1.0 / jnp.sqrt(nx * nx + ny * ny + 1.0)
    return jnp.stack([nx * inv, ny * inv, nz * inv], axis=-1)


def normal_asphere(x, y, rho, k, coeffs):
    r = jnp.sqrt(jnp.maximum(x * x + y * y, N_EPS * N_EPS))
    m = dsag_asphere_dr(r, rho, k, coeffs)
    return normal_from_radial_deriv(x, y, m / r)


def normal_numeric(sag_fn, x, y):
    """Exact surface normal via forward-mode autodiff of the sag function.

    Replaces the reference's central-difference estimate
    (surface.py:247-285, step h* = (3·ε·50)^(1/3)): user sag functions are
    jnp-traceable by contract, so two jvp evaluations give machine-exact
    partials at any dtype — in f32 a central difference at the reference's
    step loses ~3 digits to cancellation (normal error ~1e-3), which is
    trace-visible on steep user surfaces. The name is kept for the callers
    ('numeric' = no user-provided analytic derivative needed).
    """
    x = jnp.asarray(x)
    y = jnp.asarray(y)
    _, dzdx = jax.jvp(lambda xx: sag_fn(xx, y), (x,), (jnp.ones_like(x),))
    _, dzdy = jax.jvp(lambda yy: sag_fn(x, yy), (y,), (jnp.ones_like(y),))
    n = jnp.stack([-dzdx, -dzdy, jnp.ones_like(x)], axis=-1)
    return n / jnp.linalg.norm(n, axis=-1, keepdims=True)


# ----------------------------------------------------------------------
# aperture masks (relative transverse coords)

def mask_circle(x, y, r):
    return x * x + y * y <= (r + N_EPS) ** 2


def mask_ring(x, y, ri, r):
    r2 = x * x + y * y
    return (r2 <= (r + N_EPS) ** 2) & (r2 >= (ri - N_EPS) ** 2)


def _rotate2d(x, y, angle_rad):
    c, s = jnp.cos(angle_rad), jnp.sin(angle_rad)
    return x * c + y * s, -x * s + y * c


def mask_rect(x, y, half_w, half_h, angle_rad=0.0):
    xr, yr = _rotate2d(x, y, angle_rad)
    return (jnp.abs(xr) <= half_w + N_EPS) & (jnp.abs(yr) <= half_h + N_EPS)


def mask_slit(x, y, half_w, half_h, half_wi, half_hi, angle_rad=0.0):
    xr, yr = _rotate2d(x, y, angle_rad)
    outer = (jnp.abs(xr) <= half_w + N_EPS) & (jnp.abs(yr) <= half_h + N_EPS)
    inner = (jnp.abs(xr) < half_wi - N_EPS) & (jnp.abs(yr) < half_hi - N_EPS)
    return outer & ~inner


# ----------------------------------------------------------------------
# hits (relative coords o = p − pos; t is the ray parameter)

def hit_plane(o, s):
    """Intersection with the plane z=0 (through the vertex). sz=0 rays
    (e.g. dead zero-length segments) give t=inf with a finite VJP."""
    sz = s[..., 2]
    ok = sz != 0
    t = -o[..., 2] / jnp.where(ok, sz, 1.0)
    return jnp.where(ok, t, jnp.inf)


def hit_tilted(o, s, n):
    """Intersection with the plane through the vertex with unit normal n."""
    num = -(o[..., 0] * n[0] + o[..., 1] * n[1] + o[..., 2] * n[2])
    den = s[..., 0] * n[0] + s[..., 1] * n[1] + s[..., 2] * n[2]
    ok = den != 0
    t = num / jnp.where(ok, den, 1.0)
    return jnp.where(ok, t, jnp.inf)


def hit_conic(o, s, rho, k, z_min_rel, z_max_rel):
    """Closed-form conic intersection.

    Solves the quadratic A t² + 2B t + C = 0 of ray and conicoid and picks
    the forward root whose z lies inside [z_min_rel, z_max_rel] (same
    selection rule as reference conic_surface.py:126-203). Returns
    (t, valid): valid=False where no surface-function hit exists (caller
    clamps to the z_max plane and marks no-hit).
    """
    ox, oy, oz = o[..., 0], o[..., 1], o[..., 2]
    sx, sy, sz = s[..., 0], s[..., 1], s[..., 2]

    A = 1.0 + k * sz * sz
    B = sx * ox + sy * oy + sz * (oz * (k + 1.0) - 1.0 / rho)
    C = ox * ox + oy * oy + oz * (oz * (k + 1.0) - 2.0 / rho)

    disc = B * B - C * A
    has_root = disc >= 0.0
    D = _safe_sqrt(disc, has_root)

    # f32-stable root pairing: q = −(B + sign(B)·D) has no cancellation;
    # the partner root follows from Vieta t₁t₂ = C/A as C/q (Citardauq),
    # avoiding the (−B+D)/A cancellation that costs ~6 digits near B²≫CA
    sgnB = jnp.where(B >= 0, 1.0, -1.0)
    q = -(B + sgnB * D)
    safe_A = jnp.where(jnp.abs(A) > N_EPS, A, 1.0)
    safe_q = jnp.where(jnp.abs(q) > N_EPS, q, 1.0)
    t1 = jnp.where(jnp.abs(A) > N_EPS, q / safe_A, jnp.inf)
    t2 = jnp.where(jnp.abs(q) > N_EPS, C / safe_q, jnp.inf)

    # linear case A≈0, B≠0: single root
    t_lin = -C / (2.0 * jnp.where(jnp.abs(B) > N_EPS, B, 1.0))
    lin = (jnp.abs(A) <= N_EPS) & (jnp.abs(B) > N_EPS)
    t1 = jnp.where(lin, t_lin, t1)
    t2 = jnp.where(lin, t_lin, t2)

    z1 = oz + sz * t1
    z2 = oz + sz * t2
    lo, hi = z_min_rel - N_EPS, z_max_rel + N_EPS
    # forward test with a C_EPS backward tolerance: rays restarting ON a
    # surface (cemented doublets are 1e-7 mm apart in ZEMAX files) carry
    # f32 jitter ~1e-8 mm that an exact z >= oz would misread as backward
    # and absorb the ray (the reference's exact test only survives because
    # its f64 jitter is ~1e-13, conic_surface.py:158-164)
    fw = oz - C_EPS
    ok1 = (lo <= z1) & (z1 <= hi) & (z1 >= fw) & jnp.isfinite(t1)
    ok2 = (lo <= z2) & (z2 <= hi) & (z2 >= fw) & jnp.isfinite(t2)

    # prefer the forward in-range root, smaller t when both qualify; accept
    # the CHOSEN root by its z-range like the reference (:166-192)
    use1 = ok1 & ~(ok2 & (t2 < t1))
    t = jnp.where(use1, t1, t2)
    z_sel = jnp.where(use1, z1, z2)
    in_range = (lo <= z_sel) & (z_sel <= hi) & jnp.isfinite(t)
    valid = has_root & in_range & ~(lin & (jnp.abs(B) <= N_EPS))

    # one Newton polish on Q(t)=At²+2Bt+C mops up the remaining f32
    # rounding of the root (residual drops ~5× at long throws).
    # Guard RELATIVELY: at a root |Q'| = 2D, so near-tangent rays
    # (disc≈0, double root) have Q' at the f32 noise floor of its own
    # terms and the step Qv/Qp is noise/noise — skip the polish there.
    # The accepted step is also clamped and re-validated against the
    # z-range so a bad step can never displace a valid hit.
    Qp = 2.0 * (A * t + B)
    Qv = (A * t + 2.0 * B) * t + C
    scale = jnp.abs(A * t) + jnp.abs(B)
    ok_p = valid & (jnp.abs(Qp) > 1e-5 * scale + N_EPS) & jnp.isfinite(t)
    step = jnp.clip(Qv / jnp.where(ok_p, Qp, 1.0), -1e-3, 1e-3)
    t_pol = t - step
    z_pol = oz + sz * t_pol
    ok_p = ok_p & (lo <= z_pol) & (z_pol <= hi)
    t = jnp.where(ok_p, t_pol, t)
    return t, valid


def hit_newton(sag_fn, o, s, z_min_rel, z_max_rel, iters: int = 40):
    """Bracketed bisection/false-position hybrid for general sag surfaces.

    Fixed-iteration replacement for the reference's regula falsi
    (surface.py:307-414): F(t) = oz + t·sz − sag(ox+t·sx, oy+t·sy), root
    bracketed in [t(z_min−ε), t(z_max+ε)]. Each step takes the Illinois
    false-position estimate, safeguarded by bisection when it leaves the
    bracket. 40 iterations shrink any mm-scale bracket below C_EPS.

    Returns (t, valid, ill): ill flags brackets without a sign change
    (reference ILL_COND counter).
    """
    ox, oy, oz = o[..., 0], o[..., 1], o[..., 2]
    sx, sy, sz = s[..., 0], s[..., 1], s[..., 2]

    def F(t):
        return oz + t * sz - sag_fn(ox + t * sx, oy + t * sy)

    eps = C_EPS / 10.0
    t1 = (z_min_rel - eps - oz) / sz
    t1 = jnp.maximum(t1, -C_EPS)       # can't move backwards (reference :335)
    t2 = (z_max_rel + eps - oz) / sz

    f1 = F(t1)
    f2 = F(t2)
    ill = f1 * f2 > 0.0

    def body(i, carry):
        t1, t2, f1, f2 = carry
        # Illinois secant estimate, safeguarded into the bracket interior
        denom = jnp.where(jnp.abs(f2 - f1) > N_EPS, f2 - f1, 1.0)
        ts = t1 - f1 / denom * (t2 - t1)
        mid = 0.5 * (t1 + t2)
        inside = (ts > jnp.minimum(t1, t2)) & (ts < jnp.maximum(t1, t2))
        ts = jnp.where(inside, ts, mid)
        fs = F(ts)
        # keep the sub-bracket containing the sign change
        use_left = f1 * fs <= 0.0
        nt1 = jnp.where(use_left, t1, ts)
        nf1 = jnp.where(use_left, 0.5 * f1, fs)   # Illinois contraction m=0.5
        nt2 = jnp.where(use_left, ts, t2)
        nf2 = jnp.where(use_left, fs, 0.5 * f2)
        return nt1, nt2, nf1, nf2

    t1, t2, f1, f2 = jax.lax.fori_loop(0, iters, body, (t1, t2, f1, f2))
    t = 0.5 * (t1 + t2)
    valid = jnp.isfinite(t) & ~ill
    return t, valid, ill


ADVANCE_STANDOFF = 1.0   # mm of free flight kept before the surface


def advance_to_standoff(p, s, z_min_rel, active):
    """Recondition distant ray origins before a hit solve: advance each ray
    along its own line to the plane ADVANCE_STANDOFF before the surface's
    z-extent. A pure reparameterization (the line is unchanged), but it
    removes the O(ulp(oz²)) cancellation that wrecks the f32 quadratic and
    Newton solves when the previous section is far away — a source 50 m
    from the first lens otherwise loses hits to ~mm-scale root noise, and
    the advance itself is benign: t0 = (z_floor−oz)/sz carries only
    one ulp(|oz|) ≈ 4 µm of longitudinal and |t0·s_xy|·eps ≈ 4e-6 mm of
    lateral rounding.
    """
    sz = s[..., 2]
    ok = active & (sz != 0)
    z_floor = z_min_rel - ADVANCE_STANDOFF
    t0 = (z_floor - p[..., 2]) / jnp.where(ok, sz, 1.0)
    adv = ok & (t0 > 0)
    return jnp.where(adv[..., None], p + t0[..., None] * s, p)


def clamp_abnormal(o, s, t, valid_surface, z_max_rel):
    """Post-hit bookkeeping shared by all surface kinds.

    Implements reference ``_find_hit_handle_abnormal`` (surface.py:436-479)
    branchlessly in relative coordinates:

    - ray starts after the surface z-extent ("beh") → stays in place, no hit
    - no surface hit, backwards hit, or z-deviation ("bet") → intersect the
      z = z_max plane, no hit

    Returns (t_out, is_hit_possible, broken) where is_hit_possible must
    still be AND-ed with the aperture mask at the hit point by the caller,
    and broken counts "Broken sequentiality" rays.
    """
    oz = o[..., 2]
    sz = s[..., 2]
    t_fin = jnp.isfinite(t)
    t_safe = jnp.where(t_fin, t, 0.0)
    z_hit = oz + t_safe * sz

    beh = oz > z_max_rel + N_EPS
    neg = z_hit < oz - C_EPS
    bad = ~valid_surface | neg | ~t_fin

    sz_ok = sz != 0
    t_zmax = (z_max_rel - oz) / jnp.where(sz_ok, sz, 1.0)
    t_zmax = jnp.where(sz_ok, t_zmax, 0.0)
    t_out = jnp.where(bad & ~beh, t_zmax, t_safe)
    t_out = jnp.where(beh, 0.0, t_out)

    ok = ~(bad | beh)
    return t_out, ok, (bad & ~beh) | beh

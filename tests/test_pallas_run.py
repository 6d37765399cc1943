"""Scene-level checks of the trace: the f32 path (scanned conic runs,
unrolled everything else) against the f64 oracle — the same scene
compiled with f64 parameters and fed the identical ray bundle — plus
scanned-against-unrolled parity and gradient paths. The tests marked
``gpu`` run on the card (``python chip_smoke.py`` runs them)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

import optrace_tpu as ot
from optrace_tpu.tracer import trace_core as tc
from optrace_tpu.tracer.trace_core import trace_bundle


def _rays(RT, N, seed=1):
    """f64 source bundle of ``RT`` (host arrays) and the outline."""
    with ot.global_options.no_warnings():
        assert not RT._pretrace_check(N)
    RT.rays.init(RT.ray_sources, N, len(RT.tracing_surfaces) + 2, RT.no_pol)
    with jax.enable_x64():
        gen = RT._make_source_fn(N)
        rays = [np.asarray(a, np.float64) for a in gen(jax.random.PRNGKey(seed))]
    return rays, tuple(float(v) for v in RT.outline)


def _trace(RT, rays, outline, dtype):
    steps = RT._build_steps(dtype)
    out = trace_bundle(steps, RT.n0, outline,
                       *[jnp.asarray(a, dtype) for a in rays],
                       RT.no_pol, RT.use_hurb, key=jax.random.PRNGKey(1))
    return jax.tree_util.tree_map(
        lambda a: None if a is None else np.asarray(a, np.float64), out)


def trace_f32_f64(build, N):
    """Trace one scene in f32 (the production path) and in f64 (the
    oracle) from the same f64 ray bundle. Returns (out64, out32)."""
    RT = build()
    rays, outline = _rays(RT, N)
    with jax.enable_x64():
        out64 = _trace(RT, rays, outline, np.float64)
    return out64, _trace(RT, rays, outline, np.float32)


def _assert_f64_parity(a, b, N, atol_p=2e-4):
    """f32 sections ``b`` against the f64 oracle ``a``: rays alive in both
    agree to a few f32 ulps of an absolute coordinate; weights, the
    alive/dead split and the INFOS counters agree up to threshold flips
    at aperture edges (at most 0.1 % of the rays)."""
    both = (a["w"] > 0) & (b["w"] > 0)
    dp = np.abs(a["p"] - b["p"]).max(axis=-1)
    assert both.any()
    assert (dp[both] <= atol_p + 1e-6 * np.abs(a["p"]).max(axis=-1)[both]).all()
    np.testing.assert_allclose(b["w"], a["w"], atol=1e-4)
    flips = ((a["w"] > 0) != (b["w"] > 0)).sum(axis=0).max()
    assert flips <= max(2, 1e-3 * N), flips
    assert np.abs(a["infos"] - b["infos"]).max() <= max(2, 1e-3 * N)


def trace_scan_unrolled(build, N, monkeypatch):
    """Trace one scene with its conic runs scanned (the default) and with
    every step unrolled (MIN_SCAN_RUN beyond the step count), in f32 from
    the same bundle. Returns (out_scan, out_unrolled)."""
    RT = build()
    rays, outline = _rays(RT, N)
    steps = RT._build_steps()
    assert any(k == "scan" for k, _ in tc._partition_runs(steps, []))
    out_scan = _trace(RT, rays, outline, np.float32)
    monkeypatch.setattr(tc, "MIN_SCAN_RUN", len(steps) + 1)
    assert all(k == "step" for k, _ in tc._partition_runs(steps, []))
    return out_scan, _trace(RT, rays, outline, np.float32)


def _assert_path_parity(a, b, atol_p=2e-5):
    np.testing.assert_allclose(a["p"], b["p"], rtol=5e-6, atol=atol_p)
    np.testing.assert_allclose(a["w"], b["w"], atol=1e-6)
    assert (a["infos"] == b["infos"]).all()


def _build(with_flats=True):
    RT = ot.Raytracer(outline=[-10, 10, -10, 10, -10, 80], no_pol=True)
    RT.add(ot.RaySource(ot.CircularSurface(r=1.5), divergence="Lambertian",
                        div_angle=8, pos=[0, 0, -5],
                        spectrum=ot.presets.light_spectrum.d65))
    n1 = ot.presets.refraction_index.BK7
    n2 = ot.presets.refraction_index.F2
    RT.add(ot.Lens(ot.SphericalSurface(r=3, R=20), ot.SphericalSurface(r=3, R=-25),
                   n=n1, pos=[0, 0, 0], d=1.0))
    back = ot.CircularSurface(r=3) if with_flats else ot.SphericalSurface(r=3, R=-40)
    RT.add(ot.Lens(ot.ConicSurface(r=3, R=30, k=-0.5), back,
                   n=n2, pos=[0, 0, 5], d=0.8))
    RT.add(ot.Lens(ot.SphericalSurface(r=3, R=15), ot.SphericalSurface(r=3, R=-15),
                   n=n1, pos=[0, 0, 10], d=1.2))
    RT.add(ot.Detector(ot.RectangularSurface(dim=[8, 8]), pos=[0, 0, 40]))
    return RT


@pytest.mark.parametrize("with_flats", [True, False])
def test_run_kernel_matches_xla_scan(with_flats):
    """Stored sections, weights and INFOS counters of the f32 trace (conic
    runs scanned) agree with the f64 oracle."""
    N = 20000
    a, b = trace_f32_f64(lambda: _build(with_flats), N)
    assert a["p"].shape == b["p"].shape
    _assert_f64_parity(a, b, N)


def test_detector_image_parity():
    """The detector image rendered from the f32 sections matches the one
    rendered from the f64 oracle's sections."""
    from optrace_tpu.ops.binning import bin_xyzw
    from optrace_tpu.tracer.detector import detector_hits, build_segment_mask
    from optrace_tpu.tracer.scene_compile import compile_surface

    RT = _build()
    dsurf = RT.detectors[0].surface
    sfns = compile_surface(dsurf)
    z0 = float(dsurf.z_min)
    seg = build_segment_mask(RT._section_z_bounds(), z0, float(dsurf.z_max))
    a, b = trace_f32_f64(_build, 30000)
    imgs = []
    for out in (a, b):
        ph, wsel, hit, _ = detector_hits(sfns, z0, out["p"].astype(np.float32),
                                         out["w"].astype(np.float32),
                                         segment_mask=seg)
        wm = jnp.where(hit, wsel, 0.0)
        imgs.append(np.asarray(bin_xyzw(ph[:, 0], ph[:, 1], wm,
                                        out["wl"].astype(np.float32),
                                        63, 63, (-3.0, 3.0, -3.0, 3.0))))
    tot = imgs[0][..., 3].sum()
    assert tot > 0
    assert imgs[1][..., 3].sum() == pytest.approx(tot, rel=1e-4)
    assert np.abs(imgs[0][..., 3] - imgs[1][..., 3]).sum() <= 1e-3 * tot


def _media_steps(steps, dn):
    def wrap(f):
        return None if f is None else (lambda wl_: f(wl_) + dn)
    return [st._replace(n1_fn=wrap(st.n1_fn), n2_fn=wrap(st.n2_fn))
            for st in steps]


def _bundle(RT, N=512):
    RT.rays.init(RT.ray_sources, N, len(RT.tracing_surfaces) + 2, True)
    steps = RT._build_steps()
    gen = RT._make_source_fn(N)
    p, s, pols, w, wl = gen(jax.random.PRNGKey(0))
    return steps, (p, s, pols, w, wl), tuple(float(v) for v in RT.outline)


def _bundle(RT, N=512):
    RT.rays.init(RT.ray_sources, N, len(RT.tracing_surfaces) + 2, True)
    steps = RT._build_steps()
    gen = RT._make_source_fn(N)
    p, s, pols, w, wl = gen(jax.random.PRNGKey(0))
    return steps, (p, s, pols, w, wl), tuple(float(v) for v in RT.outline)


def test_diff_path_keeps_xla_scan():
    """Traced surface parameters (the differentiable-design path) flow
    through the scanned runs and give finite, non-zero gradients."""
    RT = _build(with_flats=False)
    steps, (p, s, pols, w, wl), outline = _bundle(RT, 256)
    params0 = [st.sfns.params for st in steps]

    def loss(params):
        steps_p = [st._replace(sfns=st.sfns._replace(params=q))
                   for st, q in zip(steps, params)]
        out = trace_bundle(steps_p, RT.n0, outline, p, s, pols, w, wl,
                           True, False)
        return jnp.sum(out["p"][:, -1, 0] ** 2 * out["w"][:, -2])

    assert "scan" in str(jax.make_jaxpr(loss)(params0))
    g = jax.grad(loss)(params0)
    leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(g)]
    assert all(np.isfinite(x).all() for x in leaves)
    assert any(np.abs(x).max() > 0 for x in leaves)


def test_chunked_dispatch_parity(monkeypatch):
    """Scanned conic runs against the same steps unrolled one by one:
    identical physics, so sections, weights and counters agree to f32
    rounding."""
    a, b = trace_scan_unrolled(lambda: _build(with_flats=True), 15000,
                               monkeypatch)
    _assert_path_parity(a, b)


@pytest.mark.parametrize("no_pol", [True, False])
def test_outline_exit_scene_parity(no_pol):
    """Scene whose lens apertures poke past the outline box (allowed with
    a warning, raytracer.py:213): rays hitting those zones must be
    outline-killed inside the scanned run exactly as the f64 oracle kills
    them — the branch no regular scene reaches."""
    from optrace_tpu.tracer.trace_core import OUTLINE_INTERSECTION

    def build_tight():
        RT = ot.Raytracer(outline=[-2.5, 2.5, -2.5, 2.5, -10, 80],
                          no_pol=no_pol)
        RT.add(ot.RaySource(ot.CircularSurface(r=1.5), divergence="Lambertian",
                            div_angle=25, pos=[0, 0, -5],
                            spectrum=ot.presets.light_spectrum.d65))
        n1 = ot.presets.refraction_index.BK7
        n2 = ot.presets.refraction_index.F2
        RT.add(ot.Lens(ot.SphericalSurface(r=3, R=20),
                       ot.SphericalSurface(r=3, R=-25),
                       n=n1, pos=[0, 0, 0], d=1.0))
        RT.add(ot.Lens(ot.ConicSurface(r=3, R=30, k=-0.5),
                       ot.CircularSurface(r=3),
                       n=n2, pos=[0, 0, 5], d=0.8))
        RT.add(ot.Lens(ot.SphericalSurface(r=3, R=15),
                       ot.SphericalSurface(r=3, R=-15),
                       n=n1, pos=[0, 0, 10], d=1.2))
        RT.add(ot.Detector(ot.RectangularSurface(dim=[4, 4]), pos=[0, 0, 40]))
        # the outside-outline geometry is deliberate here: tracing it is
        # exactly how the in-run outline branch becomes reachable
        RT._ignore_geometry_error = True
        return RT

    N = 20000
    a, b = trace_f32_f64(build_tight, N)
    # the in-run outline branch must actually fire (not only the end step)
    n_out = b["infos"][OUTLINE_INTERSECTION, 1:7].sum()
    assert n_out > 50, f"outline branch unexercised ({n_out} kills)"
    _assert_f64_parity(a, b, N, atol_p=2e-3)


def test_material_and_source_grads_keep_xla_scan():
    """Gradients w.r.t. media (dispersion) or source-ray values flow
    through the scanned runs: finite and non-zero."""
    RT = _build()
    steps, (p, s, pols, w, wl), outline = _bundle(RT)

    def loss_media(dn):
        out = trace_bundle(_media_steps(steps, dn), RT.n0, outline, p, s,
                           pols, w, wl, True, False)
        # the end absorber zeroes the final w: weight by the last section
        # BEFORE it, positions at the absorber plane
        return jnp.sum(out["p"][:, -1, 0] ** 2 * out["w"][:, -2])

    def loss_source(dx):
        p_shift = p + jnp.stack([dx, 0.0 * dx, 0.0 * dx])
        out = trace_bundle(steps, RT.n0, outline, p_shift, s, pols, w, wl,
                           True, False)
        return jnp.sum(out["p"][:, -1, 0] ** 2 * out["w"][:, -2])

    g = jax.grad(loss_media)(jnp.float32(0.0))
    g2 = jax.grad(loss_source)(jnp.float32(0.0))
    assert np.isfinite(float(g)) and float(g) != 0.0
    assert np.isfinite(float(g2)) and float(g2) != 0.0


def test_grad_of_vmapped_trace_keeps_xla_scan():
    """Grad of a vmapped trace over batched source shifts (a
    differentiation tracer wrapped in a batching tracer) runs through the
    scanned runs and gives a finite, non-zero gradient."""
    RT = _build()
    steps, (p, s, pols, w, wl), outline = _bundle(RT, 256)

    def one(dx):
        p_shift = p + jnp.stack([dx, 0.0 * dx, 0.0 * dx])
        out = trace_bundle(steps, RT.n0, outline, p_shift, s, pols, w, wl,
                           True, False)
        return jnp.sum(out["p"][:, -1, 0] ** 2 * out["w"][:, -2])

    def loss(scale):
        return jnp.sum(jax.vmap(one)(scale * jnp.asarray([0.0, 0.05])))

    g = jax.grad(loss)(jnp.float32(1.0))
    assert np.isfinite(float(g)) and float(g) != 0.0


def _build_asphere(no_pol=True):
    """The _build scene with an even-asphere front on the middle lens, so
    the widened kernel run covers asphere + conic + flat steps."""
    RT = ot.Raytracer(outline=[-10, 10, -10, 10, -10, 80], no_pol=no_pol)
    RT.add(ot.RaySource(ot.CircularSurface(r=1.5), divergence="Lambertian",
                        div_angle=8, pos=[0, 0, -5],
                        spectrum=ot.presets.light_spectrum.d65))
    n1 = ot.presets.refraction_index.BK7
    n2 = ot.presets.refraction_index.F2
    RT.add(ot.Lens(ot.SphericalSurface(r=3, R=20), ot.SphericalSurface(r=3, R=-25),
                   n=n1, pos=[0, 0, 0], d=1.0))
    RT.add(ot.Lens(ot.AsphericSurface(r=3, R=30, k=-0.5, coeff=[2e-4, -1e-6]),
                   ot.CircularSurface(r=3), n=n2, pos=[0, 0, 5], d=0.8))
    RT.add(ot.Lens(ot.SphericalSurface(r=3, R=15), ot.SphericalSurface(r=3, R=-15),
                   n=n1, pos=[0, 0, 10], d=1.2))
    RT.add(ot.Detector(ot.RectangularSurface(dim=[8, 8]), pos=[0, 0, 40]))
    return RT


@pytest.mark.parametrize("no_pol", [True, False])
def test_asphere_scene_parity(no_pol):
    """Asphere-bearing scene (conic runs scanned, the asphere's iterative
    hit solve unrolled) against the f64 oracle."""
    N = 20000
    a, b = trace_f32_f64(lambda: _build_asphere(no_pol), N)
    _assert_f64_parity(a, b, N)


def _build_tilted(no_pol=True, asphere=False):
    """Prism-style scene: a tilted glass plate BETWEEN lenses (optionally
    behind an even-asphere lens, which widens runs to kernel-only kinds)."""
    RT = ot.Raytracer(outline=[-10, 10, -10, 10, -10, 80], no_pol=no_pol)
    RT.add(ot.RaySource(ot.CircularSurface(r=1.5), divergence="Lambertian",
                        div_angle=8, pos=[0, 0, -5],
                        spectrum=ot.presets.light_spectrum.d65))
    n1 = ot.presets.refraction_index.BK7
    front = ot.AsphericSurface(r=3, R=20, k=-0.5, coeff=[2e-4, -1e-6]) \
        if asphere else ot.SphericalSurface(r=3, R=20)
    RT.add(ot.Lens(front, ot.SphericalSurface(r=3, R=-25),
                   n=n1, pos=[0, 0, 0], d=1.0))
    th = np.radians(8.0)
    tnf = [0.0, float(np.sin(th)), float(np.cos(th))]
    RT.add(ot.Lens(ot.TiltedSurface(r=3, normal=tnf),
                   ot.TiltedSurface(r=3, normal=[0.0, 0.0, 1.0]),
                   n=ot.presets.refraction_index.F2,
                   pos=[0, 0, 5], d=1.5))
    RT.add(ot.Lens(ot.SphericalSurface(r=3, R=15),
                   ot.SphericalSurface(r=3, R=-15),
                   n=n1, pos=[0, 0, 10], d=1.2))
    RT.add(ot.Lens(ot.SphericalSurface(r=3, R=18),
                   ot.SphericalSurface(r=3, R=-18),
                   n=n1, pos=[0, 0, 15], d=1.2))
    RT.add(ot.Detector(ot.RectangularSurface(dim=[8, 8]), pos=[0, 0, 40]))
    return RT


@pytest.mark.parametrize("no_pol", [True, False])
def test_tilted_scene_parity(no_pol):
    """Prism-style scene: the tilted plate between lenses splits the chain
    (tilted planes are unrolled steps, conic runs stay scanned) — f32
    against the f64 oracle."""
    RT = _build_tilted(no_pol)
    steps = RT._build_steps()
    runs = tc._partition_runs(steps, [])
    tilted = {i for i, st in enumerate(steps) if st.sfns.kind == "tilted"}
    assert tilted and all(kind == "step" for kind, idx in runs
                          if tilted & set(idx))
    assert any(kind == "scan" for kind, _ in runs)
    N = 20000
    a, b = trace_f32_f64(lambda: _build_tilted(no_pol), N)
    _assert_f64_parity(a, b, N)


def test_tilted_unfused_with_asphere_and_traced_media():
    """Asphere + tilted plate + traced media: non-conic steps never enter
    a scanned run, and the media gradient is finite and non-zero."""
    RT = _build_tilted(no_pol=True, asphere=True)
    steps, (p, s, pols, w, wl), outline = _bundle(RT)
    for kind, idx in tc._partition_runs(steps, []):
        if kind == "scan":
            assert all(steps[i].action == "refract"
                       and steps[i].sfns.kind in tc.SCAN_KINDS for i in idx)

    def loss(dn):
        out = trace_bundle(_media_steps(steps, dn), RT.n0, outline, p, s,
                           pols, w, wl, True, False)
        return jnp.sum(out["p"][:, -1, 0] ** 2 * out["w"][:, -2])

    g = jax.grad(loss)(jnp.float32(0.0))
    assert np.isfinite(float(g)) and float(g) != 0.0


@pytest.mark.parametrize("no_pol", [True, False])
def test_aperture_fused_scene_parity(no_pol):
    """A ring stop BETWEEN lens groups (the microscope/eye layout): the
    stop splits the chain into an unrolled absorber between runs. Parity
    with the f64 oracle extends to the stored per-section refractive
    indices — the stop's section reports the surrounding glass."""
    def build():
        RT = ot.Raytracer(outline=[-10, 10, -10, 10, -10, 80], no_pol=no_pol)
        RT.add(ot.RaySource(ot.CircularSurface(r=1.5), divergence="Lambertian",
                            div_angle=8, pos=[0, 0, -5],
                            spectrum=ot.presets.light_spectrum.d65))
        n1 = ot.presets.refraction_index.BK7
        RT.add(ot.Lens(ot.SphericalSurface(r=3, R=20),
                       ot.SphericalSurface(r=3, R=-25),
                       n=n1, pos=[0, 0, 0], d=1.0, n2=n1))  # glass gap after
        RT.add(ot.Aperture(ot.RingSurface(r=3, ri=1.0), pos=[0, 0, 5]))
        RT.add(ot.Lens(ot.SphericalSurface(r=3, R=15),
                       ot.SphericalSurface(r=3, R=-15),
                       n=ot.presets.refraction_index.F2, pos=[0, 0, 10],
                       d=1.2))
        RT.add(ot.Detector(ot.RectangularSurface(dim=[8, 8]), pos=[0, 0, 40]))
        return RT

    N = 20000
    a, b = trace_f32_f64(build, N)
    _assert_f64_parity(a, b, N)
    np.testing.assert_allclose(a["n"], b["n"], atol=1e-6)
    assert a["n"][:, 3].mean() > 1.4        # ambient at the stop is the glass


def test_asphere_media_grad_repartition():
    """Traced media over an asphere-bearing scene: conic runs scan,
    asphere steps unroll, and the gradient is finite and non-zero."""
    RT = _build_asphere()
    steps, (p, s, pols, w, wl), outline = _bundle(RT)

    def loss_media(dn):
        out = trace_bundle(_media_steps(steps, dn), RT.n0, outline, p, s,
                           pols, w, wl, True, False)
        return jnp.sum(out["p"][:, -1, 0] ** 2 * out["w"][:, -2])

    g = jax.grad(loss_media)(jnp.float32(0.0))
    assert np.isfinite(float(g)) and float(g) != 0.0


def test_chunked_dispatch_with_kernel_kinds(monkeypatch):
    """Scanned against unrolled on an asphere- and prism-bearing scene:
    the heterogeneous steps before the scanned run must thread the state
    identically."""
    a, b = trace_scan_unrolled(lambda: _build_tilted(asphere=True), 15000,
                               monkeypatch)
    _assert_path_parity(a, b, atol_p=5e-5)


def test_pol_path_matches_xla_scan():
    """Full polarization transport (s/p decomposition, A_ts/A_tp Fresnel
    weights) in the scanned runs against the f64 oracle."""
    def build():
        RT = _build(with_flats=True)
        RT.no_pol = False
        return RT

    N = 20000
    a, b = trace_f32_f64(build, N)
    _assert_f64_parity(a, b, N)
    alive = (a["w"] > 0) & (b["w"] > 0)
    np.testing.assert_allclose(b["pol"][alive], a["pol"][alive], atol=1e-4)


@pytest.mark.parametrize("no_pol", [True, False])
def test_scan_matches_unrolled_pol_modes(no_pol, monkeypatch):
    """Scanned against unrolled with and without polarization transport."""
    def build():
        RT = _build(with_flats=True)
        RT.no_pol = no_pol
        return RT

    a, b = trace_scan_unrolled(build, 10000, monkeypatch)
    _assert_path_parity(a, b)
    if not no_pol:
        np.testing.assert_allclose(np.nan_to_num(a["pol"]),
                                   np.nan_to_num(b["pol"]), atol=1e-5)


@pytest.fixture
def gpu():
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU backend (python chip_smoke.py runs this "
                    "on the card)")


@pytest.mark.gpu
def test_gpu_trace_matches_cpu_backend(gpu):
    """The card's f32 trace against the CPU backend's f32 trace of the
    same bundle at 2¹⁸ rays: the same program, compiled by two backends,
    differs only in fusion rounding."""
    N = 1 << 18
    RT = _build()
    rays, outline = _rays(RT, N)
    b = _trace(RT, rays, outline, np.float32)
    with jax.default_device(jax.devices("cpu")[0]):
        a = _trace(RT, rays, outline, np.float32)
    _assert_f64_parity(a, b, N)


@pytest.mark.gpu
def test_gpu_binning_matches_cpu_backend(gpu):
    """bin_xyzw's scatter-add (atomics on the card) against the CPU
    backend at 10⁶ rays into 945² × 4 bins: equal up to f32 summation
    order."""
    from optrace_tpu.ops.binning import bin_xyzw
    rng = np.random.default_rng(0)
    N = 1_000_000
    args = [rng.uniform(-1, 1, N), rng.uniform(-1, 1, N), rng.uniform(0, 1, N),
            rng.uniform(380, 780, N)]
    args = [a.astype(np.float32) for a in args]
    ext = (-1.0, 1.0, -1.0, 1.0)
    card = np.asarray(bin_xyzw(*args, 945, 945, ext))
    with jax.default_device(jax.devices("cpu")[0]):
        host = np.asarray(bin_xyzw(*args, 945, 945, ext))
    np.testing.assert_allclose(card, host, rtol=1e-4, atol=1e-6)


@pytest.mark.gpu
def test_sharded_kernel_parity(gpu):
    """The sharded fused render over a one-card mesh (shard_map, psum)
    against the unsharded fused render of the same key on the card."""
    from jax.sharding import Mesh
    from optrace_tpu.parallel.render import (make_fused_render,
                                             make_sharded_render)

    RT = _build(with_flats=True)
    with ot.global_options.no_warnings():
        assert not RT._pretrace_check(1000)
    N = 1 << 16
    mesh = Mesh(np.array(jax.devices()[:1]), ("rays",))
    step, _ = make_sharded_render(RT, N, mesh=mesh, extent=(-3, 3, -3, 3),
                                  Nx=63, Ny=63)
    one, _ = make_fused_render(RT, N, extent=(-3, 3, -3, 3), Nx=63, Ny=63)
    key = jax.random.PRNGKey(4)
    img = np.asarray(step(key))
    ref = np.asarray(jax.jit(one)(jax.random.split(key, 1)[0]))
    assert ref[..., 3].sum() > 0
    np.testing.assert_allclose(img, ref, rtol=1e-5, atol=1e-7)

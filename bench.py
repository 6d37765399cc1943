"""Benchmark on one NVIDIA GPU: cold and warm times of the trace, the
fused render, XYZW binning and one design step.

    python bench.py

Scenes (10⁶ rays each): the 56-surface dispersive stack of
``build_synthetic`` (28 spherical BK7/F2 lenses and a ring stop, image
source; the reference's own 57-surface microscope fixtures are not part of
this repository), the same stack with polarization transport, the
10-lens even-asphere stack, and the double-Gauss objective's fused
streaming render (source → trace → detector sink → XYZW bin, no stored
sections). Every time is host wall clock around ``block_until_ready`` of
the jitted device program, the median of REPS calls, compile excluded and
reported separately as the cold time.

The reference headline is 85 ms/surface/Mray on an 8-core i7-1360P
(reference docs/source/index.rst:42, BASELINE.md). Every JSON line names
the device it ran on; without a GPU the script exits non-zero.
"""

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

BASELINE_S_PER_SURFACE_PER_MRAY = 0.085
RES = "/root/reference/examples/resources"
N_RAYS = 1_000_000
REPS = 5


def build_microscope():
    """The reference benchmark geometry (tests/benchmark.py:16-66), built
    through this framework's own loaders/TMA — 57 tracing surfaces."""
    import optrace_tpu as ot

    RT = ot.Raytracer(outline=[-50, 50, -50, 50, -30, 430], no_pol=True)
    RSS = ot.presets.image.cell([100e-3, 100e-3])
    RT.add(ot.RaySource(RSS, divergence="Lambertian",
                        pos=[0, 0, -0.00000001], s=[0, 0, 1], div_angle=50))

    with ot.global_options.no_warnings():
        n_dict = {}
        for cat in ["schott.agf", "ohara.agf", "hikari.agf", "hoya.agf"]:
            n_dict |= ot.load_agf(os.path.join(RES, "materials", cat))
        G = ot.load_zmx(os.path.join(
            RES, "microscope", "Nikon_1p25NA_60x_US7889433B2_MultiConfig_v2.zmx"),
            n_dict=n_dict)

        objective = ot.Group(G.lenses[:18])
        RT.add(objective)
        tube = ot.Group(G.lenses[20:24])
        tube.move_to(G.lenses[20].pos - [0, 0, 150])
        RT.add(tube)
        eyepiece = ot.load_zmx(os.path.join(RES, "eyepiece", "UK565851-1.zmx"),
                               n_dict=n_dict)
        eyepiece.remove(eyepiece.detectors)
        RT.n0 = G.n0

        tma = ot.TMA(objective.lenses + tube.lenses, n0=G.n0)
        z_img0 = tma.image_position(-0.00000001)
        eyep_f0 = eyepiece.tma().focal_points[0]
        eyepiece.move_to([0, 0, eyepiece.lenses[0].pos[2] - (eyep_f0 - z_img0)])
        RT.add(eyepiece)

        eye = ot.presets.geometry.arizona_eye()
        exit_pupil = RT.tma().pupil_position(0.38)[1]
        entrance_pupil = eye.tma().pupil_position(eye.apertures[0].pos[2])[0]
        eye.move_to([0, 0, exit_pupil + (eye.pos[2] - entrance_pupil)])
        RT.add(eye)
    return RT


def build_synthetic():
    """Fallback: 28 spherical doublet-halves + aperture ≈ 57 surfaces with
    dispersive media and an image source, when fixtures are absent."""
    import optrace_tpu as ot

    RT = ot.Raytracer(outline=[-50, 50, -50, 50, -5, 600], no_pol=True)
    RSS = ot.presets.image.color_checker([10, 10])
    RT.add(ot.RaySource(RSS, divergence="Lambertian",
                        pos=[0, 0, 0], s=[0, 0, 1], div_angle=20))
    z = 10.0
    glasses = [ot.presets.refraction_index.BK7, ot.presets.refraction_index.F2]
    for i in range(28):
        front = ot.SphericalSurface(r=8, R=60.0 if i % 2 == 0 else 80.0)
        back = ot.SphericalSurface(r=8, R=-70.0 if i % 2 == 0 else -90.0)
        RT.add(ot.Lens(front, back, n=glasses[i % 2], de=0.5, pos=[0, 0, z]))
        z += 15.0
    RT.add(ot.Aperture(ot.RingSurface(r=9, ri=6), pos=[0, 0, z]))
    return RT


def build_asphere_scene():
    """Asphere-bearing stack (10 lenses, even-asphere fronts; cf.
    keratoconus-style eye surfaces): the non-closed-form hit solve in a
    long chain."""
    import optrace_tpu as ot

    RT = ot.Raytracer(outline=[-50, 50, -50, 50, -5, 320], no_pol=True)
    RT.add(ot.RaySource(ot.CircularSurface(r=4), divergence="Lambertian",
                        pos=[0, 0, 0], s=[0, 0, 1], div_angle=8,
                        spectrum=ot.presets.light_spectrum.d65))
    glasses = [ot.presets.refraction_index.BK7, ot.presets.refraction_index.F2]
    z = 10.0
    for i in range(10):
        front = ot.AsphericSurface(r=8, R=60.0 if i % 2 == 0 else 80.0,
                                   k=-0.8, coeff=[1e-5, -1e-8])
        back = ot.SphericalSurface(r=8, R=-70.0 if i % 2 == 0 else -90.0)
        RT.add(ot.Lens(front, back, n=glasses[i % 2], de=0.5, pos=[0, 0, z]))
        z += 15.0
    return RT


def _device():
    import jax
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def _median_time(fn, *args, reps=REPS):
    import jax
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def _trace_program(build, N, no_pol=True):
    """Jitted stored-section trace program of a fresh scene (the device
    part of ``RT.trace``). Returns (fn, key, n_surfaces, cold_s)."""
    import jax
    import optrace_tpu as ot
    RT = build()
    RT.no_pol = no_pol
    with ot.global_options.no_warnings():
        assert not RT._pretrace_check(N)
        RT.rays.init(RT.ray_sources, N, len(RT.tracing_surfaces) + 2, RT.no_pol)
        fn = RT._get_trace_fn(N)
        key = jax.random.PRNGKey(1)
        t0 = time.perf_counter()
        jax.block_until_ready(fn(key))
        cold = time.perf_counter() - t0
    return fn, key, len(RT.tracing_surfaces), cold


def _fused_program(build, N):
    """Jitted fused render step of a fresh scene with a fixed extent."""
    import jax
    import optrace_tpu as ot
    from optrace_tpu.parallel.render import make_fused_render
    RT = build()
    with ot.global_options.no_warnings():
        assert not RT._pretrace_check(1000)
        render, _ = make_fused_render(RT, N, detector_index=0,
                                      extent=(-2.0, 2.0, -2.0, 2.0),
                                      Nx=945, Ny=945)
        fn = jax.jit(render)
        key = jax.random.PRNGKey(1)
        t0 = time.perf_counter()
        jax.block_until_ready(fn(key))
        cold = time.perf_counter() - t0
    return fn, key, len(RT.tracing_surfaces), cold


def bench_program(name, make, N=N_RAYS):
    """Cold time and median warm time of one program."""
    fn, key, ns, cold = make()
    t = _median_time(fn, key)
    res = {"section": name, "n_rays": N, "n_surfaces": ns, "cold_s": cold,
           "s": t, "s_per_surface_Mray": t / ns / (N / 1e6),
           "device": _device()}
    print(json.dumps(res), flush=True)
    return res


def bench_binning(N=N_RAYS, n_pix=945):
    """bin_xyzw (scatter-add) at N rays into n_pix² × 4 bins."""
    import jax
    import numpy as np
    from optrace_tpu.ops import binning
    rng = np.random.default_rng(0)
    args = [jax.device_put(a.astype(np.float32)) for a in (
        rng.uniform(-1, 1, N), rng.uniform(-1, 1, N), rng.uniform(0, 1, N),
        rng.uniform(380, 780, N))]
    ext = (-1.0, 1.0, -1.0, 1.0)
    res = {"section": "binning", "n_rays": N, "bins": [n_pix, n_pix, 4],
           "device": _device()}
    f = jax.jit(lambda px, py, w, wl:
                binning.bin_xyzw(px, py, w, wl, n_pix, n_pix, ext))
    jax.block_until_ready(f(*args))
    res["s"] = _median_time(f, *args)
    print(json.dumps(res), flush=True)
    return res


def bench_design_step(N=250_000):
    """One value_and_grad design step on the double-Gauss objective."""
    import jax
    import jax.numpy as jnp
    import optrace_tpu as ot
    from __graft_entry__ import _build_scene
    from optrace_tpu.tracer.diff import make_parameterized_render
    RT = _build_scene()
    with ot.global_options.no_warnings():
        render, params0 = make_parameterized_render(RT, N, extent=(-2, 2, -2, 2),
                                                    Nx=189, Ny=189)
    vg = jax.jit(jax.value_and_grad(
        lambda prm, key: jnp.sum(render(prm, key)[:, :, 3])))
    key = jax.random.PRNGKey(1)
    t0 = time.perf_counter()
    jax.block_until_ready(vg(params0, key))
    cold = time.perf_counter() - t0
    res = {"section": "design_step", "n_rays": N,
           "n_surfaces": len(RT.tracing_surfaces), "cold_s": cold,
           "s": _median_time(vg, params0, key), "device": _device()}
    print(json.dumps(res), flush=True)
    return res


def main():
    import jax
    if jax.devices()[0].platform != "gpu":
        print(f"bench: no GPU (JAX found {jax.devices()[0].platform!r})",
              file=sys.stderr)
        return 1
    from optrace_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache(ROOT)
    from __graft_entry__ import _build_scene
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)

    out = {}
    for name, make in (
            ("stack56_nopol", lambda: _trace_program(build_synthetic, N_RAYS)),
            ("stack56_pol", lambda: _trace_program(build_synthetic, N_RAYS,
                                                   no_pol=False)),
            ("asphere", lambda: _trace_program(build_asphere_scene, N_RAYS)),
            ("double_gauss_fused", lambda: _fused_program(_build_scene, N_RAYS))):
        out[name] = bench_program(name, make)
    out["binning"] = bench_binning()
    out["design_step"] = bench_design_step()
    s_k = out["stack56_nopol"]["s_per_surface_Mray"]
    print(json.dumps({"metric": "s/surface/Mray (56-surface stack trace, no pol)",
                      "value": s_k, "unit": "s",
                      "vs_baseline": BASELINE_S_PER_SURFACE_PER_MRAY / s_k,
                      "device": _device()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

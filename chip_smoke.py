"""Smoke run of optrace_tpu on an NVIDIA GPU: the main path once, through
the entry points a user calls, at real sizes, checked against the repo's
own references.

    python chip_smoke.py               # one card: every phase below
    python chip_smoke.py --devices 4   # four cards: the sharded path only

One card, in one process: the headline trace (the 56-surface dispersive
stack of ``bench.build_synthetic`` at 10⁶ rays, with and without
polarization), the asphere trace, the megabatch render (double-Gauss
objective, ``iterative_render`` of 2·10⁷ rays on a 945-px detector, and
``render_huge``), one design step (``value_and_grad`` through
``make_parameterized_render``), parity of the card's f32 trace with the
f64 oracle on the CPU backend, and the tests marked ``gpu`` through
``pytest.main``. The path has no hand-written kernel: everything on the
card is what XLA compiles.

Each phase prints its cold time (compile included) and warm wall time on
the host clock around ``block_until_ready``, and the device's peak memory.
``RT.detector_image`` solves detector hits in f64 on the CPU backend by
design; its time is printed on a line of its own. The last line of
standard output is one JSON object naming the device. The script exits
non-zero, before printing it, when JAX finds no GPU or any phase fails.

The compile cache is ``$JAX_COMPILATION_CACHE_DIR`` when set, else
``<checkout>/.jax_cache``.
"""

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
N_RAYS = 1_000_000


# ----------------------------------------------------------------------
# helpers

def _peak(dev=None):
    """Peak device memory in use (None where the backend keeps no stats)."""
    import jax
    stats = (dev or jax.devices()[0]).memory_stats()
    return None if stats is None else stats.get("peak_bytes_in_use")


def timed(label, fn, warm=True):
    """Run ``fn`` cold (compile included) and, if ``warm``, once more;
    print both wall times and the peak device memory. Returns the last
    result."""
    import jax
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    cold = time.perf_counter() - t0
    msg = f"{label}: cold {cold:.3f} s"
    if warm:
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        msg += f", warm {time.perf_counter() - t0:.3f} s"
    print(f"{msg}, peak_bytes_in_use {_peak()}", flush=True)
    return out


def check(label, value, limit):
    """Print a measured maximum beside its limit; fail beyond it."""
    ok = bool(value <= limit)
    print(f"  parity {label}: {value:.3e} (limit {limit:.3e})"
          f"{'' if ok else '  FAILED'}", flush=True)
    if not ok:
        raise AssertionError(f"{label} {value} above {limit}")


def stack_scene(no_pol=True):
    """The headline stack with a detector across the whole outline."""
    import bench
    import optrace_tpu as ot
    RT = bench.build_synthetic()
    RT.no_pol = no_pol
    RT.add(ot.Detector(ot.RectangularSurface(dim=[100, 100]), pos=[0, 0, 590]))
    return RT


def asphere_scene(no_pol=True):
    import bench
    RT = bench.build_asphere_scene()
    RT.no_pol = no_pol
    return RT


def double_gauss():
    from __graft_entry__ import _build_scene
    return _build_scene()


# ----------------------------------------------------------------------
# checks

def compare_to_f64(build, N, seed=3):
    """The card's f32 trace against the f64 oracle (the same scene
    compiled with f64 parameters, traced on the CPU backend from the same
    f64 ray bundle — tests/test_accuracy.py's reference)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from optrace_tpu.tracer.trace_core import trace_bundle
    RT = build()
    assert not RT._pretrace_check(N)
    RT.rays.init(RT.ray_sources, N, len(RT.tracing_surfaces) + 2, RT.no_pol)
    outline = tuple(float(v) for v in RT.outline)
    cpu = jax.devices("cpu")[0]
    with jax.enable_x64(), jax.default_device(cpu):
        gen = RT._make_source_fn(N)
        rays = [np.asarray(a, np.float64) for a in gen(jax.random.PRNGKey(seed))]
        steps64 = RT._build_steps(np.float64)
        t0 = time.perf_counter()
        out64 = jax.jit(lambda *r: trace_bundle(
            steps64, RT.n0, outline, *r, RT.no_pol, RT.use_hurb,
            key=jax.random.PRNGKey(1)))(*map(jnp.asarray, rays))
        p64, w64 = np.asarray(out64["p"]), np.asarray(out64["w"])
        m64 = np.asarray(out64["infos"])
        t64 = time.perf_counter() - t0
    steps32 = RT._build_steps(np.float32)
    out32 = jax.jit(lambda *r: trace_bundle(
        steps32, RT.n0, outline, *r, RT.no_pol, RT.use_hurb,
        key=jax.random.PRNGKey(1)))(*[jnp.asarray(a, jnp.float32) for a in rays])
    p32, w32 = np.asarray(out32["p"], np.float64), np.asarray(out32["w"], np.float64)
    m32 = np.asarray(out32["infos"])
    print(f"  f64 oracle on the host CPU: {t64:.3f} s wall (not card time)",
          flush=True)
    both = (w64 > 0) & (w32 > 0)
    dp = np.linalg.norm(p32 - p64, axis=-1)
    excess = np.where(both, dp - (1e-4 + 4e-7 * np.linalg.norm(p64, axis=-1)),
                      -np.inf)
    check("positions, rays alive in both: 99.9th percentile of "
          "|dp| - (1e-4 mm + 4e-7 |p|)",
          float(np.percentile(excess[both], 99.9)), 0.0)
    check("positions, rays alive in both: max |dp| (mm)",
          float(dp[both].max()), 1e-2)
    check("weights |dw|", float(np.abs(w32 - w64).max()), 1e-4)
    check("alive in one path only, per section / N",
          float(((w64 > 0) != (w32 > 0)).sum(axis=0).max()) / N, 1e-3)
    check("INFOS counters |d| / N", float(np.abs(m32 - m64).max()) / N, 1e-3)


def energy_check(RT, img, z_det=590.0, half=50.0):
    """Image power must equal the power the stored sections carry across
    the detector plane, and cannot exceed the source power."""
    import numpy as np
    p, w = np.asarray(RT.rays.p_list), np.asarray(RT.rays.w_list)
    p0, p1, w0 = p[:, -2], p[:, -1], w[:, -2]
    cross = (p0[:, 2] < z_det) & (p1[:, 2] >= z_det) & (w0 > 0)
    t = (z_det - p0[:, 2]) / np.where(cross, p1[:, 2] - p0[:, 2], 1.0)
    xy = p0[:, :2] + t[:, None] * (p1[:, :2] - p0[:, :2])
    inside = cross & (np.abs(xy) <= half).all(axis=1)
    expect = float(w0[inside].sum())
    src = float(sum(rs.power for rs in RT.ray_sources))
    print(f"  energy: image {img.power():.6f} W, carried across the "
          f"detector plane {expect:.6f} W, source {src:.6f} W", flush=True)
    assert 0 < img.power() <= src * (1 + 1e-6)
    assert abs(img.power() - expect) <= 1e-6 * src


# ----------------------------------------------------------------------
# phases

def phase_trace(label, build, N, image=True):
    """``RT.trace(N)`` cold and warm, then (with a detector) the detector
    image, its energy balance and its sRGB conversion."""
    import numpy as np
    import optrace_tpu as ot
    RT = build()
    with ot.global_options.no_warnings(), ot.global_options.no_progress_bar():
        timed(f"{label} RT.trace({N})", lambda: RT.trace(N))
        w = np.asarray(RT.rays.w_list)
        assert np.isfinite(np.asarray(RT.rays.p_list)).all() and (w[:, 0] > 0).all()
        print(f"  rays alive after the last surface: {(w[:, -2] > 0).mean():.4f}",
              flush=True)
        if image:
            t0 = time.perf_counter()
            img = RT.detector_image(extent=[-50, 50, -50, 50])
            print(f"  detector_image: {time.perf_counter() - t0:.3f} s wall "
                  "(host CPU, f64 hit solve by design; not card time)",
                  flush=True)
            energy_check(RT, img)
            rgb = np.asarray(img.get("sRGB (Absolute RI)", 945).data)
            assert np.isfinite(rgb).all()
            print(f"  sRGB image {rgb.shape}", flush=True)


def phase_fused(N):
    """Fused streaming render (the megabatch step) of the double-Gauss
    objective at N rays on a 945-px detector."""
    import jax
    import numpy as np
    import optrace_tpu as ot
    from optrace_tpu.parallel.render import make_fused_render_multi
    RT = double_gauss()
    with ot.global_options.no_warnings():
        assert not RT._pretrace_check(1000)
        render, _ = make_fused_render_multi(
            RT, N, [dict(detector_index=0, extent=(-2.0, 2.0, -2.0, 2.0),
                         Nx=945, Ny=945)])
        fn = jax.jit(render)
        imgs, infos = timed(f"fused render {N} rays, 945² px",
                            lambda: fn(jax.random.PRNGKey(11)))
    img = np.asarray(imgs[0])
    assert img.shape == (945, 945, 4) and np.isfinite(img).all()
    assert 0 < img[..., 3].sum() <= 1 + 1e-4
    print(f"  image power {img[..., 3].sum():.6f} W", flush=True)


def phase_megabatch(N_total, N_huge):
    import numpy as np
    import optrace_tpu as ot
    RT = double_gauss()
    with ot.global_options.no_warnings(), ot.global_options.no_progress_bar():
        imgs = timed(f"iterative_render({N_total}) on a 945-px detector",
                     lambda: RT.iterative_render(N_total))
        img = imgs[0]
        assert img._data.shape[:2] == (945, 945), img._data.shape
        assert np.isfinite(img._data).all() and img.power() > 0
        print(f"  iterative_render image power {img.power():.6f} W", flush=True)
        huge = timed(f"render_huge({N_huge}) fixed extent",
                     lambda: RT.render_huge(N_huge, extent=[-2.0, 2.0, -2.0, 2.0]))
        assert np.isfinite(huge._data).all() and huge.power() > 0
        print(f"  render_huge image power {huge.power():.6f} W", flush=True)


def phase_design(N):
    import jax
    import jax.numpy as jnp
    import numpy as np
    import optrace_tpu as ot
    from optrace_tpu.tracer.diff import make_parameterized_render
    RT = double_gauss()
    with ot.global_options.no_warnings():
        render, params0 = make_parameterized_render(RT, N, extent=(-2, 2, -2, 2),
                                                    Nx=189, Ny=189)

        def loss(params, key):
            return jnp.sum(render(params, key)[:, :, 3])

        vg = jax.jit(jax.value_and_grad(loss))
        key = jax.random.PRNGKey(5)
        val, grads = timed(f"design step value_and_grad at {N} rays, 189² px",
                           lambda: vg(params0, key))
    leaves = [np.asarray(g) for g in jax.tree_util.tree_leaves(grads)]
    assert np.isfinite(float(val)) and float(val) > 0
    assert all(np.isfinite(g).all() for g in leaves), "non-finite gradient"
    n_nz = sum(int(np.abs(g).max() > 0) for g in leaves)
    assert n_nz > 0, "all gradients are zero"
    print(f"  loss {float(val):.6f}, {len(leaves)} gradient leaves finite, "
          f"{n_nz} non-zero", flush=True)


def phase_gpu_tests():
    import pytest

    class Count:
        passed = 0

        def pytest_runtest_logreport(self, report):
            if report.when == "call" and report.passed:
                self.passed += 1

    counter = Count()
    tests = os.path.join(ROOT, "tests")
    # only the modules that hold gpu-marked tests: the others may import
    # packages (plotting, the reference oracle) a card machine need not have
    files = sorted(os.path.join(tests, f) for f in os.listdir(tests)
                   if f.startswith("test_") and f.endswith(".py")
                   and "mark.gpu" in open(os.path.join(tests, f)).read())
    t0 = time.perf_counter()
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      "-p", "no:randomly", *files], plugins=[counter])
    print(f"gpu-marked tests: rc {int(rc)}, {counter.passed} passed, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    assert int(rc) == 0 and counter.passed >= 3


def compile_concurrently(jobs):
    """Lower each (jitted, args) job in turn, then compile them all at
    once: XLA's compiler releases the GIL, so independent programs compile
    in parallel on the host's cores. Returns the compiled executables."""
    from concurrent.futures import ThreadPoolExecutor
    lowered = [fn.lower(*args) for fn, args in jobs]
    with ThreadPoolExecutor(len(lowered)) as pool:
        return list(pool.map(lambda lo: lo.compile(), lowered))


def phase_sharded(n_dev, n_rays, n_grad, n_pix, n_pix_grad=189):
    """Four-card phase: the sharded fused render against the sum of the
    same per-key renders on one card, and the sharded design gradient
    against the single-device sum. The four programs compile
    concurrently."""
    import jax
    import numpy as np
    import optrace_tpu as ot
    from jax.sharding import Mesh
    from optrace_tpu.parallel.render import make_fused_render, make_sharded_render
    from __graft_entry__ import dryrun_multichip, dryrun_programs

    devs = jax.devices()[:n_dev]
    assert len(devs) == n_dev, f"need {n_dev} devices, have {len(jax.devices())}"
    mesh = Mesh(np.array(devs), ("rays",))
    RT = stack_scene()
    ext = (-50.0, 50.0, -50.0, 50.0)
    di = len(RT.detectors) - 1
    key = jax.random.PRNGKey(21)
    keys = jax.random.split(key, n_dev)
    t0 = time.perf_counter()
    with ot.global_options.no_warnings():
        assert not RT._pretrace_check(1000)
        step, _ = make_sharded_render(RT, n_rays, mesh=mesh, detector_index=di,
                                      extent=ext, Nx=n_pix, Ny=n_pix)
        one, _ = make_fused_render(RT, n_rays // n_dev, detector_index=di,
                                   extent=ext, Nx=n_pix, Ny=n_pix)
        progs = dryrun_programs(n_dev, n_shard=n_grad, n_pix=n_pix_grad)
        step_c, one_c, gstep_c, gone_c = compile_concurrently([
            (step, (key,)), (jax.jit(one), (keys[0],)),
            (progs["step"], (progs["params0"], progs["keys"])),
            (progs["grad_one"], (progs["params0"], progs["keys"][0]))])
    print(f"lowered and compiled the 4 programs: {time.perf_counter() - t0:.3f} s"
          " wall", flush=True)
    img = np.asarray(timed(f"make_sharded_render {n_rays} rays on {n_dev} "
                           f"devices, {n_pix}² px (compiled ahead)",
                           lambda: step_c(key)))
    peaks = [_peak(d) for d in devs]
    print(f"  per-device peak_bytes_in_use {peaks}", flush=True)
    assert all(pk is None or pk > 0 for pk in peaks), "a device did no work"
    ref = sum(np.asarray(one_c(k), np.float64) for k in keys) / n_dev
    tot = ref[..., 3].sum()
    assert tot > 0
    check("sharded render per-pixel |d| / total power",
          float(np.abs(img - ref).max() / tot), 1e-5)
    t0 = time.perf_counter()
    dryrun_multichip(n_dev, programs=dict(progs, step=gstep_c, grad_one=gone_c))
    print(f"sharded design gradient ({n_grad} rays per device, {n_pix_grad}² px):"
          f" {time.perf_counter() - t0:.3f} s wall (compiled ahead); "
          f"per-device peak_bytes_in_use {[_peak(d) for d in devs]}", flush=True)


# ----------------------------------------------------------------------

def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=1, choices=(1, 4),
                    help="4: run only the sharded path across four cards")
    args = ap.parse_args(argv)

    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX found {devs[0].platform!r})",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    # fails outside a checkout
    from optrace_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache(ROOT)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    print(f"jax {jax.__version__}, {len(devs)} x {devs[0].device_kind}",
          flush=True)
    t_start = time.perf_counter()

    if args.devices == 4:
        phase_sharded(4, 4 * N_RAYS, 65536, 945)
    else:
        phase_trace("headline 56-surface stack, no pol", stack_scene, N_RAYS)
        phase_trace("headline 56-surface stack, pol",
                    lambda: stack_scene(no_pol=False), N_RAYS)
        phase_trace("asphere stack", asphere_scene, N_RAYS, image=False)
        phase_fused(N_RAYS)
        phase_megabatch(20 * N_RAYS, 10 * N_RAYS)
        phase_design(250_000)
        for no_pol in (True, False):
            print(f"parity with the f64 oracle, 56-surface stack, "
                  f"{'no pol' if no_pol else 'pol'}, 65536 rays", flush=True)
            compare_to_f64(lambda: stack_scene(no_pol), 65536)
        phase_gpu_tests()
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

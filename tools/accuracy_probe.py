"""f32 vs f64 error budget on the 57-surface microscope.

Traces the same ray bundle through the unrolled trace in f32 (device path)
and f64 (oracle, under jax.enable_x64) and reports per-section position
error statistics plus the final detector-plane spot error.

Usage: JAX_PLATFORMS=cpu python tools/accuracy_probe.py [N]
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np
import jax
import jax.numpy as jnp

jax.config.update("jax_platforms", "cpu")

from optrace_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402
enable_compile_cache(REPO)

from optrace_tpu.tracer.trace_core import trace_bundle   # noqa: E402
import bench                                             # noqa: E402


def run(RT, N=20000, seed=0):
    nt = len(RT.tracing_surfaces) + 2
    RT.rays.init(RT.ray_sources, N, nt, RT.no_pol, seed=seed)
    outline = tuple(float(v) for v in RT.outline)

    with jax.enable_x64():
        gen = RT._make_source_fn(N)
        p, s, pols, w, wl = [np.asarray(a, dtype=np.float64)
                             for a in gen(jax.random.PRNGKey(seed))]

        steps64 = RT._build_steps(np.float64)
        out64 = trace_bundle(steps64, RT.n0, outline,
                             jnp.asarray(p), jnp.asarray(s), jnp.asarray(pols),
                             jnp.asarray(w), jnp.asarray(wl),
                             RT.no_pol, RT.use_hurb, key=jax.random.PRNGKey(1))
        p64 = np.asarray(out64["p"])
        w64 = np.asarray(out64["w"])

    # eager on purpose: jit of the 57-surface unrolled graph is slow on a
    # small CPU host; op-by-op f32 matches the jitted numerics up to
    # fusion rounding (which only *improves* via fma), so the error budget
    # measured here is an upper bound for the jitted device path
    steps32 = RT._build_steps(np.float32)
    out32 = trace_bundle(steps32, RT.n0, outline,
                         jnp.asarray(p, jnp.float32), jnp.asarray(s, jnp.float32),
                         jnp.asarray(pols, jnp.float32), jnp.asarray(w, jnp.float32),
                         jnp.asarray(wl, jnp.float32),
                         RT.no_pol, RT.use_hurb, key=jax.random.PRNGKey(1))
    p32 = np.asarray(out32["p"], dtype=np.float64)
    w32 = np.asarray(out32["w"], dtype=np.float64)

    return p64, w64, p32, w32


def report(p64, w64, p32, w32):
    # only rays alive in BOTH runs at each section are comparable: a ray
    # absorbed in one run but not the other diverges by design
    alive = (w64 > 0) & (w32 > 0)
    nt = p64.shape[1]
    print(f"{'sec':>4} {'alive':>8} {'med |dxy| mm':>14} {'p99 |dxy| mm':>14} {'max |dz| mm':>12}")
    for j in range(nt):
        m = alive[:, min(j, nt - 1)]
        if not m.any():
            continue
        d = p32[m, j] - p64[m, j]
        dxy = np.hypot(d[:, 0], d[:, 1])
        print(f"{j:>4} {int(m.sum()):>8} {np.median(dxy):>14.3e} "
              f"{np.percentile(dxy, 99):>14.3e} {np.abs(d[:, 2]).max():>12.3e}")
    # the last section is the end absorber (w=0 everywhere); the last
    # *illuminated* section is the physically meaningful endpoint
    last = max(j for j in range(nt) if alive[:, j].any())
    m = alive[:, last]
    d = p32[m, last] - p64[m, last]
    dxy = np.hypot(d[:, 0], d[:, 1])
    print(f"\nlast alive section {last}: N={int(m.sum())}, "
          f"median |dxy| = {np.median(dxy):.3e} mm, "
          f"p99 = {np.percentile(dxy, 99):.3e} mm, max = {dxy.max():.3e} mm")
    ndis = int(((w64[:, last] > 0) != (w32[:, last] > 0)).sum())
    print(f"weight disagreement (alive in one run only): {ndis} rays")
    return np.median(dxy), np.percentile(dxy, 99)


if __name__ == "__main__":
    N = int(sys.argv[1]) if len(sys.argv) > 1 else 20000
    RT = bench.build_microscope() if os.path.isdir(bench.RES) else bench.build_synthetic()
    print(f"{len(RT.tracing_surfaces)} tracing surfaces, N={N}")
    p64, w64, p32, w32 = run(RT, N)
    report(p64, w64, p32, w32)

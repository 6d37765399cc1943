"""Stateless Monte-Carlo samplers (threefry-keyed).

Device equivalent of reference ``optrace/tracer/random.py:1-160``. The
reference uses a module-global stateful ``np.random.Generator(SFC64)``; here
every sampler is a pure function of a ``jax.random`` key, so traces are
reproducible, shardable (fold the mesh shard index into the key) and
differentiable around.

Samplers:
- stratified interval / rectangle (jittered grids, reference random.py:8-67)
- stratified ring via the Shirley/Chiu concentric equal-area square→disc map
  (reference random.py:70-110 uses the same family of equal-area maps)
- inverse-transform sampling from tabulated pdfs (continuous) and discrete
  line spectra (reference random.py:113-159) — implemented as searchsorted /
  interp on a precomputed CDF, which XLA vectorizes well.
"""

import math

import jax
import jax.numpy as jnp


# ----------------------------------------------------------------------
# uniform / stratified 1D

def uniform(key, N: int, a: float, b: float) -> jnp.ndarray:
    """N uniform samples in [a, b]."""
    return jax.random.uniform(key, (N,), minval=a, maxval=b)


def _shuffle_permutation(key, N: int) -> jnp.ndarray:
    """Pseudorandom permutation of [0, N) for decorrelating stratification
    order between sampling streams (wavelength vs position vs divergence).

    This MUST be a pseudorandom bijection: an affine-stride permutation
    (a·i + b mod N) composed one stream with the inverse of another into
    ANOTHER affine map, so the (wavelength-rank, angle-rank) pairs of every
    ray lay on a lattice — a polychromatic trace then correlated color with
    aim angle and skewed every chromatic image (the double-gauss PSF came
    out blue). ``jax.random.permutation`` is such a bijection but lowers to
    a device SORT, and ray generation shuffles up to six independent
    streams per call.

    Instead: a 4-round Feistel network over the next power-of-4 domain with
    xorshift-multiply round functions (murmur3-style mixing, round keys
    drawn from ``key``), walked back into [0, N) by cycle-walking. A
    Feistel cipher is a bijection by construction, has no lattice
    structure, and is pure vector arithmetic — O(N) with no sort. The
    cycle walk needs < 4 expected re-applications (domain < 4N) and runs
    as a masked ``while_loop``; all lanes are in-range after ~20 rounds
    with probability 1 − 2⁻²⁰ per lane.
    """
    # domain M = 2^(2h) >= N; 2h <= 32 requires N <= 2^32 (ray counts are
    # far below; render_huge shards batches long before this)
    bits = max(2, int(N - 1).bit_length())
    h = (bits + 1) // 2
    mask = jnp.uint32((1 << h) - 1)
    ks = jax.random.bits(key, (4,), dtype=jnp.uint32)

    def feistel(x):
        L = (x >> h).astype(jnp.uint32)
        R = (x & mask).astype(jnp.uint32)
        for r in range(4):
            f = (R ^ ks[r]) * jnp.uint32(0x9E3779B1)
            f = f ^ (f >> 15)
            f = f * jnp.uint32(0x85EBCA77)
            f = f ^ (f >> 13)
            L, R = R, (L ^ f) & mask
        return (L << h) | R

    x = feistel(jnp.arange(N, dtype=jnp.uint32))
    n = jnp.uint32(N)
    x = jax.lax.while_loop(lambda x: jnp.any(x >= n),
                           lambda x: jnp.where(x >= n, feistel(x), x), x)
    return x.astype(jnp.int32)


def stratified_interval_sampling(key, N: int, a, b,
                                 shuffle: bool = True) -> jnp.ndarray:
    """N stratified (jittered-grid) samples in [a, b].

    Each of N equal cells receives exactly one uniform sample; optional
    shuffling removes ordering correlation between successive rays.
    """
    k1, k2 = jax.random.split(key)
    jitter = jax.random.uniform(k1, (N,))
    if shuffle:
        # permutation of arange IS the permutation array: pure arithmetic
        cells = _shuffle_permutation(k2, N).astype(jitter.dtype)
    else:
        cells = jnp.arange(N, dtype=jitter.dtype)
    pos = (cells + jitter) / N
    return a + (b - a) * pos


# ----------------------------------------------------------------------
# stratified 2D rectangle

def stratified_rectangle_sampling(key, N: int, x0, x1, y0, y1,
                                  shuffle: bool = True):
    """N stratified samples in the rectangle [x0,x1]×[y0,y1].

    A ⌊√N⌋² jittered grid covers most samples; the remainder is drawn
    uniformly (reference random.py:8-45 uses the same grid+rest scheme).
    Returns (x, y) arrays of length N.
    """
    n = int(math.isqrt(N))
    n2 = n * n
    k1, k2, k4 = jax.random.split(key, 3)

    # permute CELL ASSIGNMENTS arithmetically instead of gathering the
    # sample arrays through a permutation: jitter is iid per output slot,
    # so assigning slot i the grid cell perm(i) (or a plain uniform draw
    # for the N − n² remainder cells) gives the identical distribution
    # with zero gathers (instead of two N-element permutation gathers per
    # ray-generation call).
    if shuffle and N > 1:
        pi = _shuffle_permutation(k4, N)
    else:
        pi = jnp.arange(N, dtype=jnp.int32)

    jx = jax.random.uniform(k1, (N,))
    jy = jax.random.uniform(k2, (N,))
    if n2 > 0:
        in_grid = pi < n2
        ix = jnp.where(in_grid, pi % n, 0).astype(jx.dtype)
        iy = jnp.where(in_grid, pi // n, 0).astype(jx.dtype)
        gx = jnp.where(in_grid, (ix + jx) / n, jx)
        gy = jnp.where(in_grid, (iy + jy) / n, jy)
    else:
        gx, gy = jx, jy

    return x0 + (x1 - x0) * gx, y0 + (y1 - y0) * gy


# ----------------------------------------------------------------------
# stratified ring / disc

def _concentric_square_to_disc(u: jnp.ndarray, v: jnp.ndarray):
    """Shirley–Chiu concentric map: unit square → unit disc, equal-area,
    stratification-preserving. Returns (r, phi)."""
    a = 2.0 * u - 1.0
    b = 2.0 * v - 1.0
    use_a = jnp.abs(a) > jnp.abs(b)
    # avoid 0/0 at the origin
    safe_a = jnp.where(a == 0, 1.0, a)
    safe_b = jnp.where(b == 0, 1.0, b)
    # signed radius keeps the formula 2-branch; fold the sign into the angle
    rs = jnp.where(use_a, a, b)
    phi = jnp.where(use_a,
                    (jnp.pi / 4.0) * (b / safe_a),
                    (jnp.pi / 2.0) - (jnp.pi / 4.0) * (a / safe_b))
    phi = jnp.where(rs < 0, phi + jnp.pi, phi)
    phi = jnp.where((a == 0) & (b == 0), 0.0, phi)
    return jnp.abs(rs), phi


def stratified_ring_sampling(key, N: int, ri: float, r: float,
                             polar: bool = False):
    """N equal-area stratified samples on the annulus ri ≤ ρ ≤ r.

    Stratified square samples are pushed through the concentric equal-area
    map to the unit disc, then the radius is remapped so the area density
    stays uniform on the annulus: ρ = √(ri² + t²·(r² − ri²)) with t the disc
    radius (reference random.py:70-110 equal-area annulus scheme).
    """
    u, v = stratified_rectangle_sampling(key, N, 0.0, 1.0, 0.0, 1.0)
    t, phi = _concentric_square_to_disc(u, v)
    rho = jnp.sqrt(ri * ri + t * t * (r * r - ri * ri))
    if polar:
        return rho, phi
    return rho * jnp.cos(phi), rho * jnp.sin(phi)


# ----------------------------------------------------------------------
# inverse-transform sampling

def cdf_from_pdf(x: jnp.ndarray, f: jnp.ndarray) -> jnp.ndarray:
    """Normalized CDF of a tabulated pdf via cumulative trapezoid rule.

    Matches the reference's continuous inverse-transform construction
    (random.py:113-140: cumtrapz + linear-interp inverse).
    """
    dx = x[1:] - x[:-1]
    seg = 0.5 * (f[1:] + f[:-1]) * dx
    cdf = jnp.concatenate([jnp.zeros((1,), f.dtype), jnp.cumsum(seg)])
    return cdf / cdf[-1]


def inverse_transform_from_u(u: jnp.ndarray, x: jnp.ndarray,
                             f: jnp.ndarray) -> jnp.ndarray:
    """Map uniform samples u∈[0,1] through the inverse CDF of pdf f over x.

    The inverse CDF is resampled once onto a uniform u-grid so the per-ray
    lookup is index arithmetic instead of a binary search (hot path: every
    generated ray samples a wavelength this way).
    """
    from .interp import uniform_interp, invert_cdf_uniform
    cdf = cdf_from_pdf(x, f)
    M = 4096
    table = invert_cdf_uniform(x, cdf, M)
    return uniform_interp(u, table, 0.0, 1.0 / (M - 1),
                          left=x[0], right=x[-1])


def inverse_transform_sampling(key, N: int, x: jnp.ndarray, f: jnp.ndarray,
                               kind: str = "continuous") -> jnp.ndarray:
    """Sample N values from a tabulated distribution.

    kind="continuous": f is a pdf over grid x, sampled by linear inverse-CDF
    interpolation. kind="discrete": f are probabilities of the discrete
    values x (reference random.py:141-159 cumsum + 'next' interpolation).
    Uses stratified uniforms so spectral sampling noise drops ~1/N.
    """
    u = stratified_interval_sampling(key, N, 0.0, 1.0, shuffle=True)
    if kind == "continuous":
        return inverse_transform_from_u(u, x, f)
    if kind == "discrete":
        p = f / jnp.sum(f)
        cdf = jnp.cumsum(p)
        idx = jnp.searchsorted(cdf, u, side="left")
        idx = jnp.clip(idx, 0, x.shape[0] - 1)
        return x[idx]
    raise ValueError(f"Unknown sampling kind '{kind}'.")

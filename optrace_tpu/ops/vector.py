"""Row-wise vector math on (..., 3) ray bundles.

Device equivalent of reference ``optrace/tracer/misc.py:94-169`` (rdot,
cross, normalize, masked_assign) — pure functions over jnp arrays, shaped so
XLA keeps the 3-vector axis in registers and vectorizes over the ray axis.

Layout note: ray bundles are stored as (N, 3) arrays; the helpers take
the vector axis as an argument, so a transposed (3, N) "planar" layout
works as well.
"""

import jax.numpy as jnp


def rdot(a: jnp.ndarray, b: jnp.ndarray, axis: int = -1) -> jnp.ndarray:
    """Row-wise dot product of vector bundles (reference misc.py:94-117)."""
    return jnp.sum(a * b, axis=axis)


def cross(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Row-wise cross product for (..., 3) bundles (reference misc.py:152-169)."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return jnp.stack([a1 * b2 - a2 * b1,
                      a2 * b0 - a0 * b2,
                      a0 * b1 - a1 * b0], axis=-1)


def norm(a: jnp.ndarray, axis: int = -1) -> jnp.ndarray:
    """Euclidean norm along ``axis``."""
    return jnp.sqrt(jnp.sum(a * a, axis=axis))


def normalize(a: jnp.ndarray, axis: int = -1) -> jnp.ndarray:
    """Normalize vector bundles; zero-length rows produce nan
    (reference misc.py:136-150 semantics)."""
    n = norm(a, axis=axis)
    return a / jnp.expand_dims(n, axis)


def normalize_safe(a: jnp.ndarray, axis: int = -1,
                   fallback: float = 0.0) -> jnp.ndarray:
    """Normalize, mapping zero-length rows to ``fallback`` instead of nan.

    Preferred inside traced code where nan would poison downstream masks.
    Also gradient-safe: the sqrt argument is pushed away from 0 first so
    reverse-mode never sees an infinite cotangent.
    """
    n2 = jnp.sum(a * a, axis=axis)
    ok = n2 > 0
    n = jnp.sqrt(jnp.where(ok, n2, 1.0))
    out = a / jnp.expand_dims(n, axis)
    return jnp.where(jnp.expand_dims(ok, axis), out, fallback)


def masked_assign(where, a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Functional replacement for the reference's in-place masked assignment
    (misc.py:120-133): returns ``a`` with ``b`` where ``where`` is True."""
    if where.ndim < a.ndim:
        where = jnp.expand_dims(where, tuple(range(where.ndim, a.ndim)))
    return jnp.where(where, b, a)

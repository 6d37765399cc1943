"""Detector intersection search over ray sections.

Device equivalent of reference ``raytracer.py:881-1051``: instead of a
data-dependent per-ray advance loop, every ray tests each of its nt−1
section segments against the detector surface in a static scan; the first
segment whose hit lies before the next stored section wins. O(nt · N)
fully-vectorized work instead of host-side masking loops.

Two entry points share the same per-segment kernel:

- :func:`detector_hits` scans *stored* sections (N, nt, 3) — the
  post-trace host API path;
- :func:`segment_update` is the streaming form used as a trace sink by
  the fused render (optrace_tpu/parallel/render.py): the segment between
  consecutive trace states is tested while the trace is still running, so
  no (N, nt, 3) section tensor ever materializes.
"""

import jax
import jax.numpy as jnp

from ..ops import geom
from .scene_compile import SurfaceFns


def build_segment_mask(section_z_bounds: list, det_zmin: float, det_zmax: float) -> list:
    """Static per-segment relevance: segment j (between stored sections j
    and j+1) can contain a detector hit only if the detector z-range
    overlaps [section_j.z_min, section_{j+1}.z_max]."""
    eps = 1e-3
    mask = []
    for j in range(len(section_z_bounds) - 1):
        lo = section_z_bounds[j][0] - eps
        hi = section_z_bounds[j + 1][1] + eps
        mask.append(det_zmin <= hi and det_zmax >= lo)
    if not any(mask):
        mask = [True] * (len(section_z_bounds) - 1)
    return mask


def init_hit_carry(Nr: int, dtype=jnp.float32):
    """Fresh accumulator for the segment scan: (ph, wsel, is_hit, done, n_ill)."""
    return (jnp.zeros((Nr, 3), dtype=dtype),
            jnp.zeros((Nr,), dtype=dtype),
            jnp.zeros((Nr,), dtype=bool),
            jnp.zeros((Nr,), dtype=bool),
            jnp.zeros((), dtype=jnp.int32))


def segment_update(sfns: SurfaceFns, det_zmin: float, pj, pj1, wj, carry):
    """Test one ray segment (section j → j+1) against the detector.

    :param pj, pj1: segment start/end positions (N, 3)
    :param wj: ray weight at the segment start (N,)
    :param carry: accumulator from :func:`init_hit_carry`
    :return: updated carry
    """
    ph, wsel, is_hit, done, n_ill = carry

    seg = pj1 - pj
    l2 = jnp.sum(seg * seg, axis=-1, keepdims=True)
    moving2 = l2 > 0
    slen = jnp.sqrt(jnp.where(moving2, l2, 1.0))
    sj = jnp.where(moving2, seg / slen, 0.0)

    o = pj - sfns.params["pos"]
    t, valid, ill = sfns.hit_fn(sfns.params, o, sj)
    t2, ok, _ = geom.clamp_abnormal(o, sj, t, valid, sfns.params["z_max_rel"])
    cand = pj + t2[:, None] * sj
    rel = cand - sfns.params["pos"]
    mask_hit = sfns.mask_fn(sfns.params, rel[:, 0], rel[:, 1]) & ok

    reach = pj1[:, 2] >= det_zmin - geom.C_EPS
    before_next = cand[:, 2] <= pj1[:, 2] + geom.C_EPS
    accept = ~done & reach & before_next & moving2[:, 0] & jnp.isfinite(t2)

    ph = jnp.where(accept[:, None], cand, ph)
    wsel = jnp.where(accept, wj, wsel)
    is_hit = jnp.where(accept, mask_hit, is_hit)
    n_ill = n_ill + jnp.sum((ill & accept).astype(jnp.int32))
    done = done | accept
    return ph, wsel, is_hit, done, n_ill


def detector_hits(sfns: SurfaceFns, det_zmin: float, p_all, w_all,
                  segment_mask: list = None):
    """Find detector intersections for all rays from stored sections.

    :param sfns: compiled detector surface
    :param det_zmin: detector z-extent minimum (first-reach criterion)
    :param p_all: stored positions (N, nt, 3)
    :param w_all: stored weights (N, nt)
    :param segment_mask: optional static per-segment booleans; segments
        whose section z-ranges cannot contain the detector are skipped
        entirely (big win when the detector sits behind the last surface:
        the scan collapses from nt−1 segments to one or two)
    :return: (ph (N,3), w_sel (N,), is_hit (N,), n_ill scalar)
    """
    nt = p_all.shape[1]
    carry = init_hit_carry(p_all.shape[0], p_all.dtype)
    js = [j for j in range(nt - 1)
          if segment_mask is None or segment_mask[j]]

    if len(js) >= 4:
        # many active segments (e.g. the differentiable-design path without
        # a mask): run ONE scanned segment body instead of nt-1 unrolled
        # copies, keeping XLA program size O(1) in surface count
        pj = jnp.stack([p_all[:, j] for j in js])          # (L, N, 3)
        pj1 = jnp.stack([p_all[:, j + 1] for j in js])
        wj = jnp.stack([w_all[:, j] for j in js])

        leaves = [pj, pj1, wj]
        vma = frozenset().union(*(jax.typeof(a).vma for a in leaves))

        def _pv(a):
            missing = vma - jax.typeof(a).vma
            return jax.lax.pcast(a, tuple(missing), to="varying") if missing else a

        def body(c, x):
            return segment_update(sfns, det_zmin, x[0], x[1], x[2], c), None

        carry = jax.tree_util.tree_map(_pv, carry)
        carry, _ = jax.lax.scan(body, carry, (pj, pj1, wj))
    else:
        for j in js:
            carry = segment_update(sfns, det_zmin, p_all[:, j], p_all[:, j + 1],
                                   w_all[:, j], carry)
    ph, wsel, is_hit, done, n_ill = carry
    return ph, wsel, is_hit & done, n_ill


def sphere_projection_xy(x, y, z, pos, R: float, method: str):
    """jnp form of SphericalSurface.sphere_projection (reference
    spherical_surface.py:36-97) for on-device binning in the fused render.
    Returns projected (x', y')."""
    x0, y0, z0 = pos[0], pos[1], pos[2]
    zm = z0 + R
    if method is None or method == "Orthographic":
        return x, y
    if method == "Equidistant":
        r = jnp.hypot(x - x0, y - y0)
        theta = -jnp.sign(R) * jnp.arctan(r / (z - zm))
        phi = jnp.arctan2(y - y0, x - x0)
        return theta * jnp.cos(phi), theta * jnp.sin(phi)
    if method == "Stereographic":
        r = jnp.hypot(x - x0, y - y0)
        theta = jnp.pi / 2 - jnp.arctan(r / (z - zm))
        phi = jnp.arctan2(y - y0, x - x0)
        rp = -2.0 * jnp.sign(R) * jnp.tan(jnp.pi / 4 - theta / 2)
        return rp * jnp.cos(phi), rp * jnp.sin(phi)
    if method == "Equal-Area":
        x_ = (x - x0) / abs(R)
        y_ = (y - y0) / abs(R)
        z_ = (z - zm) / R
        f = jnp.sqrt(2.0 / (1.0 - z_))
        return f * x_, f * y_
    raise ValueError(f"Invalid projection_method {method}.")

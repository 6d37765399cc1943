"""Sharded fused render: source sampling → trace → detector binning, with
rays sharded over a mesh axis and detector XYZW tiles psum-merged.

This is the device-parallel equivalent of the reference's thread-slice data
parallelism (raytracer.py:285-289) + per-channel binning threads
(render_image.py:398-407), and the compute path used by iterative
(megabatched) rendering at 10⁷–10⁸+ rays. Detector crossings are consumed
*while the trace runs* (a streaming sink in trace_bundle, see
tracer/detector.segment_update) and sections are never stored, so HBM
usage is O(N_shard) per batch regardless of total ray count AND surface
count — the reference instead re-materializes all N×nt sections per batch
(raytracer.py:1134-1279).
"""

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..geometry import SphericalSurface
from ..tracer.scene_compile import compile_surface
from ..tracer.trace_core import trace_bundle
from ..tracer.detector import (detector_hits, build_segment_mask, init_hit_carry,
                               segment_update, sphere_projection_xy)
from ..ops import binning


def default_mesh(axis_name: str = "rays") -> Mesh:
    """1D mesh over all available devices."""
    devs = np.array(jax.devices())
    return Mesh(devs, (axis_name,))


def _detector_sink(RT, detector_index: int, projection_method, extent,
                   Nx: int, Ny: int, filter_extent=None):
    """Build (sink_fn, init_carry, finalize) for one detector config.

    ``finalize(carry, wl)`` bins the accumulated hits into an (Ny, Nx, 4)
    XYZW tile, applying the sphere projection on device when the detector
    surface is spherical. ``filter_extent`` optionally drops hits outside
    a tighter box than the binning extent (the iterative-render semantics:
    rays outside the first batch's auto extent are discarded, reference
    raytracer.py:1034-1049, even when the limit filter widens the grid).
    """
    dsurf = RT.detectors[detector_index].surface
    sfns = compile_surface(dsurf)
    det_zmin = float(dsurf.z_min)
    seg_mask = build_segment_mask(RT._section_z_bounds(),
                                  det_zmin, float(dsurf.z_max))
    if extent is None:
        extent = dsurf.extent[:4]
    ext = tuple(float(v) for v in extent)

    spherical = isinstance(dsurf, SphericalSurface) and projection_method is not None
    pos = tuple(float(v) for v in dsurf.pos)
    R = float(dsurf.R) if spherical else 0.0

    def sink(j, p_prev, p_new, w_prev, carry):
        if not seg_mask[j]:
            return carry
        return segment_update(sfns, det_zmin, p_prev, p_new, w_prev, carry)

    def finalize(carry, wl):
        ph, wsel, is_hit, done, _ = carry
        wm = jnp.where(is_hit & done, wsel, 0.0)
        x, y = ph[:, 0], ph[:, 1]
        if spherical:
            x, y = sphere_projection_xy(x, y, ph[:, 2], pos, R, projection_method)
        if filter_extent is not None:
            fx = filter_extent
            inside = (fx[0] <= x) & (x <= fx[1]) & (fx[2] <= y) & (y <= fx[3])
            wm = jnp.where(inside, wm, 0.0)
        return binning.bin_xyzw(x, y, wm, wl, Nx, Ny, ext)

    return sink, finalize, ext, seg_mask


def make_fused_render_multi(RT, N_batch: int, configs: list):
    """Streaming fused render for several detector views of ONE trace.

    :param RT: Raytracer (geometry checked, detectors already positioned)
    :param N_batch: rays per call
    :param configs: list of dicts with keys detector_index, extent
        (4-tuple or None → detector surface extent), projection_method,
        Nx, Ny, and optionally pos (detector position; the detector is
        moved there BEFORE its sink is captured, so one detector rendered
        at several positions binds each position correctly — each sink
        closes over surface state at capture time)
    :return: (render(key) -> (list[(Ny,Nx,4) imgs], infos), list[extent])
    """
    RT.rays.init(RT.ray_sources, N_batch, len(RT.tracing_surfaces) + 2, RT.no_pol)
    steps = RT._build_steps()
    gen = RT._make_source_fn(N_batch)
    outline = tuple(float(v) for v in RT.outline)
    n0_fn = RT.n0
    no_pol, use_hurb = RT.no_pol, RT.use_hurb
    hurb_factor = float(RT.HURB_FACTOR)

    sinks, finalizers, exts = [], [], []
    for cfg in configs:
        if cfg.get("pos") is not None:
            RT.detectors[cfg.get("detector_index", 0)].move_to(cfg["pos"])
        sink, fin, ext, seg_mask = _detector_sink(
            RT, cfg.get("detector_index", 0),
            cfg.get("projection_method", "Equidistant"),
            cfg.get("extent"), cfg.get("Nx", 945),
            cfg.get("Ny", 945), cfg.get("filter_extent"))
        # the seg_mask rides along so trace_bundle can keep conic runs whose
        # segments no sink consumes on the scanned fast path
        sinks.append((sink, init_hit_carry(N_batch), seg_mask))
        finalizers.append(fin)
        exts.append(ext)

    def render(key):
        k_src, k_trace = jax.random.split(key)
        p, s, pols, w, wl = gen(k_src)
        out = trace_bundle(steps, n0_fn, outline, p, s, pols, w, wl,
                           no_pol, use_hurb, key=k_trace,
                           sinks=sinks, store_sections=False,
                           hurb_factor=hurb_factor)
        imgs = [fin(carry, out["wl"]) for fin, carry in zip(finalizers, out["sinks"])]
        return imgs, out["infos"]

    return render, exts


def make_fused_render(RT, N_batch: int, detector_index: int = 0,
                      extent=None, Nx: int = 945, Ny: int = 945,
                      projection_method: str = "Equidistant"):
    """Single-detector fused render step: key → (Ny, Nx, 4) XYZW image.

    ``extent`` must be fixed (auto-extent requires a host round trip).
    """
    render, exts = make_fused_render_multi(
        RT, N_batch, [dict(detector_index=detector_index, extent=extent,
                           projection_method=projection_method,
                           Nx=Nx, Ny=Ny)])

    def render_one(key):
        imgs, _ = render(key)
        return imgs[0]

    return render_one, exts[0]


def make_sharded_render(RT, N_batch: int, mesh: Mesh = None, detector_index: int = 0,
                        extent=None, Nx: int = 945, Ny: int = 945,
                        axis_name: str = "rays",
                        projection_method: str = "Equidistant"):
    """Sharded fused render step over a device mesh.

    Returns ``(step, extent)`` where ``step(keys)`` takes per-device PRNG
    keys of shape (n_devices, 2) and returns the psum-merged (Ny, Nx, 4)
    image. Each shard traces N_batch/n_devices rays.
    """
    mesh = mesh if mesh is not None else default_mesh(axis_name)
    n_dev = mesh.devices.size
    if N_batch % n_dev:
        raise ValueError(f"N_batch={N_batch} must be divisible by the mesh size {n_dev}.")

    render_one, ext = make_fused_render(RT, N_batch // n_dev, detector_index, extent,
                                        Nx, Ny, projection_method)

    @partial(shard_map, mesh=mesh, in_specs=P(axis_name), out_specs=P())
    def step(keys):
        # each shard samples its rays at full source power; rescale so the
        # psum over shards carries the true total power
        img = render_one(keys[0]) / n_dev
        return jax.lax.psum(img, axis_name)

    def run(key):
        keys = jax.random.split(key, n_dev)
        return step(keys)

    return jax.jit(run), ext

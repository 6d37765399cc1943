"""Ray source: emitting geometry + spectrum + divergence + polarization.

Behavioral parity with reference
``optrace/tracer/geometry/ray_source.py:204-437`` (create_rays), rebuilt
stateless: ``create_rays(key, N, ...)`` is a pure jnp function of a PRNG
key so ray generation runs *inside* the jitted, sharded trace (each shard
folds its index into the key).

Emitter kinds: Surface (uniform emittance), Point/Line, RGBImage (per-pixel
probability ∝ linear-RGB radiant power, wavelengths from the sRGB primary
spectra matching the pixel color) and GrayscaleImage (emittance from image,
user spectrum). Divergence None/Lambertian/Isotropic/Function (cone or 2D
arc); orientation Constant/Converging/Function; polarization
x/y/xy/Constant/Uniform/List/Function with transport onto each ray's
transverse plane.
"""

from typing import Any, Callable

import numpy as np
import jax
import jax.numpy as jnp

from .element import Element
from .surface import Surface, RectangularSurface
from .point import Point
from .line import Line
from ..spectrum.light_spectrum import LightSpectrum
from .. import color
from ..ops import sampling
from ..ops.vector import cross as jcross, normalize_safe
from ..utils.property_checker import PropertyChecker as pc
from ..image.rgb_image import RGBImage
from ..image.grayscale_image import GrayscaleImage


class RaySource(Element):

    divergences: list = ["None", "Lambertian", "Isotropic", "Function"]
    orientations: list = ["Constant", "Converging", "Function"]
    polarizations: list = ["Constant", "Uniform", "List", "Function", "x", "y", "xy"]

    abbr: str = "RS"
    _allow_non_2D: bool = True
    _max_image_px: float = 2e6

    def __init__(self, surface, pos=None,
                 divergence: str = "None", div_angle: float = 0.5,
                 div_2d: bool = False, div_axis_angle: float = 0,
                 div_func: Callable = None, div_args: dict = None,
                 spectrum: LightSpectrum = None, power: float = 1.,
                 s=None, s_sph=None, orientation: str = "Constant",
                 conv_pos=None, or_func: Callable = None, or_args: dict = None,
                 polarization: str = "Uniform", pol_angle: float = 0.,
                 pol_angles=None, pol_probs=None, pol_func: Callable = None,
                 pol_args: dict = None, **kwargs) -> None:
        self._new_lock = False

        if isinstance(surface, RGBImage):
            if surface.shape[0] * surface.shape[1] > self._max_image_px:
                raise RuntimeError(f"Image has more than {self._max_image_px:.0f} pixels.")
            surface_ = RectangularSurface(dim=surface.s)
            self._image = surface
            sRGBL = np.asarray(color.srgb_to_srgb_linear(surface._data))
            If = np.asarray(color.power_from_srgb_linear(sRGBL)).flatten()
            self._pIf = If / If.sum()
            sRGBL_mean = np.mean(sRGBL, axis=(0, 1))
            self._mean_img_color = np.asarray(
                color.srgb_linear_to_srgb(np.asarray(sRGBL_mean)[None, None, :]))[0, 0]
        elif isinstance(surface, GrayscaleImage):
            if surface.shape[0] * surface.shape[1] > self._max_image_px:
                raise RuntimeError(f"Image has more than {self._max_image_px:.0f} pixels.")
            surface_ = RectangularSurface(dim=surface.s)
            self._image = surface
            self._mean_img_color = None
            If = np.asarray(color.srgb_to_srgb_linear(surface.data)).ravel()
            self._pIf = If / If.sum()
        else:
            surface_ = surface
            self._image = None
            self._pIf = None
            self._mean_img_color = None

        pos = pos if pos is not None else [0, 0, 0]
        super().__init__(surface_, pos, **kwargs)

        self.power = power
        from ..presets.light_spectrum import d65 as d65_spectrum
        self.spectrum = spectrum if spectrum is not None else d65_spectrum

        self.polarization = polarization
        self.pol_angle = pol_angle
        self.pol_func = pol_func
        self.pol_angles = pol_angles
        self.pol_probs = pol_probs
        self.pol_args = pol_args if pol_args is not None else {}

        self.divergence = divergence
        self.div_angle = div_angle
        self.orientation = orientation
        self.conv_pos = conv_pos if conv_pos is not None else [0, 0, 0]
        self.or_func = or_func
        self.or_args = or_args if or_args is not None else {}

        if s_sph is None:
            self.s = s if s is not None else [0, 0, 1]
        else:
            pc.check_type("s_sph", s_sph, (list, np.ndarray))
            theta, phi = np.radians(s_sph[0]), np.radians(s_sph[1])
            self.s = [np.sin(theta) * np.cos(phi), np.sin(theta) * np.sin(phi), np.cos(theta)]

        self.div_axis_angle = div_axis_angle
        self.div_func = div_func
        self.div_2d = div_2d
        self._new_lock = True

    # ------------------------------------------------------------------
    def create_rays(self, key, N: int, no_pol: bool = False, power: float = None):
        """Generate N rays (p, s, pols, weights, wavelengths) as jnp arrays.

        Pure function of ``key``; fully traceable.
        """
        k_pos, k_wl, k_div, k_alpha, k_pol, k_px = jax.random.split(key, 6)

        power = power if power is not None else self.power
        weights = jnp.full((N,), power / N, dtype=jnp.float32)

        # wavelengths (RGBImage handled below with pixel choice)
        if not isinstance(self._image, RGBImage):
            pc.check_type("RaySource.spectrum", self.spectrum, LightSpectrum)
            wavelengths = self.spectrum.random_wavelengths(k_wl, N)

        # starting positions
        if self._image is None:
            p = jnp.asarray(self.surface.random_positions(k_pos, N))
        else:
            Iy, Ix = self._image.shape[:2]
            if Iy == 1 and Ix == 1:
                PY = jnp.zeros((N,), dtype=jnp.int32)
                PX = jnp.zeros((N,), dtype=jnp.int32)
            else:
                # guided lower-bound search: host-precomputed guide table
                # brackets each u into [guide[j], guide[j+1]] so the device
                # search needs only ceil(log2(max bracket)) gather rounds
                # instead of log2(Iy·Ix) — bit-identical to a full
                # searchsorted(side='left'), ~10× fewer passes at 512².
                # M is a power of two: u·M and j/M are then EXACT in f32,
                # so the bracket never misses by a rounding ulp.
                cdf_np = np.cumsum(self._pIf)
                # the guide MUST bracket the f32 cdf the device compares
                # against — an f64 guide can be off by one where rounding
                # crosses a j/M grid line
                cdf_np = (cdf_np / cdf_np[-1]).astype(np.float32)
                # guide resolution ~4 cells per pixel: expected bracket
                # width ≤ 1, so the refinement usually needs 1-2 gather
                # rounds
                M = 1 << min(20, max(12, (4 * Iy * Ix - 1).bit_length()))
                guide_np = np.searchsorted(
                    cdf_np, (np.arange(M + 1) / M).astype(np.float32),
                    side="left").astype(np.int32)
                n_iter = max(1, int(np.max(np.diff(guide_np)) + 1).bit_length())
                cdf = jnp.asarray(cdf_np)
                # (lo, hi) pairs in one row gather instead of two scattered
                # table reads
                guide_pairs = jnp.asarray(
                    np.stack([guide_np[:-1], guide_np[1:]], axis=1))
                u = sampling.stratified_interval_sampling(k_px, N, 0.0, 1.0)
                j = jnp.minimum((u * M).astype(jnp.int32), M - 1)
                pair = guide_pairs[j]
                lo = pair[:, 0]
                hi = pair[:, 1]
                K = Iy * Ix
                for _ in range(n_iter):
                    mid = (lo + hi) >> 1
                    go_right = jnp.take(cdf, jnp.minimum(mid, K - 1)) < u
                    lo = jnp.where(go_right, mid + 1, lo)
                    hi = jnp.where(go_right, hi, mid)
                P = jnp.clip(lo, 0, K - 1)
                PY, PX = jnp.divmod(P, Ix)

            rx, ry = sampling.stratified_rectangle_sampling(k_pos, N, 0.0, 1.0, 0.0, 1.0)
            xs, xe, ys, ye = self.surface.extent[:4]
            px = (xe - xs) / Ix * (PX + rx) + xs
            py = (ye - ys) / Iy * (PY + ry) + ys
            p = jnp.stack([px, py, jnp.full((N,), self.pos[2])], axis=-1)

            if isinstance(self._image, RGBImage):
                pix_rgb = jnp.asarray(self._image._data.reshape(-1, 3))[PY * Ix + PX]
                wavelengths = color.random_wavelengths_from_srgb(k_wl, pix_rgb)

        # orientations
        if self.orientation == "Constant":
            s_or = jnp.broadcast_to(jnp.asarray(self.s, dtype=jnp.float32), (N, 3))
        elif self.orientation == "Converging":
            s_or = normalize_safe(jnp.asarray(self.conv_pos) - p)
        elif self.orientation == "Function":
            pc.check_callable("RaySource.or_func", self.or_func)
            s_or = jnp.asarray(self.or_func(p[:, 0], p[:, 1], **self.or_args))
        else:
            raise RuntimeError(f"Unknown orientation '{self.orientation}'.")  # pragma: no cover

        # divergence angles (theta from axis, alpha azimuthal)
        div = self.divergence
        if div == "Function":
            pc.check_callable("RaySource.div_func", self.div_func)

        if self.div_2d:
            # 2D divergence: alpha takes two discrete values
            t = jnp.asarray([np.radians(self.div_axis_angle), np.radians(self.div_axis_angle) + np.pi])
            alpha = sampling.inverse_transform_sampling(k_alpha, N, t, jnp.ones(2), kind="discrete")

        if div == "None":
            s = s_or
        else:
            if div == "Lambertian" and not self.div_2d:
                r, alpha = sampling.stratified_ring_sampling(
                    k_div, N, 0.0, np.sin(np.radians(self.div_angle)), polar=True)
                theta = jnp.arcsin(r)
            elif div == "Lambertian":
                X0 = sampling.stratified_interval_sampling(k_div, N, 0.0, np.sin(np.radians(self.div_angle)))
                theta = jnp.arcsin(X0)
            elif div == "Isotropic" and not self.div_2d:
                r, alpha = sampling.stratified_ring_sampling(
                    k_div, N, 0.0, np.sin(np.radians(self.div_angle)), polar=True)
                # theta = arccos(1 - r²) rewritten via the half-angle
                # identity: f32-stable for small cones, where 1 - r² rounds
                # to ~6 discrete levels (ulp(1.0)=1.2e-7 vs r² ~ 1e-6) and
                # would quantize the whole divergence distribution
                theta = 2.0 * jnp.arcsin(r * np.sqrt(0.5))
            elif div == "Isotropic":
                theta = sampling.stratified_interval_sampling(k_div, N, 0.0, np.radians(self.div_angle))
            elif div == "Function" and not self.div_2d:
                div_sin = np.sin(np.radians(self.div_angle))
                r, alpha = sampling.stratified_ring_sampling(k_div, N, 0.0, div_sin, polar=True)
                x = jnp.linspace(0.0, np.radians(self.div_angle), 1000)
                f = jnp.asarray(self.div_func(x, **self.div_args)) * jnp.sin(x)
                X0 = r ** 2 / div_sin ** 2
                theta = sampling.inverse_transform_from_u(X0, x, f)
            elif div == "Function":
                x = jnp.linspace(0.0, np.radians(self.div_angle), 1000)
                f = jnp.asarray(self.div_func(x, **self.div_args))
                theta = sampling.inverse_transform_sampling(k_div, N, x, f)
            else:
                raise RuntimeError(f"Unknown divergence '{div}'.")  # pragma: no cover

            # local frame around s_or: sy = [1,0,0] × s_or (normalized), sx = s_or × sy
            fa = 1.0 / jnp.sqrt(jnp.maximum(1.0 - s_or[:, 0] ** 2, 1e-12))
            sy = jnp.stack([jnp.zeros((N,)), -s_or[:, 2] * fa, s_or[:, 1] * fa], axis=-1)
            sx = jcross(s_or, sy)
            th = theta[:, None]
            al = alpha[:, None]
            s = jnp.cos(th) * s_or + jnp.sin(th) * (jnp.cos(al) * sx + jnp.sin(al) * sy)

        # polarization
        if no_pol:
            pols = jnp.full((N, 3), jnp.nan, dtype=jnp.float32)
        else:
            polm = self.polarization
            if polm == "x":
                ang = jnp.zeros((N,))
            elif polm == "y":
                ang = jnp.full((N,), np.pi / 2)
            elif polm == "xy":
                ang = sampling.inverse_transform_sampling(
                    k_pol, N, jnp.asarray([0.0, np.pi / 2]), jnp.ones(2), kind="discrete")
            elif polm == "Constant":
                ang = jnp.full((N,), np.radians(self.pol_angle))
            elif polm == "Uniform":
                ang = sampling.stratified_interval_sampling(k_pol, N, 0.0, 2 * np.pi)
            elif polm == "List":
                pc.check_type("RaySource.pol_angles", self.pol_angles, (np.ndarray, list))
                probs = self.pol_probs if self.pol_probs is not None else np.ones_like(self.pol_angles)
                ang = sampling.inverse_transform_sampling(
                    k_pol, N, jnp.asarray(self.pol_angles), jnp.asarray(probs), kind="discrete")
                ang = jnp.radians(ang)
            elif polm == "Function":
                pc.check_callable("RaySource.pol_func", self.pol_func)
                x = jnp.linspace(0.0, 2 * np.pi, 5000)
                f = jnp.asarray(self.pol_func(x, **self.pol_args))
                ang = sampling.inverse_transform_sampling(k_pol, N, x, f)
                ang = jnp.radians(ang)
            else:
                raise RuntimeError(f"Unknown polarization '{polm}'.")  # pragma: no cover

            # transport the xy-plane polarization onto each ray's transverse
            # plane (reference ray_source.py:383-433). The in-plane frame
            # axis comes from s_xy DIRECTLY (|ps| = 1 by construction):
            # 1/sqrt(1−s_z²) is an f32 trap — normalize can round s_z one
            # ulp above 1, the sqrt clamps to 0 and the 1e16 guard factor
            # turned some polarization vectors into ~1e23 garbage
            pol0 = jnp.stack([jnp.cos(ang), jnp.sin(ang), jnp.zeros((N,))], axis=-1)
            rxy = jnp.hypot(s[:, 0], s[:, 1])
            axial = rxy < 1e-9
            fa = 1.0 / jnp.where(axial, 1.0, rxy)
            ps = jnp.stack([s[:, 1] * fa, -s[:, 0] * fa, jnp.zeros((N,))], axis=-1)
            A_ts = ps[:, 0] * pol0[:, 0] + ps[:, 1] * pol0[:, 1]
            A_tp = ps[:, 1] * pol0[:, 0] - ps[:, 0] * pol0[:, 1]
            pp_ = jcross(ps, s)
            pol_t = ps * A_ts[:, None] + pp_ * A_tp[:, None]
            # axial rays: the xy-plane polarization is already transverse
            pols = jnp.where(axial[:, None], pol0, pol_t)

        return p, s, pols, weights, wavelengths

    # ------------------------------------------------------------------
    def color(self, rendering_intent: str = "Ignore", clip: bool = False):
        """Mean color of the source (image mean color for image sources,
        spectrum color otherwise)."""
        if self._mean_img_color is not None:
            return tuple(float(v) for v in self._mean_img_color)
        return self.spectrum.color(rendering_intent, clip)

    # ------------------------------------------------------------------
    def __setattr__(self, key: str, val: Any) -> None:
        if key == "divergence":
            pc.check_type(key, val, str)
            pc.check_if_element(key, val, self.divergences)
        elif key == "orientation":
            pc.check_type(key, val, str)
            pc.check_if_element(key, val, self.orientations)
        elif key == "polarization":
            pc.check_type(key, val, str)
            pc.check_if_element(key, val, self.polarizations)
        elif key in ("power", "div_angle"):
            pc.check_type(key, val, (int, float))
            val = float(val)
            pc.check_above(key, val, 0)
            if key == "div_angle":
                pc.check_not_above(key, val, 90)
        elif key in ("pol_angle", "div_axis_angle"):
            pc.check_type(key, val, (int, float))
            val = float(val)
        elif key in ("div_func", "or_func", "pol_func"):
            pc.check_none_or_callable(key, val)
        elif key == "div_2d":
            pc.check_type(key, val, bool)
        elif key in ("s", "conv_pos") and val is not None:
            pc.check_type(key, val, (list, np.ndarray))
            val2 = np.asarray(val, dtype=np.float64)
            pc.check_finite(key, val2)
            if val2.shape[0] != 3:
                raise ValueError(f"{key} needs to have 3 elements.")
            if key == "s":
                val2 = val2 / np.linalg.norm(val2)
                if val2[2] <= 0:
                    raise ValueError("Ray orientation s needs a positive z-component.")
            super().__setattr__(key, val2)
            return
        elif key == "spectrum" and val is not None:
            pc.check_type(key, val, LightSpectrum)
        super().__setattr__(key, val)

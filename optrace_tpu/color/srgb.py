"""sRGB conversions, gamut mapping (rendering intents), primary spectra.

Rebuild of reference ``optrace/tracer/color/srgb.py`` (the color
heart, SURVEY.md §2.3). Everything is branchless jnp over (..., 3) arrays so
it can sit at the end of a jitted render pipeline.

Numeric constants (sRGB primary chromaticities, Lindbloom conversion
matrices, CIELUV gamut polygon, synthetic-primary Gaussian parameters and
power factors) are *behavioral spec* shared with the reference: the
synthetic r/g/b primary spectra must reproduce exactly the sRGB primary
xyY coordinates so that image sources mix to correct colors
(reference srgb.py:469-565).
"""

import jax
import jax.numpy as jnp

from .observers import x_observer, y_observer, z_observer
from .xyz import xyz_to_xyY, WP_D65_XY
from .luv import (xyz_to_luv, luv_to_xyz, luv_to_u_v_l,
                  SRGB_R_UV, SRGB_G_UV, SRGB_B_UV, WP_D65_UV)
from . import tools
from ..ops import sampling
from ..ops import interp
from ..utils.global_options import global_options

SRGB_RENDERING_INTENTS = ["Ignore", "Absolute", "Perceptual"]
"""Rendering intents for XYZ → sRGB conversion."""

SRGB_R_XY = [0.64, 0.33]   #: sRGB red primary xy chromaticity (IEC 61966-2-1)
SRGB_G_XY = [0.30, 0.60]   #: sRGB green primary xy chromaticity
SRGB_B_XY = [0.15, 0.06]   #: sRGB blue primary xy chromaticity

# Relative radiant powers of the synthetic primary curves below over the
# default wavelength range; needed so per-pixel emission probability is
# proportional to radiant power (reference srgb.py:24-27).
_SRGB_R_PRIMARY_POWER_FACTOR = 0.885651229244
_SRGB_G_PRIMARY_POWER_FACTOR = 1.000000000000
_SRGB_B_PRIMARY_POWER_FACTOR = 0.775993481741
SRGB_PRIMARY_POWER_FACTORS = [_SRGB_R_PRIMARY_POWER_FACTOR,
                              _SRGB_G_PRIMARY_POWER_FACTOR,
                              _SRGB_B_PRIMARY_POWER_FACTOR]

# Lindbloom sRGB (D65) matrices
_M_RGB_TO_XYZ = [[0.4124564, 0.3575761, 0.1804375],
                 [0.2126729, 0.7151522, 0.0721750],
                 [0.0193339, 0.1191920, 0.9503041]]
_M_XYZ_TO_RGB = [[3.2404542, -1.5371385, -0.4985314],
                 [-0.9692660, 1.8760108, 0.0415560],
                 [0.0556434, -0.2040259, 1.0572252]]


# ----------------------------------------------------------------------
# gamma

def srgb_to_srgb_linear(rgb: jnp.ndarray) -> jnp.ndarray:
    """Remove sRGB gamma (IEC 61966-2-1 EOTF). Odd-extended to negatives.
    Host inputs evaluate in numpy (ops/xp.py)."""
    from ..ops.xp import get_xp
    xp = get_xp(rgb)
    rgb = xp.asarray(rgb)
    a = 0.055
    absr = xp.abs(rgb)
    lin = xp.sign(rgb) * ((absr + a) / (1 + a)) ** 2.4
    return xp.where(absr <= 0.04045, rgb / 12.92, lin)


def srgb_linear_to_srgb(rgbl: jnp.ndarray) -> jnp.ndarray:
    """Apply sRGB gamma (inverse EOTF). Odd-extended to negatives.
    Host inputs evaluate in numpy (ops/xp.py)."""
    from ..ops.xp import get_xp
    xp = get_xp(rgbl)
    rgbl = xp.asarray(rgbl)
    a = 0.055
    absr = xp.abs(rgbl)
    enc = xp.sign(rgbl) * ((1 + a) * xp.maximum(absr, 1e-30) ** (1 / 2.4) - a)
    return xp.where(absr <= 0.0031308, 12.92 * rgbl, enc)


# ----------------------------------------------------------------------
# linear transforms

def _matmul_channels(mat, img: jnp.ndarray) -> jnp.ndarray:
    # precision="highest": the default f32 matmul precision may run reduced-
    # precision passes (TF32 on the GPU), far too coarse for a 3x3
    # colorimetric transform
    m = jnp.asarray(mat, dtype=img.dtype)
    return jnp.einsum("ij,...j->...i", m, img, precision="highest")


def srgb_linear_to_xyz(rgbl: jnp.ndarray) -> jnp.ndarray:
    """Linear sRGB → XYZ (D65)."""
    return _matmul_channels(_M_RGB_TO_XYZ, jnp.asarray(rgbl))


def srgb_to_xyz(rgb: jnp.ndarray) -> jnp.ndarray:
    """sRGB → XYZ."""
    return srgb_linear_to_xyz(srgb_to_srgb_linear(rgb))


def _to_srgb_linear_raw(xyz: jnp.ndarray, normalize: bool) -> jnp.ndarray:
    rgbl = _matmul_channels(_M_XYZ_TO_RGB, jnp.asarray(xyz))
    if normalize:
        nmax = jnp.nanmax(rgbl)
        rgbl = jnp.where(nmax > 0, rgbl / jnp.where(nmax > 0, nmax, 1.0), rgbl)
    return rgbl


def outside_srgb_gamut(xyz: jnp.ndarray) -> jnp.ndarray:
    """Boolean mask of colors outside the sRGB gamut (tolerance -1e-6)."""
    rgbl = xyz_to_srgb_linear(xyz, normalize=True, rendering_intent="Ignore")
    return jnp.any(rgbl < -1e-6, axis=-1)


# ----------------------------------------------------------------------
# gamut mapping

def _triangle_intersect(r, g, b, w, x, y):
    """Project chromaticities (x, y) towards whitepoint w onto the gamut
    triangle edge (r, g, b). Branchless version of the reference's
    per-edge masked assignment (srgb.py:126-192). Points inside the gamut
    are also projected — the caller selects which pixels to replace."""
    rx, ry = r
    gx, gy = g
    bx, by = b
    wx, wy = w

    phig = jnp.arctan2(gy - wy, gx - wx)
    phir = jnp.arctan2(ry - wy, rx - wx)
    phib = jnp.arctan2(by - wy, bx - wx) + 2 * jnp.pi

    phi = jnp.arctan2(y - wy, x - wx)
    phi = jnp.where(phi < 0, phi + 2 * jnp.pi, phi)

    aw = jnp.tan(phi)
    abg = (gy - by) / (gx - bx)
    abr = (ry - by) / (rx - bx)
    agr = (ry - gy) / (rx - gx)

    def isect(a_edge, ex, ey):
        # intersection of the whitepoint line (slope aw through (x, y)) with
        # the edge line of slope a_edge through (ex, ey)
        xi = (y - x * aw + (ex * a_edge - ey)) / (a_edge - aw)
        yi = xi * a_edge + (ey - ex * a_edge)
        return xi, yi

    x_bg, y_bg = isect(abg, bx, by)
    x_gr, y_gr = isect(agr, gx, gy)
    x_br, y_br = isect(abr, bx, by)

    is_bg = (phi <= phib) & (phi > phig)
    is_gr = (phi <= phig) & (phi > phir)

    xo = jnp.where(is_bg, x_bg, jnp.where(is_gr, x_gr, x_br))
    yo = jnp.where(is_bg, y_bg, jnp.where(is_gr, y_gr, y_br))
    return xo, yo


def _get_chroma_scale_sq(luv: jnp.ndarray):
    """Per-pixel squared chroma-scale factors to reach the gamut edge in
    u'v', plus a validity mask approximating the spectral locus polygon
    (reference srgb.py:195-243)."""
    uvl = luv_to_u_v_l(luv)
    u_, v_ = uvl[..., 0], uvl[..., 1]

    # polygonal approximation of the horseshoe of real colors
    l1 = v_ > (0.5065 - 0.013) / (0.6235 - 0.255) * (u_ - 0.2555) + 0.01373
    l2 = v_ < (0.5065 - 0.6) / 0.6235 * u_ + 0.6
    l3 = u_ > 0
    l4 = v_ > (0.013 - 0.28) / 0.255 * u_ + 0.28
    l5 = v_ > (0.0 - 0.48) / 0.18 * u_ + 0.48
    in_gamut = l1 & l2 & l3 & l4 & l5

    un, vn = WP_D65_UV
    cr0_sq = (u_ - un) ** 2 + (v_ - vn) ** 2
    uc, vc = _triangle_intersect(SRGB_R_UV, SRGB_G_UV, SRGB_B_UV, WP_D65_UV, u_, v_)
    cr1_sq = (uc - un) ** 2 + (vc - vn) ** 2
    return in_gamut, cr1_sq / (cr0_sq + 1e-9)


def get_chroma_scale(luv: jnp.ndarray, L_th: float = 0.0):
    """Global chroma scaling factor for the Perceptual rendering intent:
    the minimum per-pixel scale over valid pixels above the lightness
    threshold, clipped to [0.32, 1] (reference srgb.py:245-264)."""
    in_gamut, cr_fact2 = _get_chroma_scale_sq(luv)
    L = luv[..., 0]
    mask = in_gamut & (L > L_th * jnp.max(L))
    cr2 = jnp.where(mask, cr_fact2, jnp.inf)
    cr2_min = jnp.min(cr2)
    cr = jnp.where(jnp.isfinite(cr2_min), jnp.sqrt(cr2_min), 1.0)
    return jnp.clip(cr, 0.32, 1.0)


def xyz_to_srgb_linear(xyz: jnp.ndarray,
                       normalize: bool = True,
                       rendering_intent: str = "Absolute",
                       L_th: float = 0.0,
                       chroma_scale=None) -> jnp.ndarray:
    """XYZ → linear sRGB with gamut mapping.

    Intents (reference srgb.py:269-355):
    - "Ignore": raw matrix transform, out-of-gamut values stay negative.
    - "Absolute": per-pixel chroma clip toward the whitepoint in xy,
      preserving hue and Y.
    - "Perceptual": global chroma scale in CIELUV (factor from
      :func:`get_chroma_scale` or the ``chroma_scale`` argument), residual
      out-of-gamut pixels chroma-clipped to the gamut edge.
    """
    xyz = jnp.asarray(xyz)
    rgbl = _to_srgb_linear_raw(xyz, normalize)
    if rendering_intent == "Ignore":
        return rgbl

    if rendering_intent == "Absolute":
        inv = jnp.any(rgbl < 0, axis=-1)
        xyY = xyz_to_xyY(xyz)
        x, y, Y = xyY[..., 0], xyY[..., 1], xyY[..., 2]
        xc, yc = _triangle_intersect(SRGB_R_XY, SRGB_G_XY, SRGB_B_XY, WP_D65_XY, x, y)
        k = Y / jnp.where(yc > 0, yc, jnp.inf)
        xyz_c = jnp.stack([k * xc, Y, k * (1.0 - xc - yc)], axis=-1)
        xyz_out = jnp.where(inv[..., None], xyz_c, xyz)
        return _to_srgb_linear_raw(xyz_out, normalize)

    if rendering_intent == "Perceptual":
        xyz_p = jnp.clip(xyz, 0.0, None)
        luv = xyz_to_luv(xyz_p, normalize=False)
        in_gamut, cr_fact2 = _get_chroma_scale_sq(luv)
        cr_fact = jnp.sqrt(cr_fact2)
        if chroma_scale is None:
            chroma_scale = get_chroma_scale(luv, L_th)
        # chroma scaling for pixels within reach, chroma clipping otherwise
        cr = jnp.minimum(cr_fact, chroma_scale)
        luv = luv.at[..., 1:].multiply(cr[..., None])
        xyz_out = luv_to_xyz(luv)
        return _to_srgb_linear_raw(xyz_out, normalize)

    raise ValueError(f"Unknown rendering intent '{rendering_intent}'.")


def xyz_to_srgb(xyz: jnp.ndarray,
                normalize: bool = True,
                clip: bool = True,
                rendering_intent: str = "Absolute",
                L_th: float = 0.0,
                chroma_scale=None) -> jnp.ndarray:
    """XYZ → sRGB (gamut mapping + optional clip + gamma)."""
    rgbl = xyz_to_srgb_linear(xyz, normalize=normalize,
                              rendering_intent=rendering_intent,
                              L_th=L_th, chroma_scale=chroma_scale)
    if clip:
        rgbl = jnp.clip(rgbl, 0.0, 1.0)
    return srgb_linear_to_srgb(rgbl)


def log_srgb(img: jnp.ndarray) -> jnp.ndarray:
    """Logarithmic lightness rescale in CIELUV, chromaticity-preserving
    (reference srgb.py:410-444)."""
    img = jnp.asarray(img)
    xyz = srgb_to_xyz(img)
    luv = xyz_to_luv(xyz)
    L = luv[..., 0]
    pos = L > 0
    Lp = jnp.where(pos, L, jnp.nan)
    lmax = jnp.nanmax(Lp)
    lmin = jnp.nanmin(Lp)

    def rescale(_):
        L2 = 100.0 - 99.5 / jnp.log(lmin / lmax) * jnp.log(jnp.where(pos, L, 1.0) / lmax)
        L2 = jnp.where(pos, L2, 0.0)
        cs = jnp.where(pos, L2 / jnp.where(pos, L, 1.0), 1.0)
        luv2 = jnp.stack([L2, luv[..., 1] * cs, luv[..., 2] * cs], axis=-1)
        return xyz_to_srgb(luv_to_xyz(luv2))

    no_change = jnp.logical_or(~jnp.any(pos), lmin == lmax)
    return jax.lax.cond(no_change, lambda _: img, rescale, None)


# ----------------------------------------------------------------------
# synthetic sRGB primary spectra

def _gauss(x, mu, sig):
    from ..ops.xp import get_xp
    xp = get_xp(x)
    return 1.0 / (sig * xp.sqrt(2 * xp.pi)) * xp.exp(-0.5 * ((x - mu) / sig) ** 2)


def srgb_r_primary(wl) -> jnp.ndarray:
    """Synthetic spectrum with exactly the sRGB red primary xyY coordinates
    (Gaussian mixture, constants fitted in the reference, srgb.py:469-480)."""
    from ..ops.xp import get_xp
    xp = get_xp(wl)
    wl = xp.asarray(wl)
    rs = 0.951190393
    r = 75.1660756583 * rs * (_gauss(wl, 639.854491, 30.0)
                              + 0.0500907584 * _gauss(wl, 418.905848, 80.6220465))
    m = (wl >= tools.WL_MIN0) & (wl <= tools.WL_MAX0)
    return xp.where(m, r, 0.0)


def srgb_g_primary(wl) -> jnp.ndarray:
    """Synthetic sRGB green primary spectrum (reference srgb.py:483-494)."""
    from ..ops.xp import get_xp
    xp = get_xp(wl)
    wl = xp.asarray(wl)
    g = 83.4999222966 * _gauss(wl, 539.13108974, 33.31164968)
    m = (wl >= tools.WL_MIN0) & (wl <= tools.WL_MAX0)
    return xp.where(m, g, 0.0)


def srgb_b_primary(wl) -> jnp.ndarray:
    """Synthetic sRGB blue primary spectrum (reference srgb.py:497-508)."""
    from ..ops.xp import get_xp
    xp = get_xp(wl)
    wl = xp.asarray(wl)
    bs = 1.16364585503
    b = 47.99521746361 * bs * (_gauss(wl, 454.833119, 20.1460206)
                               + 0.184484176 * _gauss(wl, 459.658190, 71.0927568))
    m = (wl >= tools.WL_MIN0) & (wl <= tools.WL_MAX0)
    return xp.where(m, b, 0.0)


def random_wavelengths_from_srgb(key, rgb: jnp.ndarray) -> jnp.ndarray:
    """Sample one wavelength per sRGB color: choose a primary ∝ its linear
    channel power, then inverse-transform sample that primary's spectrum
    (reference srgb.py:513-553, made stateless/key-driven).
    """
    rgb = jnp.asarray(rgb)
    N = rgb.shape[0]
    rgbl = srgb_to_srgb_linear(rgb)

    if tools.WL_MIN0 < global_options.wavelength_range[0] \
            or tools.WL_MAX0 > global_options.wavelength_range[1]:
        raise RuntimeError(f"Wavelength range {global_options.wavelength_range} does not "
                           f"include [{tools.WL_MIN0}, {tools.WL_MAX0}] needed here.")

    wl = tools.wavelengths(5000)
    rgbl = rgbl * jnp.asarray(SRGB_PRIMARY_POWER_FACTORS, rgbl.dtype)

    csum = jnp.cumsum(rgbl, axis=-1)
    last = csum[:, -1:]
    csum = csum / jnp.where(last > 0, last, 1.0)

    k1, k2 = jax.random.split(key)
    choice = sampling.stratified_interval_sampling(k1, N, 0.0, 1.0)
    make_r = choice < csum[:, 0]
    make_b = choice > csum[:, 1]

    # same uniforms through all three inverse CDFs, selected per ray by a
    # flattened channel index into ONE combined (M, 3) table: 2 gathers
    # (y0, y1) instead of 6 (two per primary). The interpolation math is
    # unchanged — values are bit-identical to the three separate
    # inverse_transform_from_u calls.
    u = sampling.stratified_interval_sampling(k2, N, 0.0, 1.0)
    M = 4096
    tabs = []
    for f in (srgb_r_primary(wl), srgb_g_primary(wl), srgb_b_primary(wl)):
        cdf = sampling.cdf_from_pdf(wl, f)
        tabs.append(interp.invert_cdf_uniform(wl, cdf, M))
    table = jnp.stack(tabs, axis=-1).reshape(-1)          # (M*3,)
    c = jnp.where(make_r, 0, jnp.where(make_b, 2, 1))
    g = u * (M - 1)                                       # u ∈ [0, 1)
    idx = jnp.floor(g)
    frac = g - idx
    i0 = jnp.clip(idx.astype(jnp.int32), 0, M - 2)
    y0 = table[i0 * 3 + c]
    y1 = table[(i0 + 1) * 3 + c]
    return y0 * (1.0 - frac) + y1 * frac


def power_from_srgb_linear(rgbl: jnp.ndarray) -> jnp.ndarray:
    """Radiant-power measure of linear-sRGB pixels under the synthetic
    primaries (reference srgb.py:556-565)."""
    from ..ops.xp import get_xp
    xp = get_xp(rgbl)
    rgbl = xp.asarray(rgbl)
    w = xp.asarray(SRGB_PRIMARY_POWER_FACTORS, rgbl.dtype)
    if xp is jnp:
        # precision="highest": keep the f32 product out of TF32 on the GPU
        return jnp.einsum("...c,c->...", rgbl, w, precision="highest")
    return xp.einsum("...c,c->...", rgbl, w)


# ----------------------------------------------------------------------
# spectral colormap

def spectral_colormap(wl) -> jnp.ndarray:
    """sRGBA colormap for wavelengths: physically correct hue, pleasing
    lightness roll-off (reference srgb.py:569-606). Honors a user override
    via ``global_options.spectral_colormap``."""
    if global_options.spectral_colormap is not None:
        return jnp.asarray(global_options.spectral_colormap(wl))

    wl = jnp.asarray(wl)
    xyz = jnp.stack([x_observer(wl), y_observer(wl), z_observer(wl)], axis=-1)

    def _norm_brightness(rgbl):
        mx = jnp.max(rgbl, axis=-1, keepdims=True)
        nz = jnp.any(rgbl != 0, axis=-1, keepdims=True)
        return jnp.where(nz, rgbl / jnp.where(mx != 0, mx, 1.0), rgbl)

    rgb_a = _norm_brightness(xyz_to_srgb_linear(xyz, rendering_intent="Absolute"))
    rgb_p = _norm_brightness(xyz_to_srgb_linear(xyz, rendering_intent="Perceptual"))
    rgb = 0.5 * rgb_a + 0.5 * rgb_p

    fade = 0.25 * (1 - jnp.tanh((wl - 650.0) / 50.0)) * (1 + jnp.tanh((wl - 440.0) / 30.0))
    rgb = srgb_linear_to_srgb(rgb * fade[..., None])
    rgb = jnp.clip(rgb, 0.0, 1.0)
    return jnp.concatenate([rgb, jnp.ones_like(wl)[..., None]], axis=-1)

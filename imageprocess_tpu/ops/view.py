"""Display/view pipeline ops: percentile clip, gamma, invert, pseudocolor,
DoG bandpass, unsharp masking, CLAHE, Sobel edges.

Reference semantics: the interactive drawer's cached filter pipeline
(src/roi_manual_drawer.py:299-314 ``_stretch_u8``, :870-946
``_render_pipeline``/``_update_bg_rgb``): percentile clip -> normalize ->
gamma ``x^(1/g)`` -> optional invert -> LUT; optional band-pass
(difference-of-Gaussians), unsharp (``img + amount*(img - blur)``), CLAHE
(skimage.exposure.equalize_adapthist) and Sobel edge overlay.

All ops are jitted and fuse; Gaussians are separable convolutions.
"""

from __future__ import annotations

from functools import partial
import jax
import jax.numpy as jnp
import numpy as np

from .percentile import masked_quantile


def _gauss_kernel1d(sigma: float, truncate: float = 4.0) -> np.ndarray:
    """scipy.ndimage.gaussian_filter kernel parity (default truncate=4.0)."""
    radius = max(1, int(truncate * float(sigma) + 0.5))
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


@partial(jax.jit, static_argnames=("sigma", "truncate"))
def gaussian_blur(img: jnp.ndarray, sigma: float,
                  truncate: float = 4.0) -> jnp.ndarray:
    """Separable Gaussian with scipy's 'reflect' border (= numpy
    'symmetric': edge pixel duplicated) and truncate=4.0 kernel radius —
    bit-comparable to ndi.gaussian_filter defaults as used by the drawer
    (roi_manual_drawer.py:873-875)."""
    k = jnp.asarray(_gauss_kernel1d(sigma, truncate))
    r = (k.shape[0] - 1) // 2

    def conv1d(x, axis):
        pad = [(0, 0), (0, 0)]
        pad[axis] = (r, r)
        xp = jnp.pad(x, pad, mode="symmetric")
        kk = k.reshape((-1, 1) if axis == 0 else (1, -1))
        # f32 scipy parity: HIGHEST keeps a GPU from running it in TF32
        return jax.lax.conv_general_dilated(
            xp[None, None], kk[None, None], (1, 1), "VALID",
            precision=jax.lax.Precision.HIGHEST,
        )[0, 0]

    return conv1d(conv1d(img, 0), 1)


@partial(jax.jit, static_argnames=("lo_sigma", "hi_sigma"))
def dog_bandpass(img: jnp.ndarray, lo_sigma: float, hi_sigma: float) -> jnp.ndarray:
    """Difference-of-Gaussians band-pass (drawer's bandpass filter)."""
    return gaussian_blur(img, lo_sigma) - gaussian_blur(img, hi_sigma)


@partial(jax.jit, static_argnames=("sigma",))
def unsharp(img: jnp.ndarray, sigma: float, amount: jnp.ndarray) -> jnp.ndarray:
    """img + amount * (img - gaussian(img))."""
    return img + amount * (img - gaussian_blur(img, sigma))


@jax.jit
def sobel_magnitude(img: jnp.ndarray) -> jnp.ndarray:
    """Sobel gradient magnitude with skimage normalization (kernels /4,
    reflect border, hypot/sqrt(2))."""
    kx = jnp.asarray([[1, 0, -1], [2, 0, -2], [1, 0, -1]], jnp.float32) / 4.0
    ky = kx.T
    xp = jnp.pad(img, 1, mode="symmetric")[None, None]
    hi = jax.lax.Precision.HIGHEST   # f32 skimage parity, no TF32 on a GPU
    gx = jax.lax.conv_general_dilated(xp, kx[None, None], (1, 1), "VALID",
                                      precision=hi)[0, 0]
    gy = jax.lax.conv_general_dilated(xp, ky[None, None], (1, 1), "VALID",
                                      precision=hi)[0, 0]
    return jnp.sqrt(gx * gx + gy * gy) / jnp.sqrt(2.0)


@jax.jit
def stretch_view(
    img: jnp.ndarray,
    p_lo1000: jnp.ndarray,
    p_hi1000: jnp.ndarray,
    gamma: jnp.ndarray,
    invert: jnp.ndarray,
) -> jnp.ndarray:
    """Percentile clip -> [0,1] normalize -> gamma -> optional invert
    (roi_manual_drawer.py:299-314).  Returns float32 in [0, 1]."""
    finite = jnp.isfinite(img)
    v = jnp.where(finite, img, jnp.inf)
    lo = masked_quantile(v, finite, p_lo1000)
    hi = masked_quantile(v, finite, p_hi1000)
    # degenerate range: the reference divides by 1e-6 (roi_manual_drawer.py
    # :303-305), mapping anything brighter than lo to 1.0 — expressed as a
    # denominator so float32 can't swallow the tiny offset
    den = jnp.where(hi <= lo, jnp.float32(1e-6), hi - lo)
    x = jnp.clip((img - lo) / den, 0.0, 1.0)
    x = jnp.power(x, 1.0 / jnp.maximum(gamma, 1e-6))
    return jnp.where(invert > 0, 1.0 - x, x)


@partial(jax.jit, static_argnames=("ntiles_y", "ntiles_x", "nbins"))
def clahe(
    img01: jnp.ndarray,
    clip_limit: jnp.ndarray = jnp.float32(0.01),
    ntiles_y: int = 8,
    ntiles_x: int = 8,
    nbins: int = 256,
) -> jnp.ndarray:
    """Contrast-limited adaptive histogram equalization on [0,1] input.

    skimage.exposure.equalize_adapthist-style: per-tile clipped histogram ->
    redistributed CDF -> bilinear interpolation between tile mappings.
    (Functional equivalent; skimage's exact kernel sizing/interp differs in
    minor details.)"""
    H, W = img01.shape
    th = -(-H // ntiles_y)
    tw = -(-W // ntiles_x)
    Hp, Wp = th * ntiles_y, tw * ntiles_x
    # reflect padding rejects pad widths >= the axis length (tiny crops
    # where th*ntiles overshoots several-fold); fall back to edge there
    pad_mode = "reflect" if (Hp - H) < H and (Wp - W) < W else "edge"
    x = jnp.pad(img01, ((0, Hp - H), (0, Wp - W)), mode=pad_mode)

    bins = jnp.clip((x * (nbins - 1)).astype(jnp.int32), 0, nbins - 1)
    tiles_r = jnp.arange(Hp) // th
    tiles_c = jnp.arange(Wp) // tw
    tile_id = tiles_r[:, None] * ntiles_x + tiles_c[None, :]
    flat_bin = tile_id * nbins + bins
    n_tiles = ntiles_y * ntiles_x
    hist = jnp.zeros(n_tiles * nbins, jnp.float32).at[flat_bin.ravel()].add(1.0)
    hist = hist.reshape(n_tiles, nbins)

    npx = jnp.float32(th * tw)
    limit = jnp.maximum(clip_limit * npx, 1.0)
    clipped = jnp.minimum(hist, limit)
    excess = (hist - clipped).sum(axis=1, keepdims=True)
    clipped = clipped + excess / nbins
    cdf = jnp.cumsum(clipped, axis=1)
    cdf = cdf / cdf[:, -1:]

    # bilinear interpolation between the 4 surrounding tile mappings
    cy = (jnp.arange(Hp) - (th - 1) / 2.0) / th
    cx = (jnp.arange(Wp) - (tw - 1) / 2.0) / tw
    y0 = jnp.clip(jnp.floor(cy).astype(jnp.int32), 0, ntiles_y - 1)
    x0 = jnp.clip(jnp.floor(cx).astype(jnp.int32), 0, ntiles_x - 1)
    y1 = jnp.clip(y0 + 1, 0, ntiles_y - 1)
    x1 = jnp.clip(x0 + 1, 0, ntiles_x - 1)
    wy = jnp.clip(cy - y0, 0.0, 1.0)[:, None]
    wx = jnp.clip(cx - x0, 0.0, 1.0)[None, :]

    def lookup(ty, tx):
        tid = ty[:, None] * ntiles_x + tx[None, :]
        return cdf[tid.ravel(), bins.ravel()].reshape(Hp, Wp)

    v00 = lookup(y0, x0)
    v01 = lookup(y0, x1)
    v10 = lookup(y1, x0)
    v11 = lookup(y1, x1)
    out = ((1 - wy) * ((1 - wx) * v00 + wx * v01)
           + wy * ((1 - wx) * v10 + wx * v11))
    return out[:H, :W]


_PSEUDO_LUTS = {}


def apply_pseudocolor(img01: np.ndarray, cmap_name: str) -> np.ndarray:
    """[0,1] grayscale -> RGB via a matplotlib LUT (host; display only)."""
    import matplotlib.pyplot as plt

    if cmap_name not in _PSEUDO_LUTS:
        _PSEUDO_LUTS[cmap_name] = plt.get_cmap(cmap_name)(
            np.linspace(0, 1, 256))[:, :3].astype(np.float32)
    lut = _PSEUDO_LUTS[cmap_name]
    idx = np.clip((np.asarray(img01) * 255).astype(np.int32), 0, 255)
    return lut[idx]

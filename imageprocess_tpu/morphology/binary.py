"""Binary dilation / erosion / closing as XLA convolutions & reduce-windows.

Semantics replicated:

- ``skimage.morphology.disk(r)`` footprint: ``x^2 + y^2 <= r^2``.
- ``skimage.morphology.binary_dilation``: out-of-image treated as False.
- ``skimage.morphology.binary_erosion``: out-of-image treated as **True**
  (skimage passes border_value=1 to ndi so borders don't erode).
- ``skimage.morphology.binary_closing`` = dilation then erosion with those
  border rules — used by the FA segmentation core
  (src/INT/FA_Analyzer.py:152-155).
- ``scipy.ndimage.binary_dilation(base, structure=np.ones((2k+1, 2k+1)))``
  (border False) — the Nesprin2 annulus construction
  (src/FRET/Nesprin2_FRET_Builder.py:416-427), done separably as two
  reduce-window max passes.

Arbitrary (disk) DILATION footprints decompose exactly into shifted
horizontal-run reduce-window maxima (see ``_dilate``); erosion counts
neighbors with a single ``lax.conv``; separable square windows use
``lax.reduce_window``.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def disk(radius: int) -> np.ndarray:
    """skimage.morphology.disk parity (L2 ball, inclusive)."""
    r = int(radius)
    y, x = np.mgrid[-r : r + 1, -r : r + 1]
    return (x * x + y * y) <= r * r


def _conv_count(img_f32: jnp.ndarray, se: jnp.ndarray) -> jnp.ndarray:
    """#True neighbors under the footprint at each pixel (zero-padded).
    The counts must be exact, so the precision is pinned to full f32 and
    a GPU never runs the convolution in TF32."""
    k = jnp.asarray(se, jnp.float32)[None, None]
    x = img_f32[None, None]
    out = jax.lax.conv_general_dilated(
        x, k, window_strides=(1, 1), padding="SAME",
        precision=jax.lax.Precision.HIGHEST,
    )
    return out[0, 0]


@partial(jax.jit, static_argnames=("se_tuple",))
def _dilate(img: jnp.ndarray, se_tuple) -> jnp.ndarray:
    """Dilation as a union of shifted horizontal-run maxima.

    In this module's (un-flipped) CORRELATION convention —
    ``out[x] = OR_{dx in SE} img[x + dx]``, pinned by
    test_dilation_asymmetric_se_keeps_correlation_convention; identical
    to Minkowski dilation for the symmetric disk/square footprints all
    callers use — the result is exactly the union of the input shifted
    by every True offset; grouping each SE row's True runs gives
    ``out = OR_rows vshift(window_max(img, run), dy)``.  One (1, w)
    reduce-window per DISTINCT run extent plus a vertical shift per row
    — plain vector ops, where the single-channel 11x11 ``lax.conv`` it
    replaces fed one channel to a matrix unit; the decomposition is
    bit-exact (same union, border False both ways)."""
    se = np.array(se_tuple, dtype=bool)
    ry, rx = se.shape[0] // 2, se.shape[1] // 2
    # collect per-row runs of True cells, grouped by horizontal extent
    groups: dict = {}
    for i in range(se.shape[0]):
        row = se[i]
        j = 0
        while j < row.size:
            if row[j]:
                k = j
                while k + 1 < row.size and row[k + 1]:
                    k += 1
                groups.setdefault((j - rx, k - rx), []).append(i - ry)
                j = k + 1
            else:
                j += 1
    x = img.astype(jnp.float32)
    H = img.shape[0]
    acc = jnp.zeros_like(x)
    for (lo, hi), dys in groups.items():
        if lo == 0 and hi == 0:
            h = x
        else:
            h = jax.lax.reduce_window(
                x, -jnp.inf, jax.lax.max, (1, hi - lo + 1), (1, 1),
                ((0, 0), (-lo, hi)))
        for dy in dys:
            d = min(abs(dy), H)      # shifts past the image contribute nothing
            if dy == 0:
                v = h
            elif dy > 0:
                v = jnp.concatenate(
                    [h[d:], jnp.zeros((d,) + h.shape[1:], h.dtype)])
            else:
                v = jnp.concatenate(
                    [jnp.zeros((d,) + h.shape[1:], h.dtype), h[:H - d]])
            acc = jnp.maximum(acc, v)
    return acc > 0.5


@partial(jax.jit, static_argnames=("se_tuple", "border_true"))
def _erode(img: jnp.ndarray, se_tuple, border_true: bool) -> jnp.ndarray:
    se = np.array(se_tuple, dtype=bool)
    n = int(se.sum())
    if border_true:
        ry, rx = se.shape[0] // 2, se.shape[1] // 2
        padded = jnp.pad(img, ((ry, ry), (rx, rx)), constant_values=True)
        cnt = _conv_count(padded.astype(jnp.float32), se)
        cnt = cnt[ry : ry + img.shape[0], rx : rx + img.shape[1]]
    else:
        cnt = _conv_count(img.astype(jnp.float32), se)
    return cnt > (n - 0.5)


def _se_key(se: np.ndarray):
    return tuple(map(tuple, np.asarray(se, bool).tolist()))


def binary_dilation(img: jnp.ndarray, se: np.ndarray) -> jnp.ndarray:
    """Binary dilation, out-of-image = False (skimage & scipy default)."""
    return _dilate(img, _se_key(se))


def binary_erosion(
    img: jnp.ndarray, se: np.ndarray, border_true: bool = True
) -> jnp.ndarray:
    """Binary erosion; ``border_true=True`` is skimage's convention
    (border doesn't erode), False is scipy's default."""
    return _erode(img, _se_key(se), border_true)


def binary_closing_skimage(img: jnp.ndarray, se: np.ndarray) -> jnp.ndarray:
    """skimage.morphology.binary_closing parity (dilate border-False, then
    erode border-True)."""
    key = _se_key(se)
    return _erode(_dilate(img, key), key, True)


@partial(jax.jit, static_argnames=("k",))
def square_dilation(img: jnp.ndarray, k: int) -> jnp.ndarray:
    """Dilation with a (2k+1)x(2k+1) all-ones structure, border False —
    scipy.ndimage.binary_dilation(img, np.ones(...)) parity, computed as two
    separable reduce-window max passes."""
    if k <= 0:
        return img.astype(bool)
    x = img.astype(jnp.float32)
    x = jax.lax.reduce_window(
        x, -jnp.inf, jax.lax.max, (2 * k + 1, 1), (1, 1), "SAME"
    )
    x = jax.lax.reduce_window(
        x, -jnp.inf, jax.lax.max, (1, 2 * k + 1), (1, 1), "SAME"
    )
    return x > 0.5


def annulus_mask(base: jnp.ndarray, inner_px: int, outer_px: int) -> jnp.ndarray:
    """Square-dilation annulus around *base*
    (src/FRET/Nesprin2_FRET_Builder.py:416-427): dilate(outer) & ~dilate(inner),
    with the reference's parameter clamping."""
    inner_px = max(1, int(inner_px))
    outer_px = int(outer_px)
    if outer_px <= inner_px:
        outer_px = inner_px + 1
    return square_dilation(base, outer_px) & ~square_dilation(base, inner_px)

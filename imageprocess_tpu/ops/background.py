"""Background estimation & subtraction.

Semantics of src/INT/Fluor_INT.py:461-492 (with ``stride`` subsampling) and
src/FRET/fret_ratio_builder.py:314-336 (stride=1):

- scope: full frame or the ROI-union mask;
- mode "percentile": B = percentile(scoped strided values, p);
- mode "hist-mode": 2048-bin histogram -> CDF -> first bin with
  CDF >= p/100 -> bin-edge midpoint (falls back to the percentile when the
  histogram is empty);
- J = img - B, optionally clipped at 0.

The stride is applied to the scoped value *sequence* (every stride-th masked
pixel in row-major order), matching ``vals[::stride]``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax.numpy as jnp

from .percentile import exact_quantile_pos, masked_quantile, strided_submask

HIST_BINS = 2048
U16_BINS = 65536


def integral_masked_quantile(
    x: jnp.ndarray, mask: jnp.ndarray, p1000: int
) -> jnp.ndarray:
    """Exact np.percentile-linear quantile of x[mask] for INTEGRAL frames
    (u8/u16) via a 65536-bin histogram — no megapixel sort.

    Bitwise-identical to sorting the float32-cast values: both order
    statistics are exact integers and the interpolation formula is the
    same, and the scatter-add + cumsum avoids a megapixel sort."""
    xi = jnp.clip(x.astype(jnp.int32), 0, U16_BINS - 1).ravel()
    hist = jnp.zeros((U16_BINS,), jnp.int32).at[xi].add(
        mask.ravel().astype(jnp.int32)
    )
    n = hist.sum()
    k, g = exact_quantile_pos(n, p1000)
    cdf = jnp.cumsum(hist)
    # value of the j-th order statistic = first bin with cdf > j
    lo = jnp.clip(jnp.searchsorted(cdf, k, side="right"), 0, U16_BINS - 1)
    k1 = jnp.minimum(k + 1, jnp.maximum(n - 1, 0))
    hi = jnp.clip(jnp.searchsorted(cdf, k1, side="right"), 0, U16_BINS - 1)
    val = lo.astype(jnp.float32) + g * (hi - lo).astype(jnp.float32)
    return jnp.where(n > 0, val, jnp.nan)


def histogram_mode_value(x: jnp.ndarray, mask: jnp.ndarray, p1000: int) -> jnp.ndarray:
    """The reference's "hist-mode" background: CDF threshold over a
    2048-bin histogram of the scoped values, returning the midpoint of the
    first bin whose CDF reaches p/100."""
    # finite-only scope: lo/hi already skip NaN (nanmin/nanmax), but a NaN
    # pixel inside the mask would cast to an arbitrary bin index (the
    # int32 cast of NaN) and be counted, biasing the CDF — exclude it from
    # the weights too (the Nesprin2 variant's isfinite filter,
    # Nesprin2_FRET_Builder.py:432-458; u16-sourced frames are unaffected)
    finite = mask & jnp.isfinite(x)
    vals = jnp.where(finite, x, jnp.nan)
    lo = jnp.nanmin(vals)
    hi = jnp.nanmax(vals)
    span = jnp.where(hi > lo, hi - lo, 1.0)
    idx = jnp.clip(
        ((x - lo) / span * HIST_BINS).astype(jnp.int32), 0, HIST_BINS - 1
    )
    hist = jnp.zeros(HIST_BINS, jnp.int32).at[idx.ravel()].add(
        finite.ravel().astype(jnp.int32)
    )
    total = hist.sum()
    cdf = jnp.cumsum(hist).astype(jnp.float32) / jnp.maximum(total, 1).astype(
        jnp.float32
    )
    target = jnp.float32(p1000) / 100000.0
    first = jnp.argmax(cdf >= target)  # searchsorted(cdf, target, 'left')
    none_reaches = cdf[-1] < target
    bin_w = span / HIST_BINS
    mid = lo + (first.astype(jnp.float32) + 0.5) * bin_w
    thr = jnp.where(none_reaches, hi, mid)
    # empty histogram -> percentile fallback (reference behavior);
    # finite-scoped for the same reason as the histogram weights
    fallback = masked_quantile(x, finite, p1000)
    return jnp.where(total > 0, thr, fallback)


def bg_value(
    img: jnp.ndarray,
    p1000: int,
    scope_mask: Optional[jnp.ndarray] = None,
    mode: str = "percentile",
    stride: int = 4,
) -> jnp.ndarray:
    """Scalar background level of one 2-D frame."""
    if mode not in ("percentile", "hist-mode"):
        return jnp.float32(0.0)
    if scope_mask is None:
        # full-frame scope: the strided subsample img.ravel()[::stride] has
        # a STATIC shape, so slice it out up front — the downstream sort or
        # histogram shrinks by the stride factor (4x at GUI defaults)
        # instead of masking the full frame.
        sub = img.ravel()[::stride] if stride > 1 else img.ravel()
        sub2 = sub[None, :]  # the helpers expect >=1-D x & mask pairs
        eff = jnp.ones(sub2.shape, bool)
        if mode == "percentile":
            if img.dtype in (jnp.uint8, jnp.uint16):
                # 16-step value-range bisection: exact order stats with no
                # sort and no 65536-bin scatter (ops.tilestats_u16); only
                # u8/u16 — wider integer types would clip at 65535
                from .tilestats_u16 import bisect_masked_quantile

                b = bisect_masked_quantile(
                    jnp.clip(sub2.astype(jnp.int32), 0, U16_BINS - 1),
                    eff, jnp.full((1,), sub.size, jnp.int32), p1000,
                )[0]
            else:
                from .percentile import quantile_from_sorted

                b = quantile_from_sorted(
                    jnp.sort(sub.astype(jnp.float32)), sub.size, p1000
                )
        else:
            b = histogram_mode_value(sub2.astype(jnp.float32), eff, p1000)
        return b.astype(jnp.float32)
    eff = strided_submask(scope_mask.astype(bool), stride)
    if mode == "percentile":
        if img.dtype in (jnp.uint8, jnp.uint16):
            b = integral_masked_quantile(img, eff, p1000)
        else:
            b = masked_quantile(img.astype(jnp.float32), eff, p1000)
    else:
        # hist-mode bins in float32 (reference arithmetic); cast integral
        # frames first so the binning matches the f32 path bit-for-bit
        b = histogram_mode_value(img.astype(jnp.float32), eff, p1000)
    # empty scope -> 0.0 (reference: bg_value returns 0.0 for no values)
    return jnp.where(eff.sum() > 0, b, 0.0).astype(jnp.float32)


def bg_correct(
    img: jnp.ndarray,
    p1000: int,
    scope_mask: Optional[jnp.ndarray] = None,
    mode: str = "percentile",
    stride: int = 4,
    clip_neg: bool = True,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(corrected image, background scalar)."""
    b = bg_value(img, p1000, scope_mask, mode, stride)
    out = img - b
    if clip_neg:
        out = jnp.maximum(out, 0.0)
    return out, b

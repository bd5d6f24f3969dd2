"""Sort-free exact per-ROI statistics for u16 tiles (XLA bisection).

The tile-stats quantiles were the last megasort in the production batched
path: (B, N, C) independent sorts of t^2 elements each.  For RAW u16 tile
values the three quantiles only need six exact order statistics, and an
order statistic over a 16-bit domain is a 16-step bisection on the VALUE
RANGE — each step one masked compare+count, vectorized across ALL
(B, N, C, quantile) lanes at once.  Total work: 16 full-width passes over
the tile batch instead of O(log t^2) sorting networks per (B, N, C).

Background subtraction (x - bg, optional clip at 0) is monotone
nondecreasing in x, so the order statistics of the transformed values are
the transforms of the raw-u16 order statistics; interpolation happens
after the transform, exactly like sorting the transformed values
(ops.stats.masked_stats semantics, src/INT/Fluor_INT.py:494-538).
"""

from __future__ import annotations

from functools import partial
from typing import Dict

import jax
import jax.numpy as jnp

from .percentile import exact_quantile_pos

U16_MAX = 65535


def _order_stats_bisect(xi: jnp.ndarray, mask: jnp.ndarray,
                        ks: jnp.ndarray) -> jnp.ndarray:
    """Exact order statistics of masked u16 values by value-range bisection.

    xi:   (..., P) int32 in [0, 65535]
    mask: (..., P) bool
    ks:   (..., Q) int32 0-indexed order-statistic positions (clipped by
          the caller to [0, n-1])
    returns (..., Q) int32: the (k+1)-th smallest masked value per lane
    (undefined where n == 0 — caller guards).
    """
    lo = jnp.zeros(ks.shape, jnp.int32)
    hi = jnp.full(ks.shape, U16_MAX, jnp.int32)

    def body(_, lohi):
        lo, hi = lohi
        mid = (lo + hi) >> 1                                  # (..., Q)
        # count of masked values <= mid, per (lane, quantile)
        le = mask[..., None, :] & (xi[..., None, :] <= mid[..., :, None])
        cnt = le.sum(axis=-1).astype(jnp.int32)               # (..., Q)
        ge = cnt >= ks + 1
        return jnp.where(ge, lo, mid + 1), jnp.where(ge, mid, hi)

    lo, hi = jax.lax.fori_loop(0, 16, body, (lo, hi))
    return hi


def bisect_masked_quantile(xi: jnp.ndarray, mask: jnp.ndarray, n,
                           p1000: int) -> jnp.ndarray:
    """np.percentile-linear quantile of masked integral values via the
    16-step value-range bisection — the scalar-quantile companion to
    :func:`tile_stats_u16` (no sort, no 65536-bin scatter).

    xi: (..., P) int32 in [0, 65535]; mask: (..., P) bool; n: (...) int32
    valid counts (broadcast-compatible with xi's batch dims).  Returns
    (...) float32; undefined where n == 0 — callers guard.  Bisect raw
    values, THEN transform order stats, THEN interpolate stays exact for
    monotone transforms (module docstring)."""
    k, g = exact_quantile_pos(n, p1000)
    nm1 = jnp.maximum(n - 1, 0)
    ks = jnp.stack([jnp.clip(k, 0, nm1),
                    jnp.clip(jnp.minimum(k + 1, nm1), 0, nm1)], axis=-1)
    os2 = _order_stats_bisect(xi, mask, ks).astype(jnp.float32)
    return os2[..., 0] + g * (os2[..., 1] - os2[..., 0])


@partial(jax.jit, static_argnames=("clip_neg", "p_lo1000", "p_hi1000"))
def tile_stats_u16(
    tiles: jnp.ndarray,     # (N, C, t, t) uint16 RAW tile pixels
    masks: jnp.ndarray,     # (N, t, t) bool (validity applied)
    bgs: jnp.ndarray,       # (C,) float32 background levels
    *,
    clip_neg: bool = True,
    p_lo1000: int = 5000,
    p_hi1000: int = 95000,
) -> Dict[str, jnp.ndarray]:
    """All nine reference statistics of clip(x - bg)[mask] per (C, N),
    numerically identical to masked_stats on the transformed tile."""
    N, C, t, _ = tiles.shape
    xf = tiles.astype(jnp.float32) - bgs[None, :, None, None]
    if clip_neg:
        xf = jnp.maximum(xf, 0.0)
    m = masks[:, None, :, :]                                  # (N, 1, t, t)
    n = masks.sum(axis=(-2, -1)).astype(jnp.int32)            # (N,)
    n_nc = jnp.broadcast_to(n[:, None], (N, C))
    nf = jnp.maximum(n_nc.astype(jnp.float32), 1.0)

    total = jnp.where(m, xf, 0.0).sum(axis=(-2, -1))          # (N, C)
    mean = total / nf
    var = jnp.where(m, (xf - mean[..., None, None]) ** 2, 0.0).sum(
        axis=(-2, -1)) / nf
    vmin = jnp.where(m, xf, jnp.inf).min(axis=(-2, -1))
    vmax = jnp.where(m, xf, -jnp.inf).max(axis=(-2, -1))

    # six order-stat positions (p_lo, median, p_hi) x (k, k+1) per lane
    kgs = [exact_quantile_pos(n_nc, p) for p in (p_lo1000, 50000, p_hi1000)]
    nm1 = jnp.maximum(n_nc - 1, 0)
    ks = jnp.stack(
        [jnp.clip(k, 0, nm1) for k, _ in kgs]
        + [jnp.clip(jnp.minimum(k + 1, nm1), 0, nm1) for k, _ in kgs],
        axis=-1,
    )                                                          # (N, C, 6)
    xi = tiles.astype(jnp.int32).reshape(N, C, t * t)
    mflat = jnp.broadcast_to(masks[:, None], (N, C, t, t)).reshape(N, C, -1)
    os6 = _order_stats_bisect(xi, mflat, ks)                   # (N, C, 6)

    # transform raw order stats, then interpolate (same as sorting the
    # transformed values: the transform is monotone nondecreasing)
    osf = os6.astype(jnp.float32) - bgs[None, :, None]
    if clip_neg:
        osf = jnp.maximum(osf, 0.0)

    def interp(j, g):
        lo_v, hi_v = osf[..., j], osf[..., j + 3]
        return lo_v + g * (hi_v - lo_v)

    p5 = interp(0, kgs[0][1])
    median = interp(1, kgs[1][1])
    p95 = interp(2, kgs[2][1])

    empty = n_nc == 0
    nanify = lambda v: jnp.where(empty, jnp.nan, v).T          # -> (C, N)
    return {
        "mean": nanify(mean),
        "median": nanify(median),
        "std": nanify(jnp.sqrt(var)),
        "p5": nanify(p5),
        "p95": nanify(p95),
        "vmin": nanify(vmin),
        "vmax": nanify(vmax),
        "vsum": nanify(total),
        "npx": jnp.where(empty, 0, n_nc).T.astype(jnp.int32),
    }

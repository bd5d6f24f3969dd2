"""Exact masked quantiles on device.

``np.percentile`` (method="linear") semantics: for n valid values, the
quantile sits at position ``h = (n-1) * p / 100``; the result interpolates
the order statistics at ``floor(h)`` and ``ceil(h)``.

On the device we run in float32, where computing ``h`` directly is inexact for
megapixel ``n`` (rel error ~1e-7 of h ≈ O(1) absolute!), which can shift the
chosen order statistic.  ``exact_quantile_pos`` instead computes
``k = floor(h)`` and the fractional weight *exactly* in int32 arithmetic for
any percentile with <= 3 decimal places (all GUI-exposed values) and ANY
int32 ``n`` (every intermediate provably < 2^31 — see the derivation in the
function docstring), so gigapixel sharded frames are safe too.

Reference semantics being replicated: np.percentile calls inside
src/INT/Fluor_INT.py:461-548, src/FRET/fret_ratio_builder.py:314-362.
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp


def p1000_of(p: float) -> int:
    """Host-side: encode a percentile as integer thousandths."""
    return int(round(float(p) * 1000))


def exact_quantile_pos(n, p1000) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(k, g) with k = floor((n-1)*p1000/100000) and g the exact fractional
    remainder in [0, 1), all in int32-safe arithmetic for ANY int32 n
    (p1000 <= 100000, i.e. percentiles <= 100; broadcasts over array
    p1000, e.g. a per-lane column).

    Derivation: write n-1 = q*100000 + r and r = r1*1000 + r0.  Then
    (n-1)*p1000 = q*p1000*100000 + r*p1000 with
    r*p1000 = C*1000 + (B % 1000), B = r0*p1000 and C = r1*p1000 + B//1000,
    so k = q*p1000 + C//100 and remainder = (C % 100)*1000 + B % 1000
    (provably < 100000).  Every intermediate fits int32:
    B <= 999*1e5 ~ 1e8, C <= 99*1e5 + 1e5 ~ 1e7,
    q*p1000 <= 21474*1e5 < 2^31, and k <= n-1 < 2^31.
    """
    nm1 = jnp.maximum(n - 1, 0).astype(jnp.int32)
    q = nm1 // 100000
    r = nm1 % 100000
    r1 = r // 1000
    r0 = r % 1000
    b = r0 * p1000
    c = r1 * p1000 + b // 1000
    k = q * p1000 + c // 100
    rem = (c % 100) * 1000 + b % 1000
    g = rem.astype(jnp.float32) / 100000.0
    return k, g


def quantile_from_sorted(xs: jnp.ndarray, n, p1000: int) -> jnp.ndarray:
    """Linear-interpolated quantile of the first *n* entries of ascending
    *xs* (invalid entries sorted to the end).  Returns NaN for n == 0."""
    k, g = exact_quantile_pos(n, p1000)
    k = jnp.clip(k, 0, xs.shape[0] - 1)
    k1 = jnp.clip(k + 1, 0, xs.shape[0] - 1)
    k1 = jnp.where(k + 1 <= n - 1, k1, k)  # don't read past the valid range
    lo = xs[k]
    hi = xs[k1]
    val = lo + g * (hi - lo)
    return jnp.where(n > 0, val, jnp.nan)


def masked_quantile(x: jnp.ndarray, mask: jnp.ndarray, p1000: int) -> jnp.ndarray:
    """Quantile of x[mask] (flattened row-major), NaN-free inputs assumed."""
    flat = jnp.where(mask, x, jnp.inf).ravel()
    xs = jnp.sort(flat)
    n = mask.sum().astype(jnp.int32)
    return quantile_from_sorted(xs, n, p1000)


def strided_submask(mask: jnp.ndarray, stride: int) -> jnp.ndarray:
    """Select every *stride*-th True pixel in row-major order.

    Replicates the reference's ``vals[::stride]`` *after* mask scoping
    (Fluor_INT.py:468-471) without gathering a ragged array: the i-th True
    pixel survives iff i % stride == 0."""
    if stride <= 1:
        return mask
    flat = mask.ravel()
    order = jnp.cumsum(flat.astype(jnp.int32)) - 1
    sel = flat & (order % stride == 0)
    return sel.reshape(mask.shape)

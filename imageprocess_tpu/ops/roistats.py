"""ROI-local (tiled) per-ROI statistics.

The naive per-ROI stats path sorts the FULL frame once per (ROI, channel) —
O(N*C*H*W log HW) — although each ROI only covers its bounding box.  Here
every ROI is processed in a fixed-size tile dynamically sliced around its
bbox: rasterization, masking and the stats sorts all shrink from the frame
(3.1 Mpx) to the tile (e.g. 256^2 = 65 Kpx), a 30-50x cut in both FLOPs and
HBM traffic.  Tile size is a static power-of-two bucket chosen on host, so
jit recompiles are bounded.

Numerically identical to the full-frame path: the polygon rasterizer is
shift-exact (integer tile offsets on the half-integer vertex lattice), and
each tile fully covers its polygon's image-clipped bbox (host guarantees).
"""

from __future__ import annotations

from functools import partial
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..geom.rasterize import rasterize_polygons
from .stats import masked_stats


def choose_tile(
    polys, H: int, W: int, min_tile: int = 32, margin: int = 0
) -> Optional[int]:
    """Smallest multiple-of-16 tile covering every polygon's image-clipped
    bbox grown by *margin* (with a 1px guard), or None if some ROI needs
    the full frame.  *margin* accommodates neighborhood ops (annulus
    dilations) that must see pixels around the polygon.

    16-step buckets (not powers of two): tile bytes are what cross the
    host->device link on the minimum-transfer path, and pow-2 rounding
    wastes up to 4x of that wire time (golden cells need 65 px; 80 px
    buckets carry 2.6x fewer bytes than the old 128 floor).  Recompiles
    stay bounded — ROI sizes are homogeneous within an experiment and the
    persistent compilation cache absorbs cross-run variety."""
    need = min_tile
    for p in polys:
        p = np.asarray(p)
        x0 = max(0.0, np.floor(p[:, 0].min()) - margin)
        x1 = min(float(W), np.ceil(p[:, 0].max()) + 1 + margin)
        y0 = max(0.0, np.floor(p[:, 1].min()) - margin)
        y1 = min(float(H), np.ceil(p[:, 1].max()) + 1 + margin)
        need = max(need, int(x1 - x0) + 2, int(y1 - y0) + 2)
    if need > min(H, W):
        return None
    tile = ((need + 15) // 16) * 16
    # bucket rounding may overshoot a small frame even though the bbox
    # fits: clamp to the frame (still >= need, so coverage holds)
    return min(tile, min(H, W))


def tile_offsets(polys, H: int, W: int, tile: int, margin: int = 0) -> np.ndarray:
    """(N, 2) int32 [row, col] tile origins placing each margin-grown bbox
    inside its tile, clamped to the image."""
    offs = np.zeros((len(polys), 2), np.int32)
    for i, p in enumerate(polys):
        p = np.asarray(p)
        y0 = int(max(0, np.floor(p[:, 1].min()) - margin))
        x0 = int(max(0, np.floor(p[:, 0].min()) - margin))
        offs[i, 0] = min(max(y0, 0), max(H - tile, 0))
        offs[i, 1] = min(max(x0, 0), max(W - tile, 0))
    return offs


def pad_local_polys(polys, offsets: np.ndarray, n_bucket: int, v_bucket: int):
    """Shift polygons into tile-local [x, y] coords and pad to
    (n_bucket, v_bucket, 2) float32 + validity flags."""
    from ..geom.polygon import pad_polygons

    pv = np.zeros((n_bucket, v_bucket, 2), np.float32)
    valid = np.zeros(n_bucket, bool)
    if len(polys):
        # one pad_polygons call for the whole batch (a per-polygon loop of
        # single-element calls was ~30 ms/chunk of pack wall on the 1-core
        # host); offsets are [row, col] -> subtract as [x, y]
        shift = np.asarray(offsets[: len(polys), ::-1], np.float32)
        pv[: len(polys)] = pad_polygons(
            [np.asarray(p, np.float32) - shift[i]
             for i, p in enumerate(polys)], v_bucket)
        valid[: len(polys)] = True
    offs_pad = np.zeros((n_bucket, 2), np.int32)
    offs_pad[: len(polys)] = offsets
    return pv, offs_pad, valid


@partial(jax.jit, static_argnames=("tile",))
def roi_stats_tiled(
    imgs: jnp.ndarray,         # (C, H, W) float32 (already bg-corrected)
    local_polys: jnp.ndarray,  # (N, V, 2) float32, tile-local coords
    offsets: jnp.ndarray,      # (N, 2) int32 [row, col]
    roi_valid: jnp.ndarray,    # (N,) bool
    tile: int,
) -> Tuple[Dict[str, jnp.ndarray], jnp.ndarray]:
    """Per-(channel, ROI) stats + per-ROI pixel areas, computed on tiles.

    Returns (stats dict of (C, N) arrays, area_px (N,) int32).
    """
    C = imgs.shape[0]
    masks = rasterize_polygons(local_polys, (tile, tile)) & roi_valid[:, None, None]

    def per_roi(mask_i, off):
        t = jax.lax.dynamic_slice(imgs, (0, off[0], off[1]), (C, tile, tile))
        return jax.vmap(lambda im: masked_stats(im, mask_i))(t)

    stats = jax.vmap(per_roi)(masks, offsets)              # dict of (N, C)
    stats = {k: v.T for k, v in stats.items()}             # -> (C, N)
    area = masks.sum(axis=(1, 2)).astype(jnp.int32)
    return stats, area


@partial(jax.jit, static_argnames=("clip_neg",))
def tile_stats_from_gathered(
    tiles: jnp.ndarray,        # (N, C, t, t) RAW (uncorrected) tile pixels
    local_polys: jnp.ndarray,  # (N, V, 2) float32, tile-local coords
    roi_valid: jnp.ndarray,    # (N,) bool
    bgs: jnp.ndarray,          # (C,) float32 background levels
    *,
    clip_neg: bool = True,
) -> Tuple[Dict[str, jnp.ndarray], jnp.ndarray]:
    """Per-(channel, ROI) stats on HOST-gathered tiles with a host-computed
    background — the minimum-transfer production path.

    Instead of shipping full frames to the device just to subtract one
    scalar and read back per-ROI stats, the host sends only each ROI's
    tile (~10x fewer bytes at golden shapes) plus the per-channel
    background (exact u16 percentile, native counting pass).  Numerically
    identical to bg-correcting the full frame and slicing: subtraction is
    elementwise.  Returns (stats dict of (C, N), area_px (N,) int32).
    """
    t = tiles.shape[-1]
    masks = rasterize_polygons(local_polys, (t, t)) & roi_valid[:, None, None]
    area = masks.sum(axis=(1, 2)).astype(jnp.int32)
    if tiles.dtype == jnp.uint16:
        # sort-free exact quantiles by 16-step value-range bisection
        from .tilestats_u16 import tile_stats_u16

        return tile_stats_u16(tiles, masks, bgs, clip_neg=clip_neg), area
    x = tiles.astype(jnp.float32) - bgs[None, :, None, None]
    if clip_neg:
        x = jnp.maximum(x, 0.0)

    def per_roi(mask_i, tc):  # tc: (C, t, t)
        return jax.vmap(lambda im: masked_stats(im, mask_i))(tc)

    stats = jax.vmap(per_roi)(masks, x)                    # dict of (N, C)
    stats = {k: v.T for k, v in stats.items()}             # -> (C, N)
    return stats, area


def gather_tiles(imgs: np.ndarray, offsets: np.ndarray, n_bucket: int,
                 tile: int) -> np.ndarray:
    """Host-side tile gather: (N_valid tiles of (C, tile, tile)) padded to
    (n_bucket, C, tile, tile), dtype preserved (compact u16 upload)."""
    C = imgs.shape[0]
    out = np.zeros((n_bucket, C, tile, tile), imgs.dtype)
    for i, (oy, ox) in enumerate(np.asarray(offsets, np.int64)):
        out[i] = imgs[:, oy:oy + tile, ox:ox + tile]
    return out

"""Learned full-frame cell segmentation: tiled U-Net inference.

The Cellpose-replacement inference path, ONE fused jitted device program
per frame geometry: normalize (1-99 percentile stretch like Cellpose),
cut into overlapping tiles sized for the network, run the forward pass
over the tile batch, recompose with feathered overlap, threshold, and
instance-separate by FLOW FOLLOWING (segment.flows — the network's
trained center-pointing flow head, integrated on device by
scaling-and-squaring, splits touching cells exactly like Cellpose's
follow_flows; the device CCL remains as the ``flow_follow=False``
fallback).  Only the raw frame goes up and the final int32 label map
comes back — no tile stacks or probability maps cross the host link
(the unfused path moved ~90 MB/frame between host and device; this moves
~19 MB).  Polygons come out via the same cv2 external-contour conversion
as the reference (src/ROI_auto_drawer.py:298-310).

Several devices segment several frames at once, each frame with this
same single-device program (``device=``; segment.auto.run_auto_drawer),
so a frame's polygons do not depend on the device count.

Two structural cuts:

* **Host-histogram stretch** — integer-valued frames (every TIFF channel)
  get their 1/99-percentile stretch bounds from a host ``np.bincount`` +
  the canonical (k, g) order-statistic arithmetic
  (``native.percentile_from_hist``) instead of a megapixel device sort.
  Same np.percentile(method="linear")
  semantics; float frames keep the exact device-sort path.
* **Foreground tile culling** — background-only tiles (stretched max
  <= ``cull_margin``) skip the U-Net forward; their network response is
  substituted by the response to an all-zero tile (one extra batch row),
  so the feathered recomposition runs over the full static tile grid
  unchanged.  The reference's Cellpose runs its network over every tile
  of every frame (ROI_auto_drawer.py:192-203); culling is quality-gated
  by tests/test_unet_golden.py + tests/test_unet_general.py.
"""

from __future__ import annotations

from functools import partial
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..morphology.ccl import label, remove_small_objects
from ..morphology.contours import masks_to_polygons
from ..ops.view import stretch_view


@partial(jax.jit, static_argnames=(
    "apply_fn", "ys", "xs", "tile", "pad_h", "pad_w", "prob_threshold",
    "min_size_px", "max_labels", "flow_follow", "host_stretch", "n_keep",
))
def _seg_fused(
    apply_fn,
    params,
    img: jnp.ndarray,           # (H, W) raw frame — u16 when
                                #   host_stretch (cast on device), else f32
    lo: jnp.ndarray,            # f32 stretch bounds (host path; dummy 0s
    hi: jnp.ndarray,            #   when host_stretch=False)
    keep_idx: jnp.ndarray,      # (n_keep,) i32 kept-tile ids, sentinel=T
    *,
    ys: tuple,
    xs: tuple,
    tile: int,
    pad_h: int,
    pad_w: int,
    prob_threshold: float,
    min_size_px: int,
    max_labels: int,
    flow_follow: bool,
    host_stretch: bool,
    n_keep: int,                # 0 => forward every tile (no culling)
):
    """Frame -> (instance labels, overflow flag), entirely on device."""
    if host_stretch:
        # lo/hi computed host-side from the u16 histogram — elementwise
        # only; degenerate-range denominator matches ops.view.stretch_view.
        # The frame arrives as raw u16 (halves the 12.6 MB frame upload,
        # the program's only host->device transfer); u16->f32 is exact
        den = jnp.where(hi <= lo, jnp.float32(1e-6), hi - lo)
        x = jnp.clip((img.astype(jnp.float32) - lo) / den, 0.0, 1.0)
    else:
        x = stretch_view(img, jnp.int32(1000), jnp.int32(99000),
                         jnp.float32(1.0), jnp.int32(0))
    if pad_h or pad_w:
        x = jnp.pad(x, ((0, pad_h), (0, pad_w)), mode="reflect")
    tiles = jnp.stack([
        x[y:y + tile, x0:x0 + tile] for y in ys for x0 in xs
    ])[..., None]
    T = tiles.shape[0]

    cull = bool(n_keep) and n_keep < T
    if cull:
        # forward ONLY the kept tiles plus one all-zero tile whose response
        # stands in for every culled (background-only) tile; per-tile math
        # is batch-independent, so kept tiles' outputs are identical to the
        # full-batch program's
        fwd_in = jnp.concatenate([
            tiles[jnp.clip(keep_idx, 0, T - 1)],
            jnp.zeros((1, tile, tile, 1), tiles.dtype),
        ])
    else:
        fwd_in = tiles
    out = apply_fn(params, fwd_in)
    if cull:
        zero_resp = out[n_keep]
        full_out = jnp.broadcast_to(zero_resp[None], (T,) + zero_resp.shape)
        # sentinel entries (keep_idx == T) fall out of range and drop
        out = full_out.at[keep_idx].set(out[:n_keep], mode="drop")
    prob = jax.nn.sigmoid(out[..., 0])
    n_ch = out.shape[-1]

    # feathered recomposition: the probability map AND (when present) the
    # two flow channels blend with the same per-tile weights
    wy = jnp.minimum(jnp.arange(tile) + 1, jnp.arange(tile)[::-1] + 1)
    wtile = jnp.minimum(wy[:, None], wy[None, :]).astype(jnp.float32)
    H, W = img.shape
    acc = jnp.zeros((H + pad_h, W + pad_w, max(1, n_ch)), jnp.float32)
    wacc = jnp.zeros((H + pad_h, W + pad_w), jnp.float32)
    blend = jnp.concatenate([prob[..., None], out[..., 1:]], -1) \
        * wtile[None, :, :, None]
    k = 0
    for y in ys:
        for x0 in xs:
            acc = acc.at[y:y + tile, x0:x0 + tile, :].add(blend[k])
            wacc = wacc.at[y:y + tile, x0:x0 + tile].add(wtile)
            k += 1
    full = acc / jnp.maximum(wacc, 1e-6)[..., None]
    prob_full = full[:H, :W, 0]

    bw = prob_full > prob_threshold
    if min_size_px > 0:
        bw = remove_small_objects(bw, min_size_px, connectivity=1)
    if flow_follow and n_ch >= 3:
        from .flows import flow_label

        lab, over = flow_label(bw, full[:H, :W, 1:3], max_labels=max_labels,
                               with_overflow=True)
    else:
        lab, over = label(bw, connectivity=2, max_labels=max_labels,
                          with_overflow=True)
    if max_labels <= 0xFFFF:
        # the label map is the ONLY device->host transfer of the fused
        # program — u16 halves the 12.6 MB fetch (ids <= max_labels)
        lab = lab.astype(jnp.uint16)
    return lab, over


def _host_stretch_lohi(
    img: np.ndarray,
) -> Optional[Tuple[float, float, np.ndarray]]:
    """(lo, hi, u16_frame): 1/99-percentile stretch bounds from a host u16
    histogram plus the validated uint16 view of the frame (reused for the
    compact upload and the cull prepass — one conversion pass, not three),
    or None when the frame isn't u16-valued (the device sort path then
    keeps exact generality).  Same (k, g) order-statistic arithmetic as
    the device op (``native.percentile_from_hist`` — the CLAUDE.md
    invariant), so integral frames get np.percentile-linear-exact bounds
    without the megapixel device sort."""
    if img.dtype == np.uint16:
        iv = img
    else:
        if not np.isfinite(img).all():
            return None
        iv = img.astype(np.uint16)
        if not np.array_equal(iv.astype(img.dtype, copy=False), img):
            return None
    from ..native import percentile_from_hist, u16_hist

    hist = u16_hist(iv)  # native counting pass (np.bincount fallback)
    return (percentile_from_hist(hist, 1000),
            percentile_from_hist(hist, 99000), iv)


def tile_grid(H: int, W: int, tile: int, overlap: int):
    """(ys, xs) tile origins covering an H x W frame with *tile*-px tiles
    overlapping by 2 * *overlap* (the last row/column flush with the
    frame edge).  Overlaps of half a tile or more shrink to a quarter
    tile, so the stride stays positive."""
    if 2 * overlap >= tile:
        # small checkpoints (config.json tile=64 with the default
        # overlap=32) would give stride<=0: range() then crashes or,
        # worse, covers only corner tiles and interior cells vanish
        overlap = tile // 4
    stride = tile - 2 * overlap
    ys = list(range(0, max(H - tile, 0) + 1, stride)) or [0]
    xs = list(range(0, max(W - tile, 0) + 1, stride)) or [0]
    if ys[-1] + tile < H:
        ys.append(H - tile)
    if xs[-1] + tile < W:
        xs.append(W - tile)
    return ys, xs


def segment_frame_labels(
    img: np.ndarray,
    apply_fn,
    params,
    tile: int = 256,
    overlap: int = 32,
    prob_threshold: float = 0.5,
    min_size_px: int = 100,
    max_labels: int = 1024,
    flow_follow: bool = True,
    cull_margin: float = 0.05,
    device=None,
):
    """Full frame -> (device instance-label map, device overflow flag), or
    None when culling finds nothing above background.  The program is
    dispatched and not waited for, so the caller can start the next frame
    (on another device) first.  ``device``: run on this device instead of
    the default one; *params* must already be there.  Other arguments as
    for :func:`segment_frame_unet`."""
    H, W = img.shape
    ys, xs = tile_grid(H, W, tile, overlap)

    img_np = np.asarray(img)
    lohi = _host_stretch_lohi(img_np)
    u16_frame = None
    if lohi is not None:
        lo_f, hi_f, u16_frame = lohi
    n_keep = 0
    keep_idx = np.zeros(1, np.int32)
    T = len(ys) * len(xs)
    if lohi is not None and cull_margin > 0 and T > 1:
        den = 1e-6 if hi_f <= lo_f else hi_f - lo_f
        thr = lo_f + float(cull_margin) * den
        tmax = np.array([u16_frame[y:y + tile, x0:x0 + tile].max()
                         for y in ys for x0 in xs], np.float64)
        keep = np.flatnonzero(tmax > thr)
        if keep.size == 0:
            return None        # nothing above background anywhere
        # bucket the batch size (multiples of 16) so recompiles are rare
        b = min(T, -(-int(keep.size) // 16) * 16)
        if b < T:
            n_keep = b
            keep_idx = np.full(b, T, np.int32)   # sentinel = dropped
            keep_idx[:keep.size] = keep

    # u16-valued frames ship raw u16 (half the bytes) and cast to f32 on
    # device — exact; float frames keep the f32 upload
    frame = u16_frame if lohi is not None else np.asarray(img_np, np.float32)
    lo, hi = (lo_f, hi_f) if lohi is not None else (0.0, 0.0)
    args = jax.device_put(
        (frame, np.float32(lo), np.float32(hi), keep_idx), device)
    return _seg_fused(
        apply_fn, params, *args,
        ys=tuple(ys), xs=tuple(xs), tile=tile,
        pad_h=max(0, tile - H), pad_w=max(0, tile - W),
        prob_threshold=float(prob_threshold), min_size_px=int(min_size_px),
        max_labels=int(max_labels), flow_follow=bool(flow_follow),
        host_stretch=lohi is not None, n_keep=n_keep,
    )


def labels_to_polygons(out, max_labels: int = 1024,
                       min_poly_area: float = 20.0) -> List[np.ndarray]:
    """:func:`segment_frame_labels`' result -> instance polygons (waits
    for the device)."""
    if out is None:
        return []
    labels, over = out
    if bool(over):
        raise ValueError(
            f"component count exceeded max_labels={max_labels} — downstream "
            "per-label buffers are sized by it; raise AutoSegConfig.max_labels")
    return masks_to_polygons(np.asarray(labels), min_poly_area)


def segment_frame_unet(
    img: np.ndarray,
    apply_fn,
    params,
    tile: int = 256,
    overlap: int = 32,
    prob_threshold: float = 0.5,
    min_size_px: int = 100,
    max_labels: int = 1024,
    min_poly_area: float = 20.0,
    flow_follow: bool = True,
    cull_margin: float = 0.05,
    device=None,
) -> List[np.ndarray]:
    """Full frame -> instance polygons via tiled U-Net inference.

    ``cull_margin``: tiles whose stretched max is <= this skip the U-Net
    forward (their response is the network's all-zero-tile response); 0
    disables culling.  Only active on u16-valued frames (where the stretch
    bounds are host-computed).

    ``device``: as for :func:`segment_frame_labels`."""
    out = segment_frame_labels(
        img, apply_fn, params, tile=tile, overlap=overlap,
        prob_threshold=prob_threshold, min_size_px=min_size_px,
        max_labels=max_labels, flow_follow=flow_follow,
        cull_margin=cull_margin, device=device)
    return labels_to_polygons(out, max_labels, min_poly_area)

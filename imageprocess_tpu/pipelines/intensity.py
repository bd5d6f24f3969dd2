"""Per-ROI fluorescence intensity pipeline (the reference's Fluor_INT).

Reference semantics: src/INT/Fluor_INT.py — worker ``_process_key_task``
(:795-1143), quantification ``quantify_per_roi_multi`` (:509-538), background
``bg_correct`` (:461-492), report ``save_excel`` (:728-791).

Device design: the entire numeric path for one (stage, time) key —
polygon rasterization, background percentile, correction, nine masked
statistics per (channel, ROI) — is ONE jit-compiled XLA program with static
shapes.  ROIs are padded to a bucket size and vmapped; channels are a leading
batch axis.  The host does TIFF decode, ROI JSON parsing and report writing.

The per-image program is wrapped by ``shard_map`` over a 1-D device mesh in
``parallel.runner`` so a whole experiment batches across devices (the
equivalent of the reference's ProcessPoolExecutor, SURVEY §2.3).
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field
from functools import partial
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core import naming, roiio, tiffio
from ..core.i18n import t
from ..core.naming import ChannelGrammar
from ..geom.polygon import pad_polygons
from ..geom.rasterize import rasterize_polygons
from ..ops.background import bg_value
from ..ops.percentile import p1000_of
from ..ops.stats import STAT_FIELDS, masked_stats


# --------------------------------------------------------------------------
# configuration (defaults = the reference GUI defaults, Fluor_INT.py:2034-2090)
# --------------------------------------------------------------------------

@dataclass
class IntensityConfig:
    channels: Tuple[int, ...] = (1,)          # chs_to_quant
    timelapse: bool = False
    bg_mode: str = "percentile"               # "percentile" | "hist-mode" | "none"
    bg_scope: str = "full"                    # "full" | "roi_union"
    percentile: float = 1.0
    per_channel_p: Dict[int, float] = field(default_factory=dict)
    clip_neg: bool = True
    bg_stride: int = 4
    skip_no_roi: bool = True
    channel_colors: Dict[int, str] = field(default_factory=dict)
    # subset extraction (Fluor_INT.py:2109-2119; ROI subset applies to the
    # crop exports, :1019-1026)
    subset_stage: Optional[int] = None
    subset_time: Optional[int] = None
    subset_roi: Optional[int] = None
    # outputs
    do_xls: bool = True
    do_tif: bool = False
    do_png: bool = False
    save_raw_crop_tif: bool = False   # raw-value ROI crops into TIFF/
    tif_mask_outside: bool = False
    auto_lo: float = 1.0
    auto_hi: float = 99.0
    px_um: Optional[float] = None
    png_full: "object" = None     # report.panel.PanelPngOptions
    png_crop: "object" = None
    fixed_crop: bool = True
    crop_size: int = 500
    grammar: ChannelGrammar = ChannelGrammar.TOKEN_OR_LAST

    def __post_init__(self):
        from ..report.panel import PanelPngOptions

        if self.png_full is None:
            self.png_full = PanelPngOptions()
        if self.png_crop is None:
            self.png_crop = PanelPngOptions()


def _bucket(n: int, step: int = 8) -> int:
    """Round up to a multiple of *step* to bound jit recompiles."""
    return max(step, ((n + step - 1) // step) * step)


# --------------------------------------------------------------------------
# device program
# --------------------------------------------------------------------------

@partial(
    jax.jit,
    static_argnames=("bg_mode", "bg_scope", "clip_neg", "bg_stride", "use_masks"),
)
def intensity_step(
    imgs: jnp.ndarray,            # (C, H, W) float32
    polys: jnp.ndarray,           # (N, V, 2) float32, padded
    roi_valid: jnp.ndarray,       # (N,) bool
    p1000s: jnp.ndarray,          # (C,) int32 percentile-in-thousandths per ch
    masks_in: Optional[jnp.ndarray] = None,  # (N, H, W) bool overrides rasterize
    *,
    bg_mode: str = "percentile",
    bg_scope: str = "full",
    clip_neg: bool = True,
    bg_stride: int = 4,
    use_masks: bool = False,
):
    """One (stage, time) key on device.

    Returns (stats, area_px, bgs, imgs_bc):
      stats: dict of (C, N) float32 per STAT_FIELDS, npx int32;
      area_px: (N,) int32 mask popcounts;
      bgs: (C,) float32 background levels;
      imgs_bc: (C, H, W) float32 background-corrected frames.
    """
    C, H, W = imgs.shape
    if use_masks:
        masks = masks_in & roi_valid[:, None, None]
    else:
        masks = rasterize_polygons(polys, (H, W)) & roi_valid[:, None, None]
    union = masks.any(axis=0)

    scope = union if bg_scope == "roi_union" else None
    if bg_mode == "none":
        bgs = jnp.zeros((C,), jnp.float32)
    else:
        # BG from the RAW (possibly integral) frames: u16 inputs take the
        # exact histogram quantile (no megapixel sort), bit-identical to
        # sorting the f32 cast
        bgs = jax.vmap(
            lambda im, p: bg_value(im, p, scope, bg_mode, bg_stride)
        )(imgs, p1000s)

    imgs = imgs.astype(jnp.float32)  # compact u16 upload, f32 on-chip
    imgs_bc = imgs - bgs[:, None, None]
    if clip_neg:
        imgs_bc = jnp.maximum(imgs_bc, 0.0)

    per_roi = jax.vmap(lambda m, im: masked_stats(im, m), in_axes=(0, None))
    stats = jax.vmap(lambda im: per_roi(masks, im))(imgs_bc)  # (C, N) each
    area_px = masks.sum(axis=(1, 2)).astype(jnp.int32)
    return stats, area_px, bgs, imgs_bc


@partial(
    jax.jit,
    static_argnames=("tile", "bg_mode", "clip_neg", "bg_stride"),
)
def intensity_step_tiled(
    imgs: jnp.ndarray,          # (C, H, W)
    local_polys: jnp.ndarray,   # (N, V, 2) tile-local
    offsets: jnp.ndarray,       # (N, 2) int32
    roi_valid: jnp.ndarray,     # (N,)
    p1000s: jnp.ndarray,        # (C,)
    *,
    tile: int,
    bg_mode: str = "percentile",
    clip_neg: bool = True,
    bg_stride: int = 4,
):
    """Full-frame-scope background + ROI-local tiled stats (the fast path;
    same results as :func:`intensity_step`)."""
    from ..ops.roistats import roi_stats_tiled

    C = imgs.shape[0]
    if bg_mode == "none":
        bgs = jnp.zeros((C,), jnp.float32)
    else:
        # raw-dtype BG: u16 inputs take the exact histogram quantile path
        bgs = jax.vmap(
            lambda im, p: bg_value(im, p, None, bg_mode, bg_stride)
        )(imgs, p1000s)
    imgs = imgs.astype(jnp.float32)  # compact u16 upload, f32 on-chip
    imgs_bc = imgs - bgs[:, None, None]
    if clip_neg:
        imgs_bc = jnp.maximum(imgs_bc, 0.0)
    stats, area = roi_stats_tiled(imgs_bc, local_polys, offsets, roi_valid, tile)
    return stats, area, bgs, imgs_bc


# --------------------------------------------------------------------------
# host orchestration
# --------------------------------------------------------------------------

def _apply_subset(keymap, cfg: IntensityConfig, log):
    """Stage/time subset filter (Fluor_INT.py:2109-2119)."""
    if cfg.subset_stage is None:
        return keymap
    s_code = naming.fmt_stage(cfg.subset_stage)
    if not cfg.timelapse or cfg.subset_time is None:
        keymap = {k: v for k, v in keymap.items() if k[0] == s_code}
    else:
        t_code = naming.fmt_time(cfg.subset_time)
        keymap = {k: v for k, v in keymap.items() if k == (s_code, t_code)}
    if not keymap:
        log(t("subset_no_match").format(stage=s_code))
    return keymap

def _device_inputs(
    imgs: np.ndarray,
    polys: Optional[List[np.ndarray]],
    union_mask: Optional[np.ndarray],
):
    """Pad ragged host inputs to bucketed static shapes."""
    H, W = imgs.shape[1:]
    if polys is not None:
        n = len(polys)
        nb = _bucket(n)
        vb = _bucket(max(len(p) for p in polys), 32)
        pv = np.zeros((nb, vb, 2), np.float32)
        # one batched call: a loop of single-element pad_polygons calls
        # cost ~30 ms/chunk of pack wall on the 1-core host (roistats)
        pv[:n] = pad_polygons([np.asarray(p, np.float32) for p in polys], vb)
        valid = np.zeros(nb, bool)
        valid[:n] = True
        return pv, valid, None, n
    if union_mask is not None:
        m = np.asarray(union_mask, bool)[None]
        return np.zeros((1, 32, 2), np.float32), np.ones(1, bool), m, 1
    # whole frame as ROI 0 (Fluor_INT.py:530-537)
    return (
        np.zeros((1, 32, 2), np.float32),
        np.ones(1, bool),
        np.ones((1, H, W), bool),
        1,
    )


def load_key(
    key: naming.Key,
    chmap: Dict[int, str],
    roi_dir: str,
    cfg: IntensityConfig,
    hist_stride: Optional[int] = None,
    pool=None,
):
    """Host side of one (stage, time) key: TIFF decode + ROI load.
    Returns (stid, chs, imgs, polys, union_mask) or (stid, skip_log).

    With *hist_stride* set, returns a third element: per-channel strided
    u16 counting histograms accumulated by the decoder itself (None when
    the native fused path didn't run) — the batched runner's background
    percentiles come from these at zero extra frame scans."""
    s, t_code = key
    stid = s if t_code is None else f"{s}_{t_code}"
    chs, paths = [], []
    for ch in cfg.channels:
        p = chmap.get(ch)
        if p is not None:
            chs.append(ch)
            paths.append(p)
    if not chs:
        out = (stid, t("log_no_ch").format(stid=stid))
        return out if hist_stride is None else out + (None,)
    # preserve the on-disk dtype (u16): halves host->device transfer; the
    # device step casts to f32 on-chip.  One native batch call decodes all
    # channels with an in-C++ thread pool when available.
    imgs = None
    hists = None
    try:
        from ..native import decode_tiff_batch_hist

        res = decode_tiff_batch_hist(paths, hist_stride or 0, pool=pool)
        if res is not None:
            imgs, hists = res
    except Exception:
        imgs = None
    if imgs is None or imgs.ndim != 3:
        imgs = np.stack([tiffio.read_2d(p, dtype=None) for p in paths])
        hists = None
    H, W = imgs.shape[1:]
    base = naming.find_roi_basepath(
        roi_dir, os.path.basename(paths[0]), cfg.timelapse, cfg.grammar
    )
    polys, union_mask = roiio.load_polys_or_mask(base, (H, W))
    if polys is None and union_mask is None and cfg.skip_no_roi:
        out = (stid, t("log_no_roi").format(stid=stid))
        return out if hist_stride is None else out + (None,)
    out = (stid, (chs, imgs, polys, union_mask))
    return out if hist_stride is None else out + (hists,)


def submit_key(
    key: naming.Key,
    chmap: Dict[int, str],
    roi_dir: str,
    cfg: IntensityConfig,
    loaded=None,
):
    """Dispatch one key's device work WITHOUT synchronizing.  Returns an
    opaque pending record for :func:`finalize_key` (or (None, logs) when
    skipped).  jax dispatch is async, so a caller that keeps one key in
    flight overlaps host decode, host<->device transfer and device compute
    across consecutive keys."""
    s, t_code = key
    stid, payload = loaded if loaded is not None else load_key(key, chmap, roi_dir, cfg)
    if isinstance(payload, str):
        return None, [payload]
    chs, imgs, polys, union_mask = payload
    H, W = imgs.shape[1:]

    p1000s = np.array(
        [
            p1000_of(cfg.per_channel_p.get(ch, cfg.percentile))
            for ch in chs
        ],
        np.int32,
    )

    # Fast path: ROI-local tiles (numerically identical; see ops.roistats).
    # Needs polygons and a background scope that doesn't require the union.
    tile = None
    if polys is not None and cfg.bg_scope == "full":
        from ..ops.roistats import choose_tile, tile_offsets, pad_local_polys

        tile = choose_tile(polys, H, W)
    if tile is not None:
        n_roi = len(polys)
        offs = tile_offsets(polys, H, W, tile)
        pv, offs_pad, valid = pad_local_polys(
            polys, offs, _bucket(n_roi),
            _bucket(max(len(p) for p in polys), 32),
        )
        stats, area_px, bgs, imgs_bc = intensity_step_tiled(
            jnp.asarray(imgs), jnp.asarray(pv), jnp.asarray(offs_pad),
            jnp.asarray(valid), jnp.asarray(p1000s),
            tile=tile, bg_mode=cfg.bg_mode, clip_neg=cfg.clip_neg,
            bg_stride=cfg.bg_stride,
        )
    else:
        pv, valid, masks, n_roi = _device_inputs(imgs, polys, union_mask)
        stats, area_px, bgs, imgs_bc = intensity_step(
            jnp.asarray(imgs),
            jnp.asarray(pv),
            jnp.asarray(valid),
            jnp.asarray(p1000s),
            None if masks is None else jnp.asarray(masks),
            bg_mode=cfg.bg_mode,
            bg_scope=cfg.bg_scope,
            clip_neg=cfg.clip_neg,
            bg_stride=cfg.bg_stride,
            use_masks=masks is not None,
        )
    return {
        "key": key, "stid": stid, "chs": chs, "polys": polys,
        "union_mask": union_mask, "shape": (H, W), "n_roi": n_roi,
        "stats": stats, "area_px": area_px, "bgs": bgs, "imgs_bc": imgs_bc,
        "imgs_raw": imgs,
    }, []


def finalize_key(pending, cfg: IntensityConfig):
    """Synchronize a :func:`submit_key` record into result rows."""
    s, t_code = pending["key"]
    stid = pending["stid"]
    chs = pending["chs"]
    polys = pending["polys"]
    union_mask = pending["union_mask"]
    H, W = pending["shape"]
    n_roi = pending["n_roi"]
    stats = jax.device_get(pending["stats"])
    area_px = np.asarray(pending["area_px"])
    bgs = np.asarray(pending["bgs"])

    whole_frame = polys is None and union_mask is None
    rows = []
    for i in range(n_roi):
        row = {
            "stage": s,
            "time": t_code if cfg.timelapse else None,
            "roi": 0 if whole_frame else i + 1,
            "area_px": int(area_px[i]),
            "bg_mode": cfg.bg_mode,
            "bg_scope": cfg.bg_scope,
            "clip_neg": bool(cfg.clip_neg),
            "bg_stride": int(cfg.bg_stride),
        }
        for ci, ch in enumerate(chs):
            for f in STAT_FIELDS:
                v = stats[f][ci, i]
                row[f"ch{ch}_{f}"] = int(v) if f == "npx" else float(v)
            row[f"ch{ch}_bg"] = float(bgs[ci])
            row[f"ch{ch}_p"] = float(cfg.per_channel_p.get(ch, cfg.percentile))
            row[f"ch{ch}_color"] = cfg.channel_colors.get(ch, "Grayscale")
        rows.append(row)

    logs = [t("log_done_quant").format(stid=stid, roi_count=n_roi)]
    extras = {
        "stid": stid,
        "chs": chs,
        # fetched lazily by the renderer — skipping the 25 MB/key download
        # when TIF/PNG outputs are off
        "imgs_bc_dev": pending["imgs_bc"],
        "imgs_raw": pending["imgs_raw"],
        "polys": polys,
        "union_mask": union_mask,
        "shape": (H, W),
    }
    return rows, logs, extras


def process_key(
    key: naming.Key,
    chmap: Dict[int, str],
    roi_dir: str,
    cfg: IntensityConfig,
    loaded=None,
) -> Tuple[List[dict], List[str], Optional[dict]]:
    """One (stage, time) key synchronously: (rows, logs, render extras)."""
    pending, logs = submit_key(key, chmap, roi_dir, cfg, loaded=loaded)
    if pending is None:
        return [], logs, None
    return finalize_key(pending, cfg)


def run_intensity_batched(
    folder: str,
    cfg: IntensityConfig,
    out_root: Optional[str] = None,
    log=print,
    batch_size: int = 8,
    mesh=None,
    prefetch_workers: int = 8,
    cancel=None,
) -> List[dict]:
    """Batched variant: frames stack into (B, C, H, W) and quantify in ONE
    device dispatch per chunk — optionally sharded over a ``Mesh`` (data
    parallelism over the (stage, time) axis; the device replacement for the
    reference's process pool at scale).  Table-only (XLS/CSV); use
    :func:`run_intensity` when TIF/PNG image outputs are needed.

    Streaming: chunks are consumed from the PrefetchLoader as they decode,
    with ONE batch kept in flight on the device, so host decode of chunk
    k+1 overlaps device compute of chunk k.  Keys that don't match the
    experiment's dominant (shape, channel-set) signature — or that lack
    polygons — drop to the per-key serial path inline; a non-"full"
    background scope uses the serial runner throughout."""
    from ..ops.roistats import (
        choose_tile, gather_tiles, pad_local_polys, tile_offsets,
    )
    from ..parallel.runner import (
        EmitFetchError, PrefetchLoader, batched_tile_stats_step,
        make_autoscaler, min_batch, round_batch_to_mesh,
        sharded_batched_tile_stats,
        stream_batches,
    )
    from ..report.excel import save_intensity_excel

    if (cfg.bg_scope != "full" or cfg.do_tif or cfg.do_png
            or cfg.save_raw_crop_tif):
        # image outputs need the full frame on host — the tables-only
        # minimum-transfer path would silently drop them (run_fret_batched
        # and run_nesprin2_batched gate the same way).  Say so: a --devices
        # mesh is also dropped here and the user must see why
        log(t("int_images_serial"))
        return run_intensity(folder, cfg, out_root=out_root, log=log,
                             prefetch_workers=prefetch_workers,
                             cancel=cancel)

    files = naming.list_tifs(folder)
    keymap = naming.build_keymap(files, cfg.timelapse, cfg.grammar)
    keymap = _apply_subset(keymap, cfg, log)
    roi_dir = os.path.join(folder, "roi")
    out_root = out_root or os.path.join(folder, "RES")

    # Minimum-transfer path (every bg mode): background is a scalar per
    # channel, so compute it on host and ship ONLY each ROI's tile — ~10x
    # fewer bytes over the host->device link, which is the e2e bottleneck.
    # percentile mode uses the exact native u16 counting percentile;
    # hist-mode replays the reference's 2048-bin float32 binning from the
    # same u16 histogram with bit-identical arithmetic
    # (native.hist_mode_from_hist; host==device asserted in
    # tests/test_batched_runner.py); "none" and unrecognized modes get 0.0
    # exactly like the device op (ops.background.bg_value).
    tile_step = (sharded_batched_tile_stats(mesh, clip_neg=cfg.clip_neg)
                 if mesh is not None
                 else min_batch(partial(batched_tile_stats_step,
                                        clip_neg=cfg.clip_neg)))

    def _host_bg(imgs: np.ndarray, chs, hists=None) -> np.ndarray:
        """Per-channel background, host-side (exact np.percentile of the
        strided subsample — the reference's own semantics,
        Fluor_INT.py:461-492).  When the decoder already accumulated the
        strided histograms (*hists*), the percentile is a 65536-bin lookup
        — no frame scan at all."""
        from ..native import (
            hist_mode_from_hist, hist_mode_from_values, percentile_from_hist,
            u16_percentile_strided,
        )

        C = imgs.shape[0]
        bgs = np.zeros(C, np.float32)
        if cfg.bg_mode not in ("percentile", "hist-mode"):
            return bgs  # "none" and unknown modes: 0.0, like bg_value
        for ci, ch in enumerate(chs):
            p1000 = p1000_of(cfg.per_channel_p.get(ch, cfg.percentile))
            if cfg.bg_mode == "hist-mode":
                if hists is not None:
                    bgs[ci] = hist_mode_from_hist(hists[ci], p1000)
                else:
                    vals = imgs[ci].ravel()[::max(1, cfg.bg_stride)]
                    bgs[ci] = hist_mode_from_values(vals, p1000)
            elif hists is not None:
                bgs[ci] = percentile_from_hist(hists[ci], p1000)
            elif imgs.dtype == np.uint16:
                bgs[ci] = u16_percentile_strided(imgs[ci], cfg.bg_stride, p1000)
            else:
                vals = imgs[ci].ravel()[::max(1, cfg.bg_stride)]
                bgs[ci] = np.percentile(vals.astype(np.float64), p1000 / 1000.0)
        return bgs

    # IP_TIMING=1: accumulate per-phase host wall time and print a one-line
    # breakdown at the end (perf triage for the streaming path; the phases
    # are the candidate bottlenecks: loader stall = decode not hidden,
    # pack = host numpy batching, upload = jnp.asarray + dispatch enqueue,
    # fetch = the device->host result round trip).
    tm: Optional[Dict[str, float]] = (
        dict.fromkeys(("load_wait", "pack", "upload", "fetch", "emit", "xls",
                       "ld_decode", "ld_bg", "ld_gather", "ld_upload"),
                      0.0)
        if os.environ.get("IP_TIMING") else None)
    tm_lock = threading.Lock() if tm is not None else None

    def _tm_add(phase: str, dt: float) -> None:
        # ld_* phases accumulate CPU seconds ACROSS prefetch threads (their
        # sum can exceed wall time on a multi-core host; on this 1-core box
        # it decomposes load_wait)
        with tm_lock:
            tm[phase] += dt

    tile_hint: Dict[str, int] = {}
    # recycled decode buffers: finalize()/run_serial() return each key's
    # frames once nothing references them, so steady state allocates zero
    # fresh frame pages (see native.FrameBufferPool)
    from ..native import FrameBufferPool

    frame_pool = FrameBufferPool()

    def _load_fused(kv):
        """Fully-fused per-key host path: ROI json first (so tile offsets
        are known), then ONE GIL-free native call doing decode + strided
        histogram + cache-warm ROI-tile extraction
        (native.decode_tiff_batch_hist_tiles) — the prefetch threads no
        longer fight over the GIL for the numpy tile gather.  Returns a
        loader item, or None to fall back to the decode-then-gather path
        (non-u16 frames, mask-only ROIs, hint misses, native missing)."""
        from ..native import decode_tiff_batch_hist_tiles, tiff_info

        key, chmap = kv[0], kv[1]
        s, t_code = key
        stid = s if t_code is None else f"{s}_{t_code}"
        chs, paths = [], []
        for ch in cfg.channels:
            p = chmap.get(ch)
            if p is not None:
                chs.append(ch)
                paths.append(p)
        if not chs:
            return None
        info = tiff_info(paths[0])
        if info is None or info[2] != 16 or info[3] != 1:
            return None
        H, W = info[0], info[1]
        base = naming.find_roi_basepath(
            roi_dir, os.path.basename(paths[0]), cfg.timelapse, cfg.grammar)
        if not os.path.exists(base + ".json"):
            return None  # mask-only / missing ROI: the general path decides
        polys = roiio.load_roi_polygons(base + ".json")
        if not polys:
            return None
        t_need = choose_tile(polys, H, W)
        if t_need is None:
            return None
        t_used = tile_hint.setdefault("tile", t_need)
        nb_used = tile_hint.setdefault("nb", _bucket(len(polys), 2))
        if not (t_need <= t_used <= min(H, W) and len(polys) <= nb_used):
            return None
        offs = tile_offsets(polys, H, W, t_used)
        fuse_hist = cfg.bg_mode in ("percentile", "hist-mode")
        t0 = time.perf_counter() if tm is not None else 0.0
        res = decode_tiff_batch_hist_tiles(
            paths, max(1, cfg.bg_stride) if fuse_hist else 0,
            np.asarray(offs, np.int32), t_used,
            pad_tiles=nb_used - len(polys), pool=frame_pool)
        if res is None:
            return None
        imgs, hists, tiles_np = res
        if tm is not None:
            _tm_add("ld_decode", time.perf_counter() - t0)
            t0 = time.perf_counter()
        bgs = _host_bg(imgs, chs, hists)
        if tm is not None:
            _tm_add("ld_bg", time.perf_counter() - t0)
            t0 = time.perf_counter()
        try:
            tiles = jax.device_put(tiles_np)
        except Exception:
            tiles, tiles_np = tiles_np, None  # host-side; dispatch pads
        if tm is not None:
            _tm_add("ld_upload", time.perf_counter() - t0)
        vb_used = tile_hint.setdefault(
            "vb", _bucket(max(len(p) for p in polys), 32))
        lp = valid = None
        if max(len(p) for p in polys) <= vb_used:
            lp, _, valid = pad_local_polys(polys, offs, nb_used, vb_used)
        # tiles_np rides along so finalize can recycle its pages only
        # AFTER the chunk's results are back (the h2d transfer is
        # certainly done then; recycling at upload time could race an
        # asynchronous PJRT borrow of the host buffer)
        pre = (t_used, tiles, offs, lp, valid, tiles_np)
        return key, (stid, (chs, imgs, polys, None)), bgs, pre

    def _load(kv):
        # decode + ROI parse, plus tile-path host work moved into the
        # prefetch threads so it overlaps device compute: the exact native
        # counting percentile (GIL-released) and the ROI tile gather.  The
        # first loaded key establishes a tile-size hint; a later key whose
        # ROIs outgrow it is re-gathered by dispatch (rare — ROI sizes are
        # homogeneous within an experiment).
        try:
            item = _load_fused(kv)
        except Exception:  # noqa: BLE001 — any fused-path surprise falls
            item = None    # back to the general loader below
        if item is not None:
            return item
        key = kv[0]
        t0 = time.perf_counter() if tm is not None else 0.0
        # percentile AND hist-mode backgrounds ride the decoder's own
        # histogram pass (fused: no second frame scan); "none" skips it
        fuse_hist = cfg.bg_mode in ("percentile", "hist-mode")
        if fuse_hist:
            stid, payload, hists = load_key(
                key, kv[1], roi_dir, cfg,
                hist_stride=max(1, cfg.bg_stride), pool=frame_pool)
        else:
            stid, payload = load_key(key, kv[1], roi_dir, cfg,
                                     pool=frame_pool)
            hists = None
        if tm is not None:
            _tm_add("ld_decode", time.perf_counter() - t0)
        bgs = None
        pre = None
        if not isinstance(payload, str):
            chs, imgs, polys, _ = payload
            t0 = time.perf_counter() if tm is not None else 0.0
            bgs = _host_bg(imgs, chs, hists)
            if tm is not None:
                _tm_add("ld_bg", time.perf_counter() - t0)
            if polys is not None:
                H, W = imgs.shape[1:]
                t_need = choose_tile(polys, H, W)
                if t_need is not None:
                    t_used = tile_hint.setdefault("tile", t_need)
                    # N is padded to a session-stable hint (exact for the
                    # common uniform-ROI-count experiment) so every chunk
                    # dispatches with ONE compiled shape even when stages
                    # carry different ROI counts; keys that outgrow the
                    # hint fall back to the coarse-bucketed host path
                    nb_used = tile_hint.setdefault("nb",
                                                   _bucket(len(polys), 2))
                    # t_used <= min(H, W): a key whose FRAME is smaller
                    # than the session hint tile must skip the pre-gather
                    # (classify routes it to the serial path); gathering
                    # at the hint size would raise in the loader and drop
                    # the key's rows entirely
                    if (t_need <= t_used <= min(H, W)
                            and len(polys) <= nb_used):
                        t0 = time.perf_counter() if tm is not None else 0.0
                        offs = tile_offsets(polys, H, W, t_used)
                        tiles = gather_tiles(imgs, offs, nb_used, t_used)
                        if tm is not None:
                            _tm_add("ld_gather", time.perf_counter() - t0)
                            t0 = time.perf_counter()
                        # upload from the prefetch thread: the tile bytes
                        # (the bulk of the link traffic) then cross the wire
                        # DURING the decode phase instead of serializing
                        # with result fetches after it; dispatch stacks the
                        # device-resident tiles with zero host bytes
                        try:
                            tiles = jax.device_put(tiles)
                        except Exception:
                            pass  # stays host-side; dispatch re-gathers/pads
                        if tm is not None:
                            _tm_add("ld_upload", time.perf_counter() - t0)
                        # pre-pad the polygon arrays in the loader thread
                        # too (a session vb hint, like nb): the main-thread
                        # dispatch then only np.stacks — the per-key
                        # pad_local_polys was ~30 ms/chunk of pack wall
                        vb_used = tile_hint.setdefault(
                            "vb", _bucket(max(len(p) for p in polys), 32))
                        lp = valid = None
                        if max(len(p) for p in polys) <= vb_used:
                            lp, _, valid = pad_local_polys(
                                polys, offs, nb_used, vb_used)
                        pre = (t_used, tiles, offs, lp, valid)
        return key, (stid, payload), bgs, pre

    loader = PrefetchLoader(
        _load, list(keymap.items()), workers=max(1, prefetch_workers),
        ahead=32,
    )

    batch_size = round_batch_to_mesh(batch_size, mesh)

    _cur_bs, _maybe_grow_chunk = make_autoscaler(loader, batch_size)

    rows_all: List[dict] = []
    n_done = 0

    def run_serial(key, stid, payload):
        """Per-key fallback for chunks the batch program can't take
        (stream_batches drains in-flight work first, keeping key order)."""
        nonlocal n_done
        rows, logs, _ = process_key(key, None, roi_dir, cfg,
                                    loaded=(stid, payload))
        rows_all.extend(rows)
        for line in logs:
            log(line)
        n_done += 1
        if not isinstance(payload, str):
            frame_pool.put(payload[1])

    def dispatch(chunk):
        """Build padded arrays and launch the batch WITHOUT synchronizing."""
        if tm is None:
            return _dispatch_inner(chunk)
        t0 = time.perf_counter()
        rec = _dispatch_inner(chunk)
        tm["pack"] += time.perf_counter() - t0  # _timed_step moves its share
        return rec

    def _timed_step(fn, *host_arrays):
        """Upload host arrays and enqueue the device call, timing both out
        of the enclosing pack phase."""
        t1 = time.perf_counter()
        out = fn(*(jnp.asarray(a) for a in host_arrays))
        dt = time.perf_counter() - t1
        if dt > 5.0:
            # jit compile of a new shape —
            # not gated to the first dispatch: chunk auto-growth can
            # introduce new shapes mid-run and a silent multi-minute stall
            # would look like a hang
            log(t("compile_note").format(sec=dt))
        if tm is not None:
            tm["upload"] += dt
            tm["pack"] -= dt
        return out

    def _dispatch_inner(chunk):
        all_p = [poly for _, _, (_, _, polys, _), *_ in chunk for poly in polys]
        H, W = chunk[0][2][1].shape[1:]
        tile = choose_tile(all_p, H, W)
        if tile is None:
            return None
        # align to the loader's pre-gather hint so pre-gathered tiles are
        # used and jit tile sizes stay stable; clamp to this chunk's frame
        # (the hint may come from a different-shaped first key)
        tile = min(max(tile, tile_hint.get("tile", tile)), min(H, W))
        # N padding is pure wire waste (padded tiles are real zero bytes on
        # the link), so use the loader's session-stable hints when every
        # key fits them (ONE compiled shape across chunks); outlier chunks
        # keep the coarser bucket
        max_n = max(len(c[2][2]) for c in chunk)
        nb_hint = tile_hint.get("nb")
        if nb_hint is not None and max_n <= nb_hint:
            nb = nb_hint
        else:
            nb = _bucket(max_n, 8)
        max_v = max(len(poly) for poly in all_p)
        vb_hint = tile_hint.get("vb")
        if vb_hint is not None and max_v <= vb_hint:
            vb = vb_hint  # session-stable: loader pre-padded to this
        else:
            vb = _bucket(max_v, 32)
        B = len(chunk)
        pad_b = _cur_bs() if mesh is not None else B
        C = chunk[0][2][1].shape[0]
        lp_b = np.zeros((pad_b, nb, vb, 2), np.float32)
        val_b = np.zeros((pad_b, nb), bool)
        bgs_b = np.zeros((pad_b, C), np.float32)
        per_key = []      # (tiles — device or host exact-N, or None)
        for bi, (key, _, (chs, imgs, polys, _), bgs_pre, pre) in enumerate(
                chunk):
            if pre is not None and pre[0] == tile:
                tiles_i, offs = pre[1], pre[2]
            else:  # hint missed (first keys raced / ROI outgrew it)
                offs = tile_offsets(polys, H, W, tile)
                tiles_i = None
            per_key.append((tiles_i, imgs, polys, offs))
            lp = valid = None
            if (pre is not None and pre[0] == tile and len(pre) >= 5
                    and pre[3] is not None
                    and pre[3].shape == (nb, vb, 2)):
                lp, valid = pre[3], pre[4]  # loader pre-padded
            else:
                lp, _, valid = pad_local_polys(polys, offs, nb, vb)
            lp_b[bi], val_b[bi] = lp, valid
            bgs_b[bi] = bgs_pre if bgs_pre is not None else _host_bg(
                imgs, chs)
        # fast path: every key's tiles were already uploaded by its
        # prefetch thread with the right (N, tile) shape — stack them on
        # device (enqueue only, no host pixel bytes on the link now)
        if pad_b == len(chunk) and all(
                t_i is not None and not isinstance(t_i, np.ndarray)
                and t_i.shape[0] == nb for t_i, *_ in per_key):
            tiles_b = jnp.stack([t_i for t_i, *_ in per_key])
        else:
            tiles_b = np.zeros((pad_b, nb, C, tile, tile),
                               chunk[0][2][1].dtype)
            for bi, (t_i, imgs, polys, offs) in enumerate(per_key):
                if isinstance(t_i, np.ndarray):
                    tiles_b[bi, :t_i.shape[0]] = t_i
                else:  # device array of the wrong shape, or no pre
                    tiles_b[bi] = gather_tiles(imgs, offs, nb, tile)
        stats, areas = _timed_step(tile_step, tiles_b, lp_b, val_b, bgs_b)
        return chunk, _pack(stats, areas), bgs_b

    def _pack(stats, areas):
        """One (B, 10, C, N) device array instead of ten separate fetches:
        each device->host transfer pays a round trip, so the per-chunk
        result comes back in a single fetch."""
        rows = [stats[f].astype(jnp.float32) for f in STAT_FIELDS]
        rows.append(jnp.broadcast_to(areas.astype(jnp.float32)[:, None, :],
                                     rows[0].shape))
        out = jnp.stack(rows, axis=1)
        # start the device->host copy as soon as compute finishes, so the
        # result streams back over the link while the host decodes/packs the
        # next chunk instead of paying the round trip inside finalize()
        try:
            out.copy_to_host_async()
        except AttributeError:  # non-jax array (tracing/tests)
            pass
        return out

    def finalize(rec):
        """Fetch a dispatched batch's results and emit rows."""
        nonlocal n_done
        chunk, packed, bgs = rec
        t0 = time.perf_counter() if tm is not None else 0.0
        try:  # ONE device->host round trip; no side effects yet, so a
            packed = np.asarray(packed)  # failure is safe to retry serially
        except Exception as e:  # noqa: BLE001
            raise EmitFetchError(str(e)) from e
        if tm is not None:
            tm["fetch"] += time.perf_counter() - t0
            t0 = time.perf_counter()
        stats = {f: packed[:, k] for k, f in enumerate(STAT_FIELDS)}
        areas = packed[:, len(STAT_FIELDS), 0]  # (B, N), channel-invariant
        for bi, (key, _, (chs, _, polys, _), *_) in enumerate(chunk):
            s, t_code = key
            for i in range(len(polys)):
                row = {
                    "stage": s,
                    "time": t_code if cfg.timelapse else None,
                    "roi": i + 1,
                    "area_px": int(areas[bi, i]),
                    "bg_mode": cfg.bg_mode,
                    "bg_scope": cfg.bg_scope,
                    "clip_neg": bool(cfg.clip_neg),
                    "bg_stride": int(cfg.bg_stride),
                }
                for ci, ch in enumerate(chs):
                    for f in STAT_FIELDS:
                        v = stats[f][bi, ci, i]
                        row[f"ch{ch}_{f}"] = int(v) if f == "npx" else float(v)
                    row[f"ch{ch}_bg"] = float(bgs[bi, ci])
                    row[f"ch{ch}_p"] = float(
                        cfg.per_channel_p.get(ch, cfg.percentile))
                    row[f"ch{ch}_color"] = cfg.channel_colors.get(
                        ch, "Grayscale")
                rows_all.append(row)
        n_done += len(chunk)
        # the chunk's frames are dead past this point (tiles/results are
        # separate arrays): recycle their pages for the next keys' decodes,
        # along with any fused-path host tile buffers (their h2d transfers
        # are certainly complete once the chunk's results fetched)
        for entry in chunk:
            frame_pool.put(entry[2][1])
            pre = entry[4] if len(entry) > 4 else None
            if pre is not None and len(pre) >= 6:
                frame_pool.put(pre[5])
        if tm is not None:
            tm["emit"] += time.perf_counter() - t0
        _maybe_grow_chunk()
        log(t("batch_progress").format(done=n_done))

    sig = None        # dominant (shape, channel set), set by the first key

    def classify(item):
        nonlocal sig
        key, (stid, payload), bgs_pre, pre = item
        if isinstance(payload, str):
            log(payload)
            return "skip", None
        chs, imgs, polys, _ = payload
        if sig is None and polys is not None:
            sig = (imgs.shape, tuple(chs))
        if polys is None or (imgs.shape, tuple(chs)) != sig:
            return "serial", (key, stid, payload)
        return "batch", (key, stid, payload, bgs_pre, pre)

    source = loader
    if tm is not None:
        def _timed_loader():
            it = iter(loader)
            while True:
                t0 = time.perf_counter()
                try:
                    item = next(it)
                except StopIteration:
                    return
                tm["load_wait"] += time.perf_counter() - t0
                yield item
        source = _timed_loader()

    was_cancelled = stream_batches(
        source, _cur_bs, classify, dispatch, finalize,
        lambda e: run_serial(e[0], e[1], e[2]),
        lambda err: log(t("err_worker").format(key=err.item[0],
                                               error=err.error)),
        cancel=cancel,
    )
    if was_cancelled:
        log(t("cancelled"))

    if cfg.do_xls and rows_all:
        xls_dir = os.path.join(out_root, "xls")
        os.makedirs(xls_dir, exist_ok=True)
        t0 = time.perf_counter() if tm is not None else 0.0
        save_intensity_excel(rows_all, keymap, xls_dir)
        if tm is not None:
            tm["xls"] += time.perf_counter() - t0
    if tm is not None:
        import sys

        print("[IP_TIMING] " + "  ".join(
            f"{k}={v * 1000.0:.0f}ms" for k, v in tm.items()),
            file=sys.stderr)
    return rows_all


def run_intensity(
    folder: str,
    cfg: IntensityConfig,
    out_root: Optional[str] = None,
    log=print,
    prefetch_workers: int = 8,
    run_log: bool = False,
    progress: bool = False,
    cancel=None,
) -> List[dict]:
    """Run the intensity workload over an experiment *folder*.

    ``cancel`` is an optional zero-arg callable checked between keys — the
    reference's GUI cancel flag (Fluor_INT.py:2219-2233); partial rows
    collected so far are still written.

    Mirrors Fluor_INT._run_pipeline (Fluor_INT.py:2094-2260): discover TIFFs,
    build the (stage, time) -> {channel: path} keymap, quantify every key,
    then write the per-ROI report under ``RES/``.  TIFF decode runs in a
    thread pool *prefetch_workers* wide, overlapped with device compute
    (the replacement for the reference's process pool).

    ``run_log=True`` appends to ``RES/logs/run_<ts>.txt`` with
    [START]/[END] stamps; ``progress=True`` reports ROI-weighted progress
    with an ETA (reference L8, Fluor_INT.py:679-724, 2131-2138, 2285-2319).
    """
    from ..core.runlog import Progress, RunLogger
    from ..parallel.runner import PrefetchLoader
    from ..report.excel import save_intensity_excel
    from ..report import render

    files = naming.list_tifs(folder)
    keymap = naming.build_keymap(files, cfg.timelapse, cfg.grammar)
    keymap = _apply_subset(keymap, cfg, log)
    roi_dir = os.path.join(folder, "roi")
    out_root = out_root or os.path.join(folder, "RES")

    logger = log
    if run_log:
        logger = RunLogger(os.path.join(out_root, "logs"), echo=log)

    prog = None
    key_weight = {}  # failed keys must step their FULL weight or the bar
    if progress:     # never reaches 100% and the ETA goes stale
        total = 0
        for key, chmap in keymap.items():
            any_path = next(iter(chmap.values()))
            base = naming.find_roi_basepath(
                roi_dir, os.path.basename(any_path), cfg.timelapse, cfg.grammar
            )
            key_weight[key] = max(1, roiio.count_rois(base))
            total += key_weight[key]
        prog = Progress(total, log=logger)

    items = list(keymap.items())
    loader = PrefetchLoader(
        lambda kv: (kv[0], kv[1], load_key(kv[0], kv[1], roi_dir, cfg)),
        items,
        workers=max(1, prefetch_workers),
    )
    rows_all: List[dict] = []

    def drain(pending):
        rows, logs, extras = finalize_key(pending, cfg)
        rows_all.extend(rows)
        for line in logs:
            logger(line)
        if prog is not None:
            prog.step(max(1, len(rows)), label=str(pending["key"][0]))
        if extras is not None and (cfg.do_tif or cfg.do_png):
            render.save_intensity_images(extras, cfg, out_root)

    try:
        from ..parallel.runner import LoadError

        in_flight = None  # one key pipelined: upload k+1 overlaps fetch of k
        for item in loader:
            if isinstance(item, LoadError):
                logger(t("err_worker").format(key=item.item[0], error=item.error))
                if prog is not None:
                    prog.step(key_weight.get(item.item[0], 1))
                continue
            key, chmap, loaded = item
            if cancel is not None and cancel():
                logger(t("cancelled"))
                break
            # per-key error isolation: a corrupt frame logs and skips, like
            # the reference's worker exception capture (Fluor_INT.py:1139-1143)
            try:
                pending, logs = submit_key(key, chmap, roi_dir, cfg,
                                           loaded=loaded)
            except Exception as e:
                logger(t("err_worker").format(key=key, error=e))
                pending, logs = None, []
            for line in logs:
                logger(line)
            if pending is None:
                if prog is not None:
                    prog.step(key_weight.get(key, 1), label=str(key[0]))
                continue
            if in_flight is not None:
                drain(in_flight)
            in_flight = pending
        if in_flight is not None:
            drain(in_flight)

        if cfg.do_xls and rows_all:
            xls_dir = os.path.join(out_root, "xls")
            os.makedirs(xls_dir, exist_ok=True)
            save_intensity_excel(rows_all, keymap, xls_dir)
            logger(t("saved_dir").format(dir=xls_dir))
    finally:
        if run_log:
            logger.close()
    return rows_all

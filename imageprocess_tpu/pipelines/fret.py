"""General two-channel ratiometric FRET pipeline (the reference's
fret_ratio_builder).

Reference semantics: src/FRET/fret_ratio_builder.py — stage worker
``process_one_stage`` (:429-552), ``bg_correct`` (:331-336, stride-free),
``pick_epsilon`` (:338-340), ``quantify_per_roi`` (:342-362), report block
(:980-1011).

Device design: one jitted program per (stage, time) pair computes masks,
per-channel background, the ε-stabilized ratio and all per-ROI statistics of
(ratio, donor, acceptor) in a single pass — the ratio math fuses into the
stats reductions, nothing materializes in HBM beyond the two frames and the
mask stack.
"""

from __future__ import annotations

import os
import re
import threading
import time
from dataclasses import dataclass
from functools import partial
from typing import Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core import naming, roiio, tiffio
from ..core.i18n import t
from ..core.naming import ChannelGrammar
from ..geom.rasterize import rasterize_polygons
from ..ops.background import bg_value
from ..ops.percentile import p1000_of, masked_quantile
from ..ops.ratio import ratio_with_eps
from ..ops.stats import masked_stats
from .intensity import _bucket


@dataclass
class FretConfig:
    donor_ch: int = 1
    acceptor_ch: int = 2
    timelapse: bool = False
    ratio_mode: str = "FRET/Donor"      # or "Donor/FRET"
    bg_mode: str = "percentile"
    bg_scope: str = "full"
    percentile: float = 1.0
    per_channel_p: bool = False
    donor_p: float = 1.0
    fret_p: float = 1.0
    clip_neg: bool = True
    eps_percentile: float = 1.0
    eps_abs: float = 5.0
    subset_stage: Optional[int] = None
    subset_time: Optional[int] = None
    # outputs
    do_xls: bool = True
    do_tif: bool = False
    do_png: bool = False
    save_full: bool = True
    save_crop: bool = True
    mask_outside: bool = True
    apply_cmap: bool = True
    cmap_name: str = "jet"
    show_colorbar: bool = True
    cmin_txt: str = ""
    cmax_txt: str = ""
    png_dpi: int = 300
    add_scalebar: bool = False
    scale_bar_um: Optional[float] = None
    px_um: Optional[float] = None
    fixed_crop: bool = True
    crop_w: int = 500
    crop_h: int = 500
    grammar: ChannelGrammar = ChannelGrammar.TOKEN_OR_LAST


@partial(jax.jit, static_argnames=("bg_mode", "bg_scope", "clip_neg", "flip"))
def fret_step(
    D: jnp.ndarray,               # (H, W) float32 donor
    A: jnp.ndarray,               # (H, W) float32 acceptor
    polys: jnp.ndarray,           # (N, V, 2)
    roi_valid: jnp.ndarray,       # (N,)
    d_p1000: jnp.ndarray,         # () int32
    a_p1000: jnp.ndarray,
    eps_p1000: jnp.ndarray,
    eps_abs: jnp.ndarray,         # () float32
    *,
    bg_mode: str = "percentile",
    bg_scope: str = "full",
    clip_neg: bool = True,
    flip: bool = False,           # False: FRET/Donor, True: Donor/FRET
):
    """Returns (stats dict of (3, N) arrays for [ratio, donor, yfret],
    area_px (N,), (Db, Ab, eps) scalars, R_full, Dbc, Abc, union)."""
    H, W = D.shape
    masks = rasterize_polygons(polys, (H, W)) & roi_valid[:, None, None]
    union = masks.any(axis=0)
    scope = union if bg_scope == "roi_union" else None

    def correct(img, p1000):
        # bg BEFORE the f32 cast: raw u16 input keeps bg_value on the
        # exact histogram path instead of a full-frame stride-1 sort
        # (same ordering as intensity_step, identical results)
        if bg_mode == "none":
            return img.astype(jnp.float32), jnp.float32(0.0)
        b = bg_value(img, p1000, scope, bg_mode, stride=1)
        out = img.astype(jnp.float32) - b
        if clip_neg:
            out = jnp.maximum(out, 0.0)
        return out, b

    Dbc, Db = correct(D, d_p1000)
    Abc, Ab = correct(A, a_p1000)
    numer, denom = (Dbc, Abc) if flip else (Abc, Dbc)

    scope_eps = jnp.ones((H, W), bool) if scope is None else scope
    eps_q = masked_quantile(denom, scope_eps, eps_p1000)
    eps = jnp.maximum(eps_abs, jnp.where(jnp.isnan(eps_q), eps_abs, eps_q))
    R_full = ratio_with_eps(numer, denom, eps)

    stacked = jnp.stack([R_full, Dbc, Abc])
    per_roi = jax.vmap(lambda m, im: masked_stats(im, m), in_axes=(0, None))
    stats = jax.vmap(lambda im: per_roi(masks, im))(stacked)  # (3, N)
    area = masks.sum(axis=(1, 2)).astype(jnp.int32)
    return stats, area, (Db, Ab, eps), R_full, Dbc, Abc, union


@partial(jax.jit, static_argnames=(
    "tile", "bg_mode", "bg_scope", "clip_neg", "flip",
))
def fret_step_tiled(
    D, A, full_polys, local_polys, offsets, roi_valid,
    d_p1000, a_p1000, eps_p1000, eps_abs,
    *,
    tile: int,
    bg_mode="percentile", bg_scope="full", clip_neg=True, flip=False,
):
    """Tiled FRET step: union/eps/ratio on the full frame (elementwise +
    one percentile), per-ROI stats on bbox tiles (ops.roistats rationale).

    The full-frame union is still rasterized — it feeds the eps scope and
    the RAT_ROI_masked TIFF — but the per-(image, ROI) megapixel sorts are
    replaced by tile-sized ones."""
    from ..ops.roistats import roi_stats_tiled

    H, W = D.shape
    union = rasterize_polygons(full_polys, (H, W)).any(axis=0)
    scope = union if bg_scope == "roi_union" else None

    def correct(img, p1000):
        # bg BEFORE the f32 cast: raw u16 keeps bg_value on the exact
        # histogram path (no full-frame stride-1 sort), as in intensity_step
        if bg_mode == "none":
            return img.astype(jnp.float32), jnp.float32(0.0)
        b = bg_value(img, p1000, scope, bg_mode, stride=1)
        out = img.astype(jnp.float32) - b
        if clip_neg:
            out = jnp.maximum(out, 0.0)
        return out, b

    Dbc, Db = correct(D, d_p1000)
    Abc, Ab = correct(A, a_p1000)
    numer, denom = (Dbc, Abc) if flip else (Abc, Dbc)
    scope_eps = jnp.ones((H, W), bool) if scope is None else scope
    eps_q = masked_quantile(denom, scope_eps, eps_p1000)
    eps = jnp.maximum(eps_abs, jnp.where(jnp.isnan(eps_q), eps_abs, eps_q))
    R_full = ratio_with_eps(numer, denom, eps)

    stacked = jnp.stack([R_full, Dbc, Abc])
    stats, area = roi_stats_tiled(stacked, local_polys, offsets, roi_valid, tile)
    return stats, area, (Db, Ab, eps), R_full, Dbc, Abc, union


def _stage_sort_key(key: naming.Key):
    s, t = key
    return (int(re.search(r"\d+", s).group()),
            int(re.search(r"\d+", t).group()) if t else -1)


def build_fret_pairs(folder: str, cfg: FretConfig):
    """(key, donor_path, acceptor_path) sorted by (stage, time)
    (fret_ratio_builder.py:910-931)."""
    files = naming.list_tifs(folder)
    donors, accs = {}, {}
    for path in files:
        k = naming.parse_tokens(os.path.basename(path), cfg.timelapse, cfg.grammar)
        if k.stage is None or k.channel is None:
            continue
        s = naming.fmt_stage(k.stage)
        t = naming.fmt_time(k.time) if (cfg.timelapse and k.time is not None) else None
        if k.channel == cfg.donor_ch:
            donors[(s, t)] = path
        elif k.channel == cfg.acceptor_ch:
            accs[(s, t)] = path
    keys = sorted(set(donors) & set(accs), key=_stage_sort_key)
    pairs = [(k, donors[k], accs[k]) for k in keys]
    if cfg.subset_stage is not None:
        s_code = naming.fmt_stage(cfg.subset_stage)
        if not cfg.timelapse or cfg.subset_time is None:
            pairs = [p for p in pairs if p[0][0] == s_code]
        else:
            t_code = naming.fmt_time(cfg.subset_time)
            pairs = [p for p in pairs if p[0] == (s_code, t_code)]
    return pairs


def load_pair(key, dpath, apath, roi_dir, cfg: FretConfig,
              with_hists: bool = False, pool=None):
    """Host side: decode both channels (native batch call when available)
    + load ROI polygons.  With *with_hists*, additionally returns the
    decoder's fused full-frame u16 histograms (or None) as a 4th element —
    the FRET bg/eps scalars cost no second frame scan."""
    hists = None
    try:
        from ..native import decode_tiff_batch_hist

        res = decode_tiff_batch_hist([dpath, apath],
                                     1 if with_hists else 0, pool=pool)
        both, hists = res if res is not None else (None, None)
    except Exception:
        both = None
    if both is not None and both.ndim == 3:
        D, A = both[0], both[1]
    else:
        D = tiffio.read_2d(dpath, dtype=None)
        A = tiffio.read_2d(apath, dtype=None)
        hists = None
    base = naming.find_roi_basepath(
        roi_dir, os.path.basename(dpath), cfg.timelapse, cfg.grammar,
        exts=(".json",),
    )
    polys = (roiio.load_roi_polygons(base + ".json")
             if os.path.exists(base + ".json") else None)
    if with_hists:
        return D, A, polys or None, hists
    return D, A, polys or None


def _fret_row(s, t_code, i, get, area_i, eps_f, cfg: FretConfig,
              d_p: float, a_p: float) -> dict:
    """One per-ROI table row; ``get(field, c)`` returns ROI *i*'s scalar
    for stat *field* of channel slot ``c`` (0=ratio, 1=donor, 2=yFRET).
    The ONE place the FRET row schema lives — the serial
    (:func:`process_pair`) and batched emit paths both build through it,
    so rows mixed in one report can never drift apart."""
    return {
        "roi": i + 1,
        "area_px": int(area_i),
        "ratio_mean": float(get("mean", 0)),
        "ratio_median": float(get("median", 0)),
        "ratio_std": float(get("std", 0)),
        "ratio_p5": float(get("p5", 0)),
        "ratio_p95": float(get("p95", 0)),
        "donor_mean": float(get("mean", 1)),
        "donor_median": float(get("median", 1)),
        "yfret_mean": float(get("mean", 2)),
        "yfret_median": float(get("median", 2)),
        "stage": s,
        "time": t_code if cfg.timelapse else None,
        "eps": eps_f,
        "p": cfg.percentile,
        "donor_p": d_p,
        "fret_p": a_p,
        "ratio_mode": cfg.ratio_mode,
        "bg_scope": cfg.bg_scope,
        "bg_mode": cfg.bg_mode,
        "clip_neg": cfg.clip_neg,
        "eps_p": cfg.eps_percentile,
    }


def process_pair(key, dpath, apath, roi_dir, cfg: FretConfig, out_dirs,
                 log=print, loaded=None):
    """One (stage, time) FRET pair -> per-ROI rows + TIF/PNG outputs."""
    from ..report import render

    s, t_code = key
    stid = f"{s}_{t_code}" if (cfg.timelapse and t_code is not None) else s
    D, A, polys = loaded if loaded is not None else load_pair(
        key, dpath, apath, roi_dir, cfg)
    H, W = D.shape
    if not polys:
        polys = None
        log(t("fret_roi_missing").format(tag=stid))

    from ..geom.polygon import pad_polygons
    from ..ops.roistats import choose_tile, tile_offsets, pad_local_polys

    nb = _bucket(len(polys)) if polys else 1
    vb = _bucket(max(len(p) for p in polys), 32) if polys else 32
    pv = np.zeros((nb, vb, 2), np.float32)
    valid = np.zeros(nb, bool)
    if polys:
        pv[: len(polys)] = pad_polygons(
            [np.asarray(p, np.float32) for p in polys], vb)
        valid[: len(polys)] = True

    flip = cfg.ratio_mode != "FRET/Donor"
    suffix = "DoverF" if flip else "FoverD"
    d_p = cfg.donor_p if cfg.per_channel_p else cfg.percentile
    a_p = cfg.fret_p if cfg.per_channel_p else cfg.percentile

    common = dict(bg_mode=cfg.bg_mode, bg_scope=cfg.bg_scope,
                  clip_neg=cfg.clip_neg, flip=flip)
    scalars = (jnp.int32(p1000_of(d_p)), jnp.int32(p1000_of(a_p)),
               jnp.int32(p1000_of(cfg.eps_percentile)),
               jnp.float32(cfg.eps_abs))
    tile = choose_tile(polys, H, W) if polys else None
    if tile is not None:
        offs = tile_offsets(polys, H, W, tile)
        lpv, offs_pad, lvalid = pad_local_polys(polys, offs, nb, vb)
        stats, area, (Db, Ab, eps), R_full, Dbc, Abc, union = fret_step_tiled(
            jnp.asarray(D), jnp.asarray(A), jnp.asarray(pv),
            jnp.asarray(lpv), jnp.asarray(offs_pad), jnp.asarray(lvalid),
            *scalars, tile=tile, **common,
        )
    else:
        stats, area, (Db, Ab, eps), R_full, Dbc, Abc, union = fret_step(
            jnp.asarray(D), jnp.asarray(A), jnp.asarray(pv),
            jnp.asarray(valid), *scalars, **common,
        )
    stats = jax.device_get(stats)
    area = np.asarray(area)
    eps_f = float(eps)
    render_on = cfg.do_tif or cfg.do_png
    # the megapixel ratio frame only leaves the device when rendering
    R_np = np.asarray(R_full) if render_on else None
    union_np = np.asarray(union) if (polys and render_on) else None

    rows: List[dict] = [
        _fret_row(s, t_code, i, lambda f, c, i=i: stats[f][c, i],
                  area[i], eps_f, cfg, d_p, a_p)
        for i in range(len(polys or ()))
    ]

    if cfg.do_tif or cfg.do_png:
        render.save_fret_images(
            stid=stid, suffix=suffix, R_full=R_np, union=union_np,
            polys=polys, cfg=cfg, dirs=out_dirs,
        )
    return rows


def run_fret(
    folder: str,
    cfg: FretConfig,
    out_root: Optional[str] = None,
    log=print,
    prefetch_workers: int = 8,
    cancel=None,
) -> List[dict]:
    """Run the FRET workload over an experiment *folder*
    (fret_ratio_builder.py:892-1023)."""
    from ..report.excel import save_fret_excel

    out_root = out_root or os.path.join(folder, "RES")
    dirs = {
        "RAT32": os.path.join(out_root, "RAT", "32bit"),
        "RAT16": os.path.join(out_root, "RAT", "16bit"),
        "RROI32": os.path.join(out_root, "RAT_ROI_masked", "32bit"),
        "RROI16": os.path.join(out_root, "RAT_ROI_masked", "16bit"),
        "PNG_FULL": os.path.join(out_root, "PNG_RAT", "full"),
        "PNG_CROP": os.path.join(out_root, "PNG_RAT", "crop"),
    }
    roi_dir = os.path.join(folder, "roi")
    pairs = build_fret_pairs(folder, cfg)
    if not pairs:
        log(t("fret_no_pairs").format(donor=cfg.donor_ch,
                                      acceptor=cfg.acceptor_ch))
        return []

    from ..parallel.runner import PrefetchLoader

    loader = PrefetchLoader(
        lambda kv: (kv, load_pair(kv[0], kv[1], kv[2], roi_dir, cfg)),
        pairs, workers=max(1, prefetch_workers),
    )
    from ..parallel.runner import LoadError

    rows_all: List[dict] = []
    for item in loader:
        if cancel is not None and cancel():
            log(t("cancelled"))
            break
        if isinstance(item, LoadError):
            log(t("err_worker").format(key=item.item[0], error=item.error))
            continue
        (key, dpath, apath), loaded = item
        tag = key[0] if key[1] is None else f"{key[0]}_{key[1]}"
        log(t("msg_processing").format(tag=tag))
        rows_all.extend(
            process_pair(key, dpath, apath, roi_dir, cfg, dirs, log=log,
                         loaded=loaded)
        )

    if cfg.do_xls and rows_all:
        save_fret_excel(rows_all, os.path.join(out_root, "xls"), cfg.timelapse)
        log(t("fret_saved"))
    elif cfg.do_xls:
        log(t("fret_no_roi"))
    return rows_all


# --------------------------------------------------------------------------
# minimum-transfer batched runner (tables-only)
# --------------------------------------------------------------------------

def _host_fret_scalars(D: np.ndarray, A: np.ndarray, cfg: FretConfig,
                       hists=None):
    """(bg_donor, bg_acceptor, eps) computed host-side for u16 frames.

    Backgrounds use the native exact counting percentile (stride=1, the
    FRET builder's convention).  eps = max(eps_abs, percentile of the
    bg-corrected DENOMINATOR over the full frame): the correction is a
    monotone transform, so the exact raw-u16 order statistics are
    transformed first and np.percentile-interpolated after — identical to
    sorting the corrected frame (fret_ratio_builder.py:338-340).

    *hists*: optional (2, 65536) decoder-fused histograms [D, A] — when
    present no frame scan happens here at all."""
    from ..native import hist_order_stats, percentile_from_hist, u16_hist

    flip = cfg.ratio_mode != "FRET/Donor"
    d_p = cfg.donor_p if cfg.per_channel_p else cfg.percentile
    a_p = cfg.fret_p if cfg.per_channel_p else cfg.percentile
    # ONE counting pass per channel serves both the background percentile
    # and (for the denominator) the eps quantile; with bg_mode="none" only
    # the denominator's histogram is needed at all
    need_bg = cfg.bg_mode != "none"
    if hists is not None:
        hist_d, hist_a = hists[0], hists[1]
    else:
        hist_d = u16_hist(D) if (need_bg or not flip) else None
        hist_a = u16_hist(A) if (need_bg or flip) else None
    if need_bg:
        bgd = percentile_from_hist(hist_d, p1000_of(d_p))
        bga = percentile_from_hist(hist_a, p1000_of(a_p))
    else:
        bgd = bga = 0.0
    denom_hist, denom_bg = (hist_a, bga) if flip else (hist_d, bgd)

    lo, hi, g = hist_order_stats(denom_hist, p1000_of(cfg.eps_percentile))

    def tf(v):
        v = np.float32(v) - np.float32(denom_bg)
        return float(max(v, 0.0) if cfg.clip_neg else v)

    eps_q = tf(lo) + g * (tf(hi) - tf(lo))
    return float(bgd), float(bga), float(max(cfg.eps_abs, eps_q))


@partial(jax.jit, static_argnames=("clip_neg", "flip"))
def batched_fret_tile_stats(
    tiles: jnp.ndarray,       # (B, N, 2, t, t) u16 RAW [donor, acceptor]
    local_polys: jnp.ndarray,  # (B, N, V, 2)
    roi_valid: jnp.ndarray,    # (B, N)
    bgs: jnp.ndarray,          # (B, 2) f32 host backgrounds
    eps: jnp.ndarray,          # (B,) f32 host epsilons
    *,
    clip_neg: bool = True,
    flip: bool = False,
):
    """Per-ROI stats over [ratio, donor_bc, acceptor_bc] from host-gathered
    tiles — the FRET analogue of the intensity minimum-transfer path: the
    megapixel ratio frame never exists; only ROI tiles cross the link.
    Frames run in a loop (runner.MIN_DISPATCH_FRAMES)."""

    def one(tl, lpb, vb, bg, e):
        t_ = tl.shape[-1]
        masks = rasterize_polygons(lpb, (t_, t_)) & vb[:, None, None]
        d = tl[:, 0].astype(jnp.float32) - bg[0]
        a = tl[:, 1].astype(jnp.float32) - bg[1]
        if clip_neg:
            d = jnp.maximum(d, 0.0)
            a = jnp.maximum(a, 0.0)
        numer, denom = (d, a) if flip else (a, d)
        R = (numer + e) / (denom + e)
        x = jnp.stack([R, d, a], axis=1)                   # (N, 3, t, t)

        def per_roi(mask_i, tc):
            return jax.vmap(lambda im: masked_stats(im, mask_i))(tc)

        stats = jax.vmap(per_roi)(masks, x)
        stats = {k: v.T for k, v in stats.items()}          # (3, N)
        area = masks.sum(axis=(1, 2)).astype(jnp.int32)
        return stats, area

    return jax.lax.map(lambda a: one(*a),
                       (tiles, local_polys, roi_valid, bgs, eps))


def sharded_batched_fret_tile_stats(mesh, *, clip_neg=True, flip=False):
    """batched_fret_tile_stats with its batch axis split over *mesh*'s
    devices — data parallelism over (stage, time) pairs (the FRET analogue
    of runner.sharded_batched_tile_stats)."""
    from ..parallel.runner import per_device

    return per_device(partial(batched_fret_tile_stats, clip_neg=clip_neg,
                              flip=flip), mesh)


def run_fret_batched(
    folder: str,
    cfg: FretConfig,
    out_root: Optional[str] = None,
    log=print,
    batch_size: int = 4,
    mesh=None,
    prefetch_workers: int = 8,
    cancel=None,
) -> List[dict]:
    """Tables-only batched FRET runner: host backgrounds + eps (exact
    native u16 percentiles in the prefetch threads), ROI tiles of both
    channels shipped per chunk, one packed result fetch — the same
    minimum-transfer architecture as run_intensity_batched.  Falls back to
    :func:`run_fret` when image outputs are requested or the experiment
    doesn't fit the fast path."""
    from ..ops.roistats import choose_tile, gather_tiles, pad_local_polys, tile_offsets
    from ..ops.stats import STAT_FIELDS
    from ..parallel.runner import (
        EmitFetchError, PrefetchLoader, make_autoscaler, min_batch,
        round_batch_to_mesh, stream_batches,
    )
    from ..report.excel import save_fret_excel

    fast_ok = (not cfg.do_tif and not cfg.do_png
               and cfg.bg_scope == "full"
               and cfg.bg_mode in ("percentile", "none"))
    if not fast_ok:
        return run_fret(folder, cfg, out_root=out_root, log=log,
                        prefetch_workers=prefetch_workers, cancel=cancel)

    out_root = out_root or os.path.join(folder, "RES")
    roi_dir = os.path.join(folder, "roi")
    pairs = build_fret_pairs(folder, cfg)
    if not pairs:
        log(t("fret_no_pairs").format(donor=cfg.donor_ch,
                                      acceptor=cfg.acceptor_ch))
        return []

    flip = cfg.ratio_mode != "FRET/Donor"
    d_p = cfg.donor_p if cfg.per_channel_p else cfg.percentile
    a_p = cfg.fret_p if cfg.per_channel_p else cfg.percentile

    tile_hint: Dict[str, int] = {}
    # recycled decode buffers (see native.FrameBufferPool): emit_rows /
    # run_serial return each pair's (2, H, W) backing array once dead
    from ..native import FrameBufferPool

    frame_pool = FrameBufferPool()

    # IP_TIMING=1: same per-phase host-wall breakdown as the intensity
    # runner (ld_* accumulate across prefetch threads; the rest decompose
    # the main thread's wall)
    tm: Optional[Dict[str, float]] = (
        dict.fromkeys(("load_wait", "pack", "upload", "fetch", "emit", "xls",
                       "ld_decode", "ld_scalars", "ld_gather", "ld_upload"),
                      0.0)
        if os.environ.get("IP_TIMING") else None)
    tm_lock = threading.Lock() if tm is not None else None

    def _tm_add(phase: str, dt: float) -> None:
        with tm_lock:
            tm[phase] += dt

    def _load_fused(kv):
        """Fully-fused per-pair host path (see intensity._load_fused): ROI
        json first, then ONE GIL-free native call doing both channels'
        decode + full-frame histograms + cache-warm ROI-tile extraction.
        None -> fall back to the decode-then-gather path."""
        from ..native import decode_tiff_batch_hist_tiles, tiff_info

        key, dpath, apath = kv
        info = tiff_info(dpath)
        if info is None or info[2] != 16 or info[3] != 1:
            return None
        H, W = info[0], info[1]
        base = naming.find_roi_basepath(
            roi_dir, os.path.basename(dpath), cfg.timelapse, cfg.grammar,
            exts=(".json",))
        if not os.path.exists(base + ".json"):
            return None
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
        t0 = time.perf_counter() if tm is not None else 0.0
        # stride 1: the FRET builder's bg/eps percentiles are over the FULL
        # frame (no stride — reference fret_ratio_builder semantics)
        res = decode_tiff_batch_hist_tiles(
            [dpath, apath], 1, np.asarray(offs, np.int32), t_used,
            pad_tiles=nb_used - len(polys), pool=frame_pool)
        if res is None:
            return None
        both, hists, tiles_np = res
        D, A = both[0], both[1]
        if tm is not None:
            _tm_add("ld_decode", time.perf_counter() - t0)
            t0 = time.perf_counter()
        scalars = _host_fret_scalars(D, A, cfg, hists=hists)
        if tm is not None:
            _tm_add("ld_scalars", time.perf_counter() - t0)
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
        # tiles_np rides along for emit-time recycling (h2d certainly done)
        pre = (t_used, tiles, offs, lp, valid, tiles_np)
        return kv, (D, A, polys), scalars, pre

    def _load(kv):
        try:
            item = _load_fused(kv)
        except Exception:  # noqa: BLE001 — fall back to the general loader
            item = None
        if item is not None:
            return item
        key, dpath, apath = kv
        t0 = time.perf_counter() if tm is not None else 0.0
        D, A, polys, hists = load_pair(key, dpath, apath, roi_dir, cfg,
                                       with_hists=True, pool=frame_pool)
        if tm is not None:
            _tm_add("ld_decode", time.perf_counter() - t0)
            t0 = time.perf_counter()
        scalars = (_host_fret_scalars(D, A, cfg, hists=hists)
                   if (polys and D.dtype == np.uint16
                       and A.dtype == np.uint16) else None)
        if tm is not None:
            _tm_add("ld_scalars", time.perf_counter() - t0)
        pre = None
        if scalars is not None and polys and D.shape == A.shape:
            # gather + upload this pair's ROI tiles from the prefetch
            # thread: the tile bytes cross the link DURING the decode phase
            # (same minimum-transfer pipelining as run_intensity_batched)
            H, W = D.shape
            t_need = choose_tile(polys, H, W)
            if t_need is not None:
                t_used = tile_hint.setdefault("tile", t_need)
                # session-stable N padding: one compiled shape per run even
                # when stages carry different ROI counts (see intensity)
                nb_used = tile_hint.setdefault("nb", _bucket(len(polys), 2))
                # t_used <= min(H, W): a smaller-frame pair must skip the
                # pre-gather (classify sends it to the serial path) instead
                # of raising in the loader and dropping its rows
                if t_need <= t_used <= min(H, W) and len(polys) <= nb_used:
                    t0 = time.perf_counter() if tm is not None else 0.0
                    offs = tile_offsets(polys, H, W, t_used)
                    # gather straight from D and A (no full-frame
                    # np.stack copy in the 1-core hot path)
                    tiles = np.zeros((nb_used, 2, t_used, t_used), D.dtype)
                    for i, (oy, ox) in enumerate(
                            np.asarray(offs, np.int64)):
                        tiles[i, 0] = D[oy:oy + t_used, ox:ox + t_used]
                        tiles[i, 1] = A[oy:oy + t_used, ox:ox + t_used]
                    if tm is not None:
                        _tm_add("ld_gather", time.perf_counter() - t0)
                        t0 = time.perf_counter()
                    try:
                        tiles = jax.device_put(tiles)
                    except Exception:
                        pass  # stays host-side; dispatch re-gathers
                    if tm is not None:
                        _tm_add("ld_upload", time.perf_counter() - t0)
                    # pre-pad the polygon arrays here too (session vb
                    # hint) so dispatch just stacks — see intensity
                    vb_used = tile_hint.setdefault(
                        "vb", _bucket(max(len(p) for p in polys), 32))
                    lp = valid = None
                    if max(len(p) for p in polys) <= vb_used:
                        lp, _, valid = pad_local_polys(
                            polys, offs, nb_used, vb_used)
                    pre = (t_used, tiles, offs, lp, valid)
        return kv, (D, A, polys), scalars, pre

    loader = PrefetchLoader(_load, pairs, workers=max(1, prefetch_workers),
                            ahead=32)

    batch_size = round_batch_to_mesh(batch_size, mesh)
    if mesh is not None:
        tile_step = sharded_batched_fret_tile_stats(
            mesh, clip_neg=cfg.clip_neg, flip=flip)
    else:
        tile_step = min_batch(partial(batched_fret_tile_stats,
                                      clip_neg=cfg.clip_neg, flip=flip))

    _cur_bs, _maybe_grow_chunk = make_autoscaler(loader, batch_size)

    rows_all: List[dict] = []

    def run_serial(kv, loaded):
        key, dpath, apath = kv
        rows_all.extend(process_pair(key, dpath, apath, roi_dir, cfg, {},
                                     log=log, loaded=loaded))
        if loaded is not None:
            frame_pool.put(loaded[0].base)  # the (2, H, W) decode buffer

    def emit_rows(chunk, packed):
        t0 = time.perf_counter() if tm is not None else 0.0
        try:  # ONE fetch per chunk; side-effect-free, so safe to retry
            packed = np.asarray(packed)
        except Exception as e:  # noqa: BLE001
            raise EmitFetchError(str(e)) from e
        if tm is not None:
            tm["fetch"] += time.perf_counter() - t0
            t0 = time.perf_counter()
        stats = {f: packed[:, j] for j, f in enumerate(STAT_FIELDS)}
        areas = packed[:, len(STAT_FIELDS), 0]
        for bi, (kv, (D, A, polys), (bgd, bga, eps_f), _pre) in enumerate(
                chunk):
            s, t_code = kv[0]
            for i in range(len(polys)):
                rows_all.append(_fret_row(
                    s, t_code, i,
                    lambda f, c, bi=bi, i=i: stats[f][bi, c, i],
                    areas[bi, i], eps_f, cfg, d_p, a_p))
        for kv, (D, _A, _polys), _sc, pre in chunk:
            # D/A are views into one (2, H, W) decode buffer: dead past
            # this point, recycle its pages (put() ignores a None base
            # from the per-file PIL fallback), plus any fused-path host
            # tile buffer (its h2d transfer is certainly complete now)
            frame_pool.put(D.base)
            if pre is not None and len(pre) >= 6:
                frame_pool.put(pre[5])
        if tm is not None:
            tm["emit"] += time.perf_counter() - t0
        _maybe_grow_chunk()

    def dispatch(chunk):
        if tm is None:
            return _dispatch_inner(chunk)
        t0 = time.perf_counter()
        rec = _dispatch_inner(chunk)
        tm["pack"] += time.perf_counter() - t0  # upload moves its share out
        return rec

    def _dispatch_inner(chunk):
        all_p = [poly for _, (_, _, polys), _, _ in chunk for poly in polys]
        H, W = chunk[0][1][0].shape
        tile = choose_tile(all_p, H, W)
        if tile is None:
            return None
        tile = min(max(tile, tile_hint.get("tile", tile)), min(H, W))
        max_n = max(len(c[1][2]) for c in chunk)
        nb_hint = tile_hint.get("nb")
        nb = (nb_hint if nb_hint is not None and max_n <= nb_hint
              else _bucket(max_n, 8))
        max_v = max(len(poly) for poly in all_p)
        vb_hint = tile_hint.get("vb")
        vb = (vb_hint if vb_hint is not None and max_v <= vb_hint
              else _bucket(max_v, 32))
        B = len(chunk)
        pad_b = _cur_bs() if mesh is not None else B
        lp_b = np.zeros((pad_b, nb, vb, 2), np.float32)
        val_b = np.zeros((pad_b, nb), bool)
        bgs_b = np.zeros((pad_b, 2), np.float32)
        # padded batch rows: eps=1 avoids 0/0 in lanes that are fully
        # masked out anyway (valid=False)
        eps_b = np.ones((pad_b,), np.float32)
        per_key = []
        for bi, (kv, (D, A, polys), (bgd, bga, eps_f), pre) in enumerate(
                chunk):
            if pre is not None and pre[0] == tile:
                tiles_i, offs = pre[1], pre[2]
            else:
                offs = tile_offsets(polys, H, W, tile)
                tiles_i = None
            per_key.append((tiles_i, D, A, polys, offs))
            if (pre is not None and pre[0] == tile and len(pre) >= 5
                    and pre[3] is not None
                    and pre[3].shape == (nb, vb, 2)):
                lp, valid = pre[3], pre[4]  # loader pre-padded
            else:
                lp, _, valid = pad_local_polys(polys, offs, nb, vb)
            lp_b[bi], val_b[bi] = lp, valid
            bgs_b[bi] = (bgd, bga)
            eps_b[bi] = eps_f
        # stack prefetch-thread-uploaded tiles on device (no pixel bytes on
        # the link here); any key that missed the hint re-gathers on host
        if pad_b == B and all(
                t_i is not None and not isinstance(t_i, np.ndarray)
                and t_i.shape[0] == nb for t_i, *_ in per_key):
            tiles_b = jnp.stack([t_i for t_i, *_ in per_key])
        else:
            tiles_b = np.zeros((pad_b, nb, 2, tile, tile),
                               chunk[0][1][0].dtype)
            for bi, (t_i, D, A, polys, offs) in enumerate(per_key):
                if isinstance(t_i, np.ndarray):
                    tiles_b[bi, :t_i.shape[0]] = t_i
                else:
                    tiles_b[bi] = gather_tiles(np.stack([D, A]), offs, nb,
                                               tile)
        t1 = time.perf_counter() if tm is not None else 0.0
        stats, areas = tile_step(
            jnp.asarray(tiles_b), jnp.asarray(lp_b), jnp.asarray(val_b),
            jnp.asarray(bgs_b), jnp.asarray(eps_b),
        )
        if tm is not None:
            dt = time.perf_counter() - t1
            tm["upload"] += dt
            tm["pack"] -= dt
        rows = [stats[f].astype(jnp.float32) for f in STAT_FIELDS]
        rows.append(jnp.broadcast_to(
            areas.astype(jnp.float32)[:, None, :], rows[0].shape))
        packed = jnp.stack(rows, axis=1)
        try:  # stream the result back as soon as compute finishes
            packed.copy_to_host_async()
        except AttributeError:
            pass
        return chunk, packed

    sig = None

    def classify(item):
        nonlocal sig
        kv, loaded, scalars, pre = item
        D, A, polys = loaded
        if scalars is None or not polys or D.shape != A.shape:
            return "serial", (kv, loaded)
        if sig is None:
            sig = D.shape
        if D.shape != sig:
            return "serial", (kv, loaded)
        return "batch", (kv, loaded, scalars, pre)

    def _err_key(it):
        # LoadError.item is the raw (key, dpath, apath) loader item on a
        # load failure, or an entry whose [0] is that triple when a serial
        # fallback / emit failed
        return it[0] if isinstance(it[1], str) else it[0][0]

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

    if stream_batches(
        source, _cur_bs, classify, dispatch,
        lambda rec: emit_rows(*rec),
        lambda e: run_serial(e[0], e[1]),
        lambda err: log(t("err_worker").format(key=_err_key(err.item),
                                               error=err.error)),
        cancel=cancel,
    ):
        log(t("cancelled"))

    if cfg.do_xls and rows_all:
        t0 = time.perf_counter() if tm is not None else 0.0
        save_fret_excel(rows_all, os.path.join(out_root, "xls"),
                        cfg.timelapse)
        if tm is not None:
            tm["xls"] += time.perf_counter() - t0
        log(t("fret_saved"))
    elif cfg.do_xls:
        log(t("fret_no_roi"))
    if tm is not None:
        import sys

        print("[IP_TIMING:fret] " + "  ".join(
            f"{k}={v * 1000.0:.0f}ms" for k, v in tm.items()),
            file=sys.stderr)
    return rows_all

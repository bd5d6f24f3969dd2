"""Nesprin-2 nuclear-rim FRET pipeline.

Reference semantics: src/FRET/Nesprin2_FRET_Builder.py —
``run_pipeline`` (:1331-1736), ``make_inside_rim_mask`` (:409-414, EDT),
``annulus_mask_from_poly`` (:416-427), ``spectral_correct`` (:460-468),
``bg_correct`` with isfinite filter (:432-458), QC saturation->NaN
(:1415-1421) and ratio clip->NaN (:1502-1504), per-ROI annulus local-BG
re-ratio (:1515-1535), ``save_xls`` (:1287-1326).

Known reference divergence (documented, SURVEY §7.7): the reference writes
its i18n *function object* into the "time" column when timelapse=True
(``(t if timelapse else None)``, :1542 — ``t`` is the translator, shadowing
the time code).  We write the actual time code instead.

Device design: saturation QC, background, spectral correction, both ratio
orientations, the EDT rim mask and ALL per-ROI work (annulus medians,
re-ratio, masked stats) run in one jitted program; the per-ROI stage is
vmapped over the padded ROI axis.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from functools import partial
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core import naming, roiio, tiffio
from ..core.i18n import t
from ..core.naming import ChannelGrammar
from ..geom.polygon import pad_polygons
from ..geom.rasterize import rasterize_polygons
from ..morphology.binary import square_dilation
from ..morphology.edt import rim_mask as make_rim_mask
from ..ops.percentile import p1000_of, masked_quantile
from ..ops.background import histogram_mode_value
from ..ops.ratio import clip_ratio_to_nan, ratio_with_eps, spectral_correct
from ..ops.stats import masked_stats
from .intensity import _bucket

# rim/annulus presets (µm): thin/medium/thick (Nesprin2:632-637)
RIM_PRESETS = {
    "thin": (0.45, 0.6, 1.5),
    "medium": (0.67, 0.9, 1.8),
    "thick": (1.00, 1.2, 2.0),
}


@dataclass
class Nesprin2Config:
    donor_ch: int = 1
    fret_ch: int = 2
    intensity_ch: int = 3
    aonly_ch: Optional[int] = None
    timelapse: bool = False
    ratio_mode: str = "FRET/Donor"
    bg_mode: str = "percentile"
    bg_scope: str = "full"              # "full" | "roi_union" | "annulus"
    percentile: float = 1.0
    per_channel_p: bool = False
    donor_p: float = 1.0
    fret_p: float = 1.0
    clip_neg: bool = True
    eps_percentile: float = 1.0
    eps_abs: float = 5.0
    # spectral correction
    use_spectral: bool = False
    alpha: float = 0.0
    beta: float = 0.0
    g_factor: float = 1.0
    # QC
    sat_filter_on: bool = False
    sat_threshold: float = 65535.0
    clip_ratio_on: bool = False
    clip_ratio_max: float = 10.0
    # geometry
    px_um: float = 0.112
    rim_um: float = 0.45
    annulus_on: bool = False
    ann_in_um: float = 1.2
    ann_out_um: float = 2.5
    subset_stage: Optional[int] = None
    subset_time: Optional[int] = None
    # outputs
    do_xls: bool = True
    do_tif: bool = False
    do_png: bool = False
    save_full: bool = True
    save_crop: bool = True
    save_panel: bool = False
    save_crop_intensity: bool = True
    cmap_name: str = "turbo"
    show_colorbar: bool = True
    add_scalebar: bool = False
    scale_bar_um: float = 5.0
    fret_min: float = 0.0
    fret_max: float = 0.7
    crop_vmin_txt: str = ""
    crop_vmax_txt: str = ""
    crop_fixed: bool = True
    crop_w: int = 500
    crop_h: int = 500
    grammar: ChannelGrammar = ChannelGrammar.END_ANCHORED

    @property
    def rim_px(self) -> int:
        return max(1, int(round(self.rim_um / self.px_um)))

    @property
    def ann_in_px(self) -> int:
        return max(1, int(round(self.ann_in_um / self.px_um))) if self.annulus_on or self.bg_scope == "annulus" else 0

    @property
    def ann_out_px(self) -> int:
        if not (self.annulus_on or self.bg_scope == "annulus"):
            return 0
        return max(self.ann_in_px + 1, int(round(self.ann_out_um / self.px_um)))


def _finite_bg(img, p1000, scope, mode: str):
    """Nesprin2 bg_value: isfinite-filtered percentile / hist-mode."""
    base = jnp.isfinite(img) if scope is None else (scope & jnp.isfinite(img))
    if mode == "percentile":
        b = masked_quantile(jnp.where(jnp.isfinite(img), img, jnp.inf), base, p1000)
    elif mode == "hist-mode":
        b = histogram_mode_value(jnp.where(jnp.isfinite(img), img, 0.0), base, p1000)
    else:
        return jnp.float32(0.0)
    return jnp.where(base.sum() > 0, b, 0.0).astype(jnp.float32)


def _nesprin2_body(
    D, A, Aonly, polys, roi_valid,
    d_p1000, a_p1000, g_p1000, eps_p1000, eps_abs,
    sat_thr, clip_max, alpha, beta, g_factor,
    local_polys=None, offsets=None,
    *,
    bg_mode="percentile", bg_scope="full", clip_neg=True, flip=False,
    sat_on=False, clip_on=False, use_spectral=False, has_aonly=False,
    rim_px=4, ann_on=False, ann_in_px=0, ann_out_px=0,
    tile: Optional[int] = None,
):
    """One (stage, time) pair fully on device.  Returns per-ROI stats and
    full-frame images for rendering.

    With ``tile`` set, the per-ROI stage (annulus medians, re-ratio, masked
    stats) runs on bbox tiles dynamically sliced around each ROI — the host
    guarantees each tile covers the ROI plus the annulus margin (see
    ops.roistats) — instead of sorting the full frame per ROI."""
    H, W = D.shape
    D = D.astype(jnp.float32)  # compact u16 upload, f32 on-chip
    A = A.astype(jnp.float32)
    Aonly = Aonly.astype(jnp.float32)
    if sat_on:
        mask_sat = (D >= sat_thr) | (A >= sat_thr)
        D = jnp.where(mask_sat, jnp.nan, D)
        A = jnp.where(mask_sat, jnp.nan, A)

    masks = rasterize_polygons(polys, (H, W)) & roi_valid[:, None, None]
    union = masks.any(axis=0)
    scope = None if bg_scope == "full" else union

    def correct(img, p1000):
        if bg_mode == "none":
            return img
        b = _finite_bg(img, p1000, scope, bg_mode)
        out = img - b
        if clip_neg:
            out = jnp.maximum(out, 0.0)
        return out

    Dbc = correct(D, d_p1000)
    Abc = correct(A, a_p1000)
    if use_spectral:
        Aonly_bc = correct(Aonly, g_p1000) if has_aonly else None
        Acorr = spectral_correct(Abc, Dbc, Aonly_bc, alpha, beta, g_factor)
        Dcorr = Dbc
    else:
        Dcorr, Acorr = Dbc, Abc

    numer, denom = (Dcorr, Acorr) if flip else (Acorr, Dcorr)
    numer_alt, denom_alt = (Acorr, Dcorr) if flip else (Dcorr, Acorr)

    eps_scope = union & jnp.isfinite(denom)
    eps_q = masked_quantile(jnp.where(jnp.isfinite(denom), denom, jnp.inf),
                            eps_scope, eps_p1000)
    eps = jnp.maximum(eps_abs, jnp.where(jnp.isnan(eps_q), eps_abs, eps_q))

    def ratio(n, d):
        r = ratio_with_eps(n, d, eps)
        if clip_on:
            r = clip_ratio_to_nan(r, clip_max)
        return r

    R_full = ratio(numer, denom)
    R_alt = ratio(numer_alt, denom_alt)
    rim = make_rim_mask(union, rim_px)

    def roi_body(mask_i, rim_i, numer_i, denom_i, numer_alt_i, denom_alt_i,
                 R_full_i, R_alt_i, Dcorr_i, Acorr_i):
        roi_mask = mask_i & rim_i
        if ann_on:
            ann = square_dilation(mask_i, ann_out_px) & ~square_dilation(
                mask_i, ann_in_px
            )

            def nanmed(img):
                m = ann & jnp.isfinite(img)
                v = masked_quantile(jnp.where(jnp.isfinite(img), img, jnp.inf),
                                    m, 50000)
                return jnp.where(m.sum() > 0, v, 0.0)

            def eff(img, bg):
                out = img - bg
                return jnp.maximum(out, 0.0) if clip_neg else out

            bg_n, bg_d = nanmed(numer_i), nanmed(denom_i)
            R_roi = ratio(eff(numer_i, bg_n), eff(denom_i, bg_d))
            R_roi_alt = ratio(
                eff(numer_alt_i, nanmed(numer_alt_i)),
                eff(denom_alt_i, nanmed(denom_alt_i)),
            )
        else:
            bg_n = bg_d = jnp.float32(0.0)
            R_roi, R_roi_alt = R_full_i, R_alt_i

        st = masked_stats(R_roi, roi_mask)
        alt_valid = roi_mask & jnp.isfinite(R_roi_alt)
        alt_mean = jnp.where(alt_valid, R_roi_alt, 0.0).sum() / jnp.maximum(
            alt_valid.sum().astype(jnp.float32), 1.0
        )
        alt_mean = jnp.where(alt_valid.sum() > 0, alt_mean, jnp.nan)

        def nm(img):
            v = roi_mask & jnp.isfinite(img)
            m = jnp.where(v, img, 0.0).sum() / jnp.maximum(
                v.sum().astype(jnp.float32), 1.0
            )
            return jnp.where(v.sum() > 0, m, jnp.nan)

        return (st, alt_mean, nm(Dcorr_i), nm(Acorr_i),
                roi_mask.sum().astype(jnp.int32), bg_n, bg_d)

    if tile is not None:
        frames = jnp.stack([numer, denom, numer_alt, denom_alt,
                            R_full, R_alt, Dcorr, Acorr])
        rim_f = rim.astype(jnp.float32)
        masks_t = rasterize_polygons(local_polys, (tile, tile)) & \
            roi_valid[:, None, None]

        def per_roi_tiled(mask_i, off):
            ft = jax.lax.dynamic_slice(
                frames, (0, off[0], off[1]), (frames.shape[0], tile, tile)
            )
            rim_t = jax.lax.dynamic_slice(rim_f, (off[0], off[1]),
                                          (tile, tile)) > 0.5
            return roi_body(mask_i, rim_t, *ft)

        results = jax.vmap(per_roi_tiled)(masks_t, offsets)
    else:
        results = jax.vmap(
            lambda m: roi_body(m, rim, numer, denom, numer_alt, denom_alt,
                               R_full, R_alt, Dcorr, Acorr)
        )(masks)

    (stats, alt_means, donor_means, fret_means, areas, bg_ns, bg_ds) = results
    return (stats, alt_means, donor_means, fret_means, areas, bg_ns, bg_ds,
            eps, R_full, R_alt, rim, union, Dcorr, Acorr)


nesprin2_step = partial(jax.jit, static_argnames=(
    "bg_mode", "bg_scope", "clip_neg", "flip", "sat_on", "clip_on",
    "use_spectral", "has_aonly", "rim_px", "ann_on", "ann_in_px", "ann_out_px",
    "tile",
))(_nesprin2_body)


# table fields packed by the batched step, per ROI slot, in order
_N2_STAT_FIELDS = ("mean", "median", "std", "p5", "p95", "vmin", "vmax",
                   "vsum", "npx")


def make_nesprin2_batched_step(cfg: "Nesprin2Config", *, has_aonly: bool,
                               tile: int, mesh=None):
    """A chunk of rim-FRET pairs in ONE dispatch: the full device chain
    (QC, backgrounds, spectral, eps, ratio, EDT rim, annulus local-BG,
    tiled per-ROI stats) vmapped over the pair axis, returning one flat
    (B, K) table array.  This is a minimum-FETCH path (nothing image-sized
    comes BACK over the link) — unlike intensity/FRET it must still UPLOAD
    full frames, because the rim EDT and the eps scope need the whole
    union mask.  Optionally split over *mesh*'s devices (DP over pairs,
    :func:`parallel.runner.per_device`, as the intensity/FRET/FA
    runners)."""
    flip = cfg.ratio_mode != "FRET/Donor"
    d_p = cfg.donor_p if cfg.per_channel_p else cfg.percentile
    a_p = cfg.fret_p if cfg.per_channel_p else cfg.percentile
    ann_active = cfg.annulus_on or cfg.bg_scope == "annulus"
    kw = dict(bg_mode=cfg.bg_mode, bg_scope=cfg.bg_scope,
              clip_neg=cfg.clip_neg, flip=flip, sat_on=cfg.sat_filter_on,
              clip_on=cfg.clip_ratio_on, use_spectral=cfg.use_spectral,
              has_aonly=has_aonly, rim_px=cfg.rim_px, ann_on=ann_active,
              ann_in_px=cfg.ann_in_px, ann_out_px=cfg.ann_out_px, tile=tile)

    def one(D, A, Aonly, pv, valid, lp, offs):
        out = _nesprin2_body(
            D, A, Aonly, pv, valid,
            jnp.int32(p1000_of(d_p)), jnp.int32(p1000_of(a_p)),
            jnp.int32(p1000_of(cfg.percentile)),
            jnp.int32(p1000_of(cfg.eps_percentile)),
            jnp.float32(cfg.eps_abs), jnp.float32(cfg.sat_threshold),
            jnp.float32(cfg.clip_ratio_max), jnp.float32(cfg.alpha),
            jnp.float32(cfg.beta), jnp.float32(cfg.g_factor),
            lp, offs, **kw)
        (stats, alt_means, donor_means, fret_means, areas, bg_ns, bg_ds,
         eps, *_imgs) = out
        cols = [stats[f].astype(jnp.float32) for f in _N2_STAT_FIELDS]
        cols += [alt_means, donor_means, fret_means,
                 areas.astype(jnp.float32), bg_ns, bg_ds]
        return jnp.concatenate(
            [jnp.stack(cols, 0).ravel(), eps[None]])

    fn = jax.jit(jax.vmap(one))
    if mesh is None:
        return fn
    from ..parallel.runner import per_device

    return per_device(fn, mesh)


def unpack_n2_flat(flat: np.ndarray, nb: int):
    """({field: (B, nb)}, eps (B,)) from the batched step's flat result."""
    B = flat.shape[0]
    n_f = len(_N2_STAT_FIELDS) + 6
    cols = flat[:, :n_f * nb].reshape(B, n_f, nb)
    names = list(_N2_STAT_FIELDS) + ["alt_mean", "donor_mean", "fret_mean",
                                     "area", "bg_n", "bg_d"]
    return {n: cols[:, k] for k, n in enumerate(names)}, flat[:, -1]


def load_pair_nesprin2(key, dpath, apath, roi_dir, cfg: Nesprin2Config,
                       need_intensity: bool = True):
    """Host side of one pair: donor/acceptor (+ intensity, + optional
    acceptor-only via the swap_ch fallback chain, :1424-1437) and ROIs.
    The intensity-channel frame feeds only the image outputs; tables-only
    callers skip its decode with ``need_intensity=False`` (I = None)."""
    D = tiffio.read_2d(dpath, dtype=None)
    A = tiffio.read_2d(apath, dtype=None)

    I = None
    if need_intensity:
        cand = naming.swap_channel_in_name(dpath, cfg.intensity_ch)
        if not os.path.exists(cand):
            cand = naming.swap_channel_in_name(apath, cfg.intensity_ch)
        I = (tiffio.read_2d(cand) if os.path.exists(cand)
             else D.astype(np.float32))

    Aonly = None
    if cfg.aonly_ch is not None:
        cand = naming.swap_channel_in_name(dpath, cfg.aonly_ch)
        if not os.path.exists(cand):
            cand = naming.swap_channel_in_name(apath, cfg.aonly_ch)
        if os.path.exists(cand):
            Aonly = tiffio.read_2d(cand)

    base = naming.find_roi_basepath(roi_dir, os.path.basename(dpath),
                                    cfg.timelapse, cfg.grammar, exts=(".json",))
    polys = (roiio.load_roi_polygons(base + ".json")
             if os.path.exists(base + ".json") else None)
    return D, A, I, Aonly, polys


def process_pair_nesprin2(key, dpath, apath, roi_dir, cfg: Nesprin2Config,
                          dirs, log=print, loaded=None) -> List[dict]:
    from ..report import render

    s, t_code = key
    tag = f"{s}_{t_code}" if (cfg.timelapse and t_code is not None) else s
    D, A, I, Aonly, polys = loaded if loaded is not None else \
        load_pair_nesprin2(key, dpath, apath, roi_dir, cfg)
    H, W = D.shape
    if not polys:
        log(t("msg_warn_no_roi_tag").format(tag=tag))
        return []

    nb = _bucket(len(polys))
    vb = _bucket(max(len(p) for p in polys), 32)
    pv = np.zeros((nb, vb, 2), np.float32)
    pv[: len(polys)] = pad_polygons(
        [np.asarray(p, np.float32) for p in polys], vb)
    valid = np.zeros(nb, bool)
    valid[: len(polys)] = True

    flip = cfg.ratio_mode != "FRET/Donor"
    suffix = "DoverF" if flip else "FoverD"
    d_p = cfg.donor_p if cfg.per_channel_p else cfg.percentile
    a_p = cfg.fret_p if cfg.per_channel_p else cfg.percentile
    ann_active = cfg.annulus_on or cfg.bg_scope == "annulus"

    from ..ops.roistats import choose_tile, tile_offsets, pad_local_polys

    margin = (cfg.ann_out_px + 1) if ann_active else 0
    tile = choose_tile(polys, H, W, margin=margin)
    if tile is not None:
        offs = tile_offsets(polys, H, W, tile, margin=margin)
        lpv, offs_pad, _ = pad_local_polys(polys, offs, nb, vb)
        tiled_args = (jnp.asarray(lpv), jnp.asarray(offs_pad))
    else:
        tiled_args = (None, None)

    out = nesprin2_step(
        jnp.asarray(D), jnp.asarray(A),
        jnp.asarray(Aonly if Aonly is not None
                    else np.zeros((1, 1), D.dtype)),
        jnp.asarray(pv), jnp.asarray(valid),
        jnp.int32(p1000_of(d_p)), jnp.int32(p1000_of(a_p)),
        jnp.int32(p1000_of(cfg.percentile)),
        jnp.int32(p1000_of(cfg.eps_percentile)), jnp.float32(cfg.eps_abs),
        jnp.float32(cfg.sat_threshold), jnp.float32(cfg.clip_ratio_max),
        jnp.float32(cfg.alpha), jnp.float32(cfg.beta), jnp.float32(cfg.g_factor),
        *tiled_args,
        bg_mode=cfg.bg_mode, bg_scope=cfg.bg_scope, clip_neg=cfg.clip_neg,
        flip=flip, sat_on=cfg.sat_filter_on, clip_on=cfg.clip_ratio_on,
        use_spectral=cfg.use_spectral, has_aonly=Aonly is not None,
        rim_px=cfg.rim_px, ann_on=ann_active,
        ann_in_px=cfg.ann_in_px, ann_out_px=cfg.ann_out_px, tile=tile,
    )
    (stats, alt_means, donor_means, fret_means, areas, bg_ns, bg_ds,
     eps, R_full, R_alt, rim, union, Dcorr, Acorr) = out
    stats = jax.device_get(stats)
    alt_means = np.asarray(alt_means)
    donor_means = np.asarray(donor_means)
    fret_means = np.asarray(fret_means)
    areas = np.asarray(areas)
    eps_f = float(eps)

    serial_cols = {
        "mean": stats["mean"], "median": stats["median"],
        "std": stats["std"], "p5": stats["p5"], "p95": stats["p95"],
        "alt_mean": alt_means, "donor_mean": donor_means,
        "fret_mean": fret_means, "area": areas,
    }
    rows = [
        _n2_row(s, t_code, i, lambda f, i=i: serial_cols[f][i], eps_f,
                cfg, flip, d_p, a_p)
        for i in range(len(polys))
    ]

    if cfg.do_tif or cfg.do_png:
        Dc = np.asarray(Dcorr)
        Ac = np.asarray(Acorr)
        numer_np, denom_np = (Dc, Ac) if flip else (Ac, Dc)
        render.save_nesprin2_images(
            tag=tag, suffix=suffix,
            R_full=np.asarray(R_full), rim=np.asarray(rim),
            I=I, polys=polys, cfg=cfg, dirs=dirs, eps=eps_f,
            ann_bgs=(np.asarray(bg_ns), np.asarray(bg_ds)) if ann_active else None,
            numer=numer_np, denom=denom_np,
        )
    return rows


def _n2_pairs(folder: str, cfg: Nesprin2Config, log):
    """Discover + subset-filter the (key, donor, acceptor) pairs."""
    files = naming.list_tifs(folder)
    pairs, _ = naming.build_pairs_by_channel(
        files, cfg.timelapse, cfg.donor_ch, cfg.fret_ch, cfg.grammar
    )
    log(t("msg_info_pairs").format(count=len(pairs)))
    if pairs and cfg.subset_stage is not None:
        s_code = naming.fmt_stage(cfg.subset_stage)
        if not cfg.timelapse or cfg.subset_time is None:
            pairs = [p for p in pairs if p[0][0] == s_code]
        else:
            t_code = naming.fmt_time(cfg.subset_time)
            pairs = [p for p in pairs if p[0] == (s_code, t_code)]
    return pairs


def _n2_row(s, t_code, i, get, eps_f, cfg: Nesprin2Config,
            flip: bool, d_p: float, a_p: float) -> dict:
    """One per-ROI table row; ``get(field)`` returns ROI *i*'s scalar for
    mean/median/std/p5/p95/alt_mean/donor_mean/fret_mean/area.  The ONE
    place the nesprin2 row schema lives — both the serial
    (process_pair_nesprin2) and batched emit paths build through it, so
    rows mixed in one report can never drift apart."""
    main_mean = float(get("mean"))
    alt_mean = float(get("alt_mean"))
    return {
        "stage": s,
        "time": t_code if cfg.timelapse else None,
        "roi": i + 1,
        "area_px": int(get("area")),
        "ratio_mean": main_mean,
        "ratio_median": float(get("median")),
        "ratio_std": float(get("std")),
        "ratio_p5": float(get("p5")),
        "ratio_p95": float(get("p95")),
        "ratio_FoverD_mean": alt_mean if flip else main_mean,
        "ratio_DoverF_mean": main_mean if flip else alt_mean,
        "donor_mean": float(get("donor_mean")),
        "fret_mean": float(get("fret_mean")),
        "eps": eps_f, "p": cfg.percentile,
        "donor_p": d_p, "fret_p": a_p,
        "ratio_mode": cfg.ratio_mode,
        "bg_scope": cfg.bg_scope, "bg_mode": cfg.bg_mode,
        "clip_neg": cfg.clip_neg,
        "sat_filter_on": cfg.sat_filter_on,
        "sat_threshold": cfg.sat_threshold,
        "clip_ratio_on": cfg.clip_ratio_on,
        "clip_ratio_max": cfg.clip_ratio_max,
    }


def run_nesprin2_batched(
    folder: str,
    cfg: Nesprin2Config,
    out_root: Optional[str] = None,
    log=print,
    batch_size: int = 4,
    mesh=None,
    prefetch_workers: int = 8,
    cancel=None,
) -> List[dict]:
    """Tables-only batched rim-FRET runner: prefetch-thread decode, a
    chunk of pairs per fused dispatch (the FULL device chain — QC,
    backgrounds, spectral, eps, EDT rim, annulus local-BG, tiled per-ROI
    stats — vmapped over pairs, :func:`make_nesprin2_batched_step`),
    optionally split over a ``Mesh``'s devices.  Rows identical to
    :func:`run_nesprin2`; image outputs fall back to the serial runner."""
    if cfg.do_tif or cfg.do_png:
        # image outputs render host-side per pair (94% of that wall is the
        # renderer, docs/DESIGN.md) — say so instead of silently dropping
        # a requested mesh
        log(t("n2_images_serial"))
        return run_nesprin2(folder, cfg, out_root=out_root, log=log,
                            cancel=cancel)
    from ..ops.roistats import choose_tile, pad_local_polys, tile_offsets
    from ..parallel.runner import (
        EmitFetchError, PrefetchLoader, round_batch_to_mesh,
        stream_batches,
    )
    from ..report.excel import save_nesprin2_excel

    out_root = out_root or os.path.join(folder, "RES")
    roi_dir = os.path.join(folder, "roi")
    pairs = _n2_pairs(folder, cfg, log)
    if not pairs:
        log(t("msg_no_pairs"))
        return []

    flip = cfg.ratio_mode != "FRET/Donor"
    d_p = cfg.donor_p if cfg.per_channel_p else cfg.percentile
    a_p = cfg.fret_p if cfg.per_channel_p else cfg.percentile
    ann_active = cfg.annulus_on or cfg.bg_scope == "annulus"
    margin = (cfg.ann_out_px + 1) if ann_active else 0

    hint: Dict[str, int] = {}

    def _load(kv):
        key, dpath, apath = kv
        D, A, _I, Aonly, polys = load_pair_nesprin2(
            key, dpath, apath, roi_dir, cfg, need_intensity=False)
        # pre-pad the polygon/offset arrays in the prefetch thread against
        # session-stable (tile, nb, vb) hints, so dispatch only stacks
        # (mirrors the intensity loader; the per-key pad loops were pack
        # wall on the 1-core host)
        pre = None
        if polys and A.shape == D.shape:
            H, W = D.shape
            t_need = choose_tile(polys, H, W, margin=margin)
            if t_need is not None:
                t_used = hint.setdefault("tile", t_need)
                nb_used = hint.setdefault("nb", _bucket(len(polys)))
                vb_used = hint.setdefault(
                    "vb", _bucket(max(len(p) for p in polys), 32))
                if (t_need <= t_used <= min(H, W)
                        and len(polys) <= nb_used
                        and max(len(p) for p in polys) <= vb_used):
                    pv = np.zeros((nb_used, vb_used, 2), np.float32)
                    pv[: len(polys)] = pad_polygons(
                        [np.asarray(p, np.float32) for p in polys], vb_used)
                    valid = np.zeros(nb_used, bool)
                    valid[:len(polys)] = True
                    offs = tile_offsets(polys, H, W, t_used, margin=margin)
                    lp, off_pad, _ = pad_local_polys(polys, offs, nb_used,
                                                     vb_used)
                    pre = (t_used, pv, valid, lp, off_pad)
        return kv, (D, A, Aonly, polys), pre

    loader = PrefetchLoader(_load, pairs, workers=max(1, prefetch_workers))

    batch_size = round_batch_to_mesh(batch_size, mesh)

    step_cache: Dict[tuple, object] = {}
    rows_all: List[dict] = []

    def run_serial(kv, loaded4):
        key, dpath, apath = kv
        D, A, Aonly, polys = loaded4
        rows_all.extend(process_pair_nesprin2(
            key, dpath, apath, roi_dir, cfg, {}, log=log,
            loaded=(D, A, None, Aonly, polys)))

    sig = None

    def classify(item):
        nonlocal sig
        kv, (D, A, Aonly, polys), pre = item
        key = kv[0]
        tag = key[0] if key[1] is None else f"{key[0]}_{key[1]}"
        log(t("msg_processing").format(tag=tag))
        if not polys:
            log(t("msg_warn_no_roi_tag").format(tag=tag))
            return "skip", None
        key_sig = (D.shape, A.shape, Aonly is not None)
        if sig is None and pre is not None:
            sig = key_sig
        if pre is None or key_sig != sig or pre[0] != hint.get("tile"):
            return "serial", (kv, (D, A, Aonly, polys))
        return "batch", (kv, (D, A, Aonly, polys), pre)

    def step_for(tile, nb, vb):
        key = (tile, nb, vb)
        if key not in step_cache:
            step_cache[key] = make_nesprin2_batched_step(
                cfg, has_aonly=sig[2], tile=tile, mesh=mesh)
        return step_cache[key]

    def dispatch(chunk):
        tile, nb, vb = hint["tile"], hint["nb"], hint["vb"]
        B = len(chunk)
        pad_b = batch_size if mesh is not None else B
        H, W = chunk[0][1][0].shape
        D_b = np.zeros((pad_b, H, W), chunk[0][1][0].dtype)
        A_b = np.zeros((pad_b, H, W), chunk[0][1][1].dtype)
        # a (1, 1) placeholder when no acceptor-only channel exists:
        # _nesprin2_body never reads it unless has_aonly, and a full-frame
        # zeros array would ship ~6 MB of dead bytes per pair
        Ao_b = (np.zeros((pad_b, H, W), chunk[0][1][2].dtype) if sig[2]
                else np.zeros((pad_b, 1, 1), np.uint16))
        pv_b = np.zeros((pad_b, nb, vb, 2), np.float32)
        val_b = np.zeros((pad_b, nb), bool)
        lp_b = np.zeros((pad_b, nb, vb, 2), np.float32)
        off_b = np.zeros((pad_b, nb, 2), np.int32)
        for bi, (kv, (D, A, Aonly, polys), pre) in enumerate(chunk):
            D_b[bi], A_b[bi] = D, A
            if sig[2] and Aonly is not None:
                Ao_b[bi] = Aonly
            _t, pv, valid, lp, off_pad = pre  # loader pre-padded to hints
            pv_b[bi], val_b[bi] = pv, valid
            lp_b[bi], off_b[bi] = lp, off_pad
        flat = step_for(tile, nb, vb)(
            jnp.asarray(D_b), jnp.asarray(A_b), jnp.asarray(Ao_b),
            jnp.asarray(pv_b), jnp.asarray(val_b), jnp.asarray(lp_b),
            jnp.asarray(off_b))
        try:
            flat.copy_to_host_async()
        except AttributeError:
            pass
        return chunk, flat

    def finalize(rec):
        chunk, flat = rec
        try:  # fetch is side-effect-free: a failure is safe to retry
            flat = np.asarray(flat)
        except Exception as e:  # noqa: BLE001
            raise EmitFetchError(str(e)) from e
        cols, eps_arr = unpack_n2_flat(flat, hint["nb"])
        for bi, (kv, (_D, _A, _Ao, polys), _pre) in enumerate(chunk):
            s, t_code = kv[0]
            eps_f = float(eps_arr[bi])
            for i in range(len(polys)):
                rows_all.append(_n2_row(
                    s, t_code, i, lambda f, bi=bi, i=i: cols[f][bi, i],
                    eps_f, cfg, flip, d_p, a_p))

    def _err_key(it):
        # LoadError.item is the raw (key, dpath, apath) loader item on a
        # load failure, or an entry whose [0] is that triple when a serial
        # fallback / emit failed
        return it[0] if isinstance(it[1], str) else it[0][0]

    if stream_batches(
        loader, batch_size, classify, dispatch, finalize,
        lambda e: run_serial(e[0], e[1]),
        lambda err: log(t("err_worker").format(key=_err_key(err.item),
                                               error=err.error)),
        cancel=cancel,
    ):
        log(t("cancelled"))

    if cfg.do_xls:
        save_nesprin2_excel(rows_all, os.path.join(out_root, "xls"),
                            cfg.timelapse)
    return rows_all


def run_nesprin2(
    folder: str,
    cfg: Nesprin2Config,
    out_root: Optional[str] = None,
    log=print,
    cancel=None,
) -> List[dict]:
    """Run the rim-FRET workload (Nesprin2_FRET_Builder.py:1331-1736)."""
    from ..report.excel import save_nesprin2_excel

    out_root = out_root or os.path.join(folder, "RES")
    roi_dir = os.path.join(folder, "roi")
    pairs = _n2_pairs(folder, cfg, log)
    if not pairs:
        log(t("msg_no_pairs"))
        return []

    dirs = {
        "tif32_full": os.path.join(out_root, "TIF", "ratio32_full"),
        "tif32_rim": os.path.join(out_root, "TIF", "ratio32_rim"),
        "png_full_ratio": os.path.join(out_root, "PNG", "FULL_RATIO"),
        "png_full_int": os.path.join(out_root, "PNG", "FULL_INT"),
        "png_panel": os.path.join(out_root, "PNG", "panel"),
        "png_crop_ratio": os.path.join(out_root, "PNG", "CROP_RATIO"),
        "png_crop_int_no": os.path.join(out_root, "PNG", "CROP_INT", "no_rim"),
        "png_crop_int_r": os.path.join(out_root, "PNG", "CROP_INT", "rim"),
    }

    from ..parallel.runner import PrefetchLoader

    loader = PrefetchLoader(
        lambda kv: (kv, load_pair_nesprin2(kv[0], kv[1], kv[2], roi_dir, cfg)),
        pairs, workers=8,
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
            process_pair_nesprin2(key, dpath, apath, roi_dir, cfg, dirs,
                                  log=log, loaded=loaded)
        )

    if cfg.do_xls:
        save_nesprin2_excel(rows_all, os.path.join(out_root, "xls"), cfg.timelapse)
    return rows_all

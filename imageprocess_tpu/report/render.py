"""PNG / TIFF image exports (matplotlib on host, fed by device results).

Visual-output parity with the reference:

- single-color black->color colormaps: src/INT/Fluor_INT.py:556-583
- scalebar (margins, clamping, label): src/INT/Fluor_INT.py:588-613
- inset 2/3-height colorbar: src/INT/Fluor_INT.py:615-640
- ``save_png_colormap`` black-background figure writer: Fluor_INT.py:642-675
- worker TIF32/TIF16/PNG-full/PNG-crop block: Fluor_INT.py:917-1135
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Sequence

import matplotlib

matplotlib.use("Agg")
import matplotlib as mpl  # noqa: E402
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
from matplotlib.colors import LinearSegmentedColormap  # noqa: E402

from ..core import tiffio  # noqa: E402
from ..geom.rasterize import rasterize_polygon_np  # noqa: E402
from .panel import PanelPngOptions, _auto_minmax_np  # noqa: E402,F401

COLOR_CHOICES = ["Cyan", "Yellow", "Green", "Red", "Blue", "Magenta", "Grayscale"]
CMAP_CHOICES = ["jet", "turbo", "viridis", "plasma", "magma", "inferno", "cividis"]
SB_ANCHORS = ["br", "bl", "tr", "tl"]

_SINGLE_RGB = {
    "cyan": (0.0, 1.0, 1.0),
    "yellow": (1.0, 1.0, 0.0),
    "green": (0.0, 1.0, 0.0),
    "red": (1.0, 0.0, 0.0),
    "blue": (0.0, 0.0, 1.0),
    "magenta": (1.0, 0.0, 1.0),
}



# PNG deflate level for matplotlib savers: level 3 encodes ~2x faster than
# PIL's default 6 for ~10% larger files — the renderers are the wall on
# image-output workloads (docs/DESIGN.md render-share measurements)
_PNG_KW = dict(pil_kwargs={"compress_level": 3})


def _fill_frame(fig, ax):
    """Stretch a borderless imshow axes to the full figure.  Replaces
    ``fig.tight_layout(pad=0)`` on these savers: tight_layout triggers a
    FULL extra draw (~0.8 s per 3.1 Mpix frame) and warns on fixed-aspect
    axes, while producing the same packed geometry."""
    ax.set_position((0.0, 0.0, 1.0, 1.0))


def crop_bbox(minx, maxx, miny, maxy, W: int, H: int):
    """The reference crop window: bbox + max(10, 5% of the long side) pad,
    clamped inclusive to the frame (Fluor_INT.py:1019-1035).  ONE
    implementation — every crop export (fret, nesprin2, morphology,
    intensity) slices with these bounds."""
    pad = max(10, int(0.05 * max(W, H)))
    x0 = max(int(minx) - pad, 0)
    x1 = min(int(maxx) + pad, W - 1)
    y0 = max(int(miny) - pad, 0)
    y1 = min(int(maxy) + pad, H - 1)
    return x0, x1, y0, y1


def crop_bbox_poly(pts: np.ndarray, W: int, H: int):
    """:func:`crop_bbox` of a polygon's vertices."""
    pts = np.asarray(pts)
    return crop_bbox(pts[:, 0].min(), pts[:, 0].max(),
                     pts[:, 1].min(), pts[:, 1].max(), W, H)


def get_cmap_for_color(color_name: Optional[str]):
    """Black -> single-color gradient colormap; Grayscale -> 'gray'."""
    if color_name is None or color_name.lower() == "grayscale":
        return "gray"
    rgb = _SINGLE_RGB.get(color_name.lower())
    if rgb is None:
        return "gray"
    r, g, b = rgb
    return LinearSegmentedColormap(
        "single_" + color_name,
        segmentdata={
            "red": ((0.0, 0.0, 0.0), (1.0, r, r)),
            "green": ((0.0, 0.0, 0.0), (1.0, g, g)),
            "blue": ((0.0, 0.0, 0.0), (1.0, b, b)),
        },
    )


# --- scalebar / colorbar geometry (pure, unit-testable) ---------------------
#
# Visual constants matching the reference output (Fluor_INT.py:588-640):
# 5% frame margins, label offset max(10 px, 2% of height), bar length
# clamped to [2 px, 80% of width], inset colorbar 2/3 of the image height
# and 0.02 figure-widths wide with a 0.01 gap.

@dataclass(frozen=True)
class ScalebarSpec:
    x0: float
    x1: float
    y: float
    label_y: float
    label_va: str
    label: str


def scalebar_spec(img_w: int, img_h: int, scalebar_um: float, px_um: float,
                  anchor: str = "br") -> ScalebarSpec:
    """Placement of a scalebar in image coordinates.  The printed label is
    the CLAMPED physical length, not the requested one."""
    if anchor not in SB_ANCHORS:
        anchor = "br"
    bar_px = int(round(float(scalebar_um) / float(px_um)))
    bar_px = max(2, min(bar_px, int(0.8 * img_w)))
    mx, my = int(img_w * 0.05), int(img_h * 0.05)
    at_bottom = anchor in ("br", "bl")
    x0 = (img_w - mx - bar_px) if anchor in ("br", "tr") else mx
    y = (img_h - my) if at_bottom else my
    dy = max(10, int(0.02 * img_h))
    return ScalebarSpec(
        x0=x0, x1=x0 + bar_px, y=y,
        label_y=y - dy if at_bottom else y + dy,
        label_va="bottom" if at_bottom else "top",
        label=f"{bar_px * float(px_um):.0f} µm",
    )


def _inset_colorbar_rect(bbox) -> list:
    """[x0, y0, w, h] of the inset colorbar axes, centered vertically at
    2/3 of the image axes' height, just right of it."""
    h = bbox.height * (2.0 / 3.0)
    return [bbox.x1 + 0.01, bbox.y0 + (bbox.height - h) / 2.0, 0.02, h]


# --- painters ----------------------------------------------------------------

def draw_scalebar(ax, img_w, img_h, bar_px, bar_um, lw=3, anchor="br",
                  font_size=10):
    """Paint a white scalebar + boxed label (kept for API compatibility;
    geometry comes from :func:`scalebar_spec`)."""
    spec = scalebar_spec(img_w, img_h, bar_um, bar_um / max(bar_px, 1), anchor)
    _paint_scalebar(ax, spec, lw=lw, font_size=font_size)


def _paint_scalebar(ax, spec: ScalebarSpec, lw=3, font_size=10):
    ax.plot([spec.x0, spec.x1], [spec.y, spec.y], color="w", linewidth=lw)
    ax.text((spec.x0 + spec.x1) / 2, spec.label_y, spec.label,
            color="w", ha="center", va=spec.label_va, fontsize=font_size,
            bbox=dict(facecolor="black", alpha=0.4, pad=1, edgecolor="none"))


def add_short_colorbar(fig, ax, vmin, vmax, cmap="jet", label="Intensity (a.u.)"):
    """White-on-black inset colorbar with endpoint-only ticks."""
    cb_ax = fig.add_axes(_inset_colorbar_rect(ax.get_position()))
    cb_ax.set_facecolor("black")
    sm = mpl.cm.ScalarMappable(
        norm=mpl.colors.Normalize(vmin=vmin, vmax=vmax),
        cmap=plt.get_cmap(cmap) if isinstance(cmap, str) else cmap,
    )
    cb = fig.colorbar(sm, cax=cb_ax, orientation="vertical")
    cb.set_label(label, rotation=90, color="w")
    cb.set_ticks([vmin, vmax])
    cb.ax.set_yticklabels([f"{vmin:.2f}", f"{vmax:.2f}"], color="w")
    cb.ax.tick_params(color="w", labelcolor="w", length=3)
    cb.outline.set_edgecolor("w")


_LUT_CACHE: dict = {}


def _cmap_lut_u8(cmap) -> np.ndarray:
    """(256, 4) uint8 LUT for a colormap.  Cached by name for STRING keys
    only: a Colormap instance may carry modified colors under a stale
    ``.name`` (``.copy()`` keeps it), so instances are sampled fresh each
    call — 256 samples, negligible next to the megapixel LUT gather."""
    if isinstance(cmap, str) and cmap in _LUT_CACHE:
        return _LUT_CACHE[cmap]
    cm_obj = plt.get_cmap(cmap) if isinstance(cmap, str) else cmap
    lut = (cm_obj(np.linspace(0.0, 1.0, 256)) * 255.0 + 0.5).astype(np.uint8)
    if isinstance(cmap, str):
        _LUT_CACHE[cmap] = lut
    return lut


def colormap_rgba_u8(img2d, cmap="jet", vmin=None, vmax=None, mask=None):
    """Matplotlib-equivalent scalar colormapping done in numpy (within one
    256-step LUT quantum of imshow's float64 pipeline, visually identical):
    normalize -> LUT index -> (H, W, 4) uint8.

    The savers feed this to ``imshow`` instead of a float image + cmap:
    mpl's per-draw float64 norm/LUT pass on megapixel frames is the
    measured hot spot of every image-output workload (docs/DESIGN.md),
    and a uint8 RGBA array passes through it untouched.  Non-finite pixels
    (QC'd saturation, ratio clips) and mask=False pixels get alpha 0 —
    exactly the set_bad(alpha=0) masked-imshow behavior, letting the
    savers' black background show through.
    """
    v = np.asarray(img2d, np.float32)
    fin = np.isfinite(v)
    if mask is not None:
        fin &= np.asarray(mask, bool)
    allfin = bool(fin.all())
    if not allfin:
        v = np.where(fin, v, 0.0)
    if vmin is None or vmax is None:
        vis = v[fin] if not allfin else v
        lo = float(vis.min()) if vis.size else 0.0
        hi = float(vis.max()) if vis.size else 1.0
        vmin = lo if vmin is None else float(vmin)
        vmax = hi if vmax is None else float(vmax)
    scale = 256.0 / (vmax - vmin) if vmax > vmin else 0.0
    # clip in FLOAT before the cast: a tiny display window with hot pixels
    # can push (v-vmin)*scale past 2^31, and float->int32 overflow lands on
    # INT32_MIN — the brightest pixels would clip to index 0 (vmin color)
    # instead of 255 (mpl clips to the top LUT entry)
    idx = np.clip((v - np.float32(vmin)) * np.float32(scale),
                  0.0, 255.0).astype(np.int32)
    out = _cmap_lut_u8(cmap)[idx]
    if not allfin:
        out[~fin] = 0
    return out


def save_png_colormap(
    img2d,
    out_path,
    vmin=None,
    vmax=None,
    cmap="jet",
    mask=None,
    scalebar_um=None,
    px_um=None,
    show_colorbar=False,
    dpi=300,
    out_px=None,
    cbar_label="Intensity (a.u.)",
    bar_anchor="br",
    bar_font=10,
):
    """Black-background borderless PNG with optional mask transparency,
    scalebar and inset colorbar (visual parity with Fluor_INT.py:642-675).

    Without a colorbar there is no text layout to do, and the whole figure
    is one letterboxed image + (optionally) a scalebar stamp — that case
    renders through the direct-PIL compositor (report.pilcomp), which is
    pixel-equal at identity scale (tests/test_pilcomp.py) and skips
    matplotlib's megapixel Agg draw entirely.  The colorbar path keeps
    matplotlib for its tick/label layout."""
    shown_arr = np.asarray(img2d)
    if not show_colorbar:
        from . import pilcomp

        rgba = colormap_rgba_u8(shown_arr, cmap, vmin, vmax, mask=mask)
        spec = None
        if scalebar_um is not None and px_um is not None and scalebar_um > 0:
            Hs, Ws = shown_arr.shape[:2]
            spec = scalebar_spec(Ws, Hs, scalebar_um, px_um, bar_anchor)
        pilcomp.save_borderless_png(rgba, out_path, dpi=dpi, out_px=out_px,
                                    scalebar_spec=spec, sb_font_pt=bar_font)
        return
    fig, ax = plt.subplots()
    ax.set_facecolor("black")
    fig.patch.set_facecolor("black")
    shown = np.asarray(img2d)
    ax.imshow(colormap_rgba_u8(shown, cmap, vmin, vmax, mask=mask))
    ax.set_axis_off()
    if scalebar_um is not None and px_um is not None and scalebar_um > 0:
        H, W = shown.shape[:2]
        _paint_scalebar(ax, scalebar_spec(W, H, scalebar_um, px_um, bar_anchor),
                        font_size=bar_font)
    if show_colorbar and vmin is not None and vmax is not None:
        add_short_colorbar(fig, ax, vmin, vmax, cmap=cmap, label=cbar_label)
    _fill_frame(fig, ax)
    if out_px:
        fig.set_size_inches(out_px[0] / dpi, out_px[1] / dpi)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path, dpi=dpi, facecolor=fig.get_facecolor(),
                **_PNG_KW)
    plt.close(fig)




def resolve_vminmax_txt(cmin_txt: str, cmax_txt: str, vals,
                        p_lo: float = 1.0, p_hi: float = 99.0):
    """Tolerant cmin/cmax resolution shared by the FRET and Nesprin2 crop
    exporters: malformed or missing text falls back to the percentile
    auto-range of *vals*, and an explicit-but-inverted pair keeps vmin and
    re-derives vmax (fret_ratio_builder.py:371-426 semantics).  The panel
    writer's PanelPngOptions.vminmax intentionally differs: it RAISES on
    malformed text (get_vminmax, Fluor_INT.py:956-966).

    *vals* may be an array or a ZERO-ARG CALLABLE returning one — callers
    pass a thunk so the per-ROI masked gather is skipped entirely when
    explicit valid cmin/cmax make the auto-range dead."""
    try:
        vmin = float(cmin_txt) if cmin_txt != "" else None
    except ValueError:
        vmin = None
    try:
        vmax = float(cmax_txt) if cmax_txt != "" else None
    except ValueError:
        vmax = None
    if vmin is None or vmax is None or vmax <= vmin:
        lo, hi = _auto_minmax_np(vals() if callable(vals) else vals,
                                 p_lo, p_hi)
        if vmin is None:
            vmin = lo
        if vmax is None or vmax <= vmin:
            vmax = hi
    return vmin, vmax


def save_png_image(img, out_path, dpi=300, out_px=None, scalebar_um=None,
                   px_um=None):
    """The cropper's normalized-view PNG writer: gray [0,1] for 2-D input,
    RGB for 3-D (src/roi_channel_cropper.py:321-345).  Borderless — always
    the direct-PIL compositor path."""
    from . import pilcomp

    if img.ndim == 2:
        rgba = colormap_rgba_u8(img, "gray", 0.0, 1.0)
    else:
        rgb = (np.clip(np.asarray(img, np.float32), 0, 1)
               * 255.0 + 0.5).astype(np.uint8)
        rgba = np.dstack([rgb, np.full(rgb.shape[:2], 255, np.uint8)])
    H, W = img.shape[:2]
    spec = None
    if scalebar_um is not None and px_um is not None:
        bar_px = int(round(float(scalebar_um) / float(px_um)))
        bar_px = max(2, min(bar_px, int(0.8 * W)))
        spec = scalebar_spec(W, H, bar_px * float(px_um),
                             float(px_um))
    pilcomp.save_borderless_png(rgba, out_path, dpi=dpi, out_px=out_px,
                                scalebar_spec=spec)


def save_png_gray(img2d, out_path, vmin=None, vmax=None, dpi=300, out_px=None):
    """Gray black-background PNG (fret_ratio_builder.py:371-380).
    Borderless — always the direct-PIL compositor path."""
    from . import pilcomp

    pilcomp.save_borderless_png(colormap_rgba_u8(img2d, "gray", vmin, vmax),
                                out_path, dpi=dpi, out_px=out_px)


def save_fret_images(stid, suffix, R_full, union, polys, cfg, dirs) -> None:
    """RAT 32/16-bit TIFs, RAT_ROI_masked variants, PNG full/crop for one
    FRET pair (fret_ratio_builder.py:478-549)."""
    H, W = R_full.shape

    def tif_pair(img, d32, d16):
        os.makedirs(dirs[d32], exist_ok=True)
        os.makedirs(dirs[d16], exist_ok=True)
        tiffio.write_tiff32(
            os.path.join(dirs[d32], f"{stid}_ratio_{suffix}.tif"), img
        )
        vals = img[np.isfinite(img)]
        out16 = os.path.join(dirs[d16], f"{stid}_ratio_{suffix}_preview.tif")
        if vals.size > 0:
            lo, hi = _auto_minmax_np(vals, 1.0, 99.0)
            tiffio.write_tiff16(out16, tiffio.normalize_to_u16(img, lo, hi))
        else:
            tiffio.write_tiff16(out16, np.zeros_like(img, dtype=np.uint16))

    if cfg.do_tif:
        tif_pair(R_full, "RAT32", "RAT16")

    if cfg.do_png and cfg.save_full:
        vals = R_full[np.isfinite(R_full)]
        lo, hi = _auto_minmax_np(vals, 1.0, 99.0)
        save_png_gray(
            R_full, os.path.join(dirs["PNG_FULL"], f"{stid}_ratio_{suffix}.png"),
            vmin=lo, vmax=hi, dpi=cfg.png_dpi,
        )

    if polys is None:
        return

    if cfg.do_tif and union is not None:
        R_roi = R_full.copy()
        R_roi[~union] = np.nan
        tif_pair(R_roi, "RROI32", "RROI16")

    if not (cfg.do_png and cfg.save_crop):
        return
    out_px = (cfg.crop_w, cfg.crop_h) if cfg.fixed_crop else None
    for i, P in enumerate(polys, 1):
        pts = np.asarray(P)
        x0, x1, y0, y1 = crop_bbox_poly(pts, W, H)
        crop = R_full[y0:y1 + 1, x0:x1 + 1]
        P2 = pts.copy()
        P2[:, 0] -= x0
        P2[:, 1] -= y0
        mask = rasterize_polygon_np(P2, crop.shape)
        out_path = os.path.join(dirs["PNG_CROP"], f"{stid}_roi{i}_{suffix}.png")
        if cfg.apply_cmap:
            vmin, vmax = resolve_vminmax_txt(cfg.cmin_txt, cfg.cmax_txt,
                                             lambda: crop[mask])
            save_png_colormap(
                crop, out_path, vmin=vmin, vmax=vmax, cmap=cfg.cmap_name,
                mask=mask if cfg.mask_outside else None,
                scalebar_um=cfg.scale_bar_um if cfg.add_scalebar else None,
                px_um=cfg.px_um, show_colorbar=cfg.show_colorbar,
                dpi=cfg.png_dpi, out_px=out_px, cbar_label="FRET ratio",
            )
        else:
            crop_vis = np.array(crop, copy=True)
            if cfg.mask_outside:
                crop_vis[~mask] = 0.0
            lo, hi = _auto_minmax_np(crop_vis[np.isfinite(crop_vis)], 1.0, 99.0)
            save_png_gray(crop_vis, out_path, vmin=lo, vmax=hi,
                          dpi=cfg.png_dpi, out_px=out_px)


def save_panel_intensity_ratio(int_img, ratio_img, rim, out_png, px_um,
                               add_scalebar=False, sb_um=5.0, cmap="turbo",
                               vmin=0.0, vmax=0.7, show_colorbar=True,
                               title_left="Intensity", title_right="FRET"):
    """2-up rim-masked intensity/ratio panel
    (Nesprin2_FRET_Builder.py:498-530)."""
    I = np.where(rim, int_img, np.nan)
    R = np.where(rim, ratio_img, np.nan)
    ivals = I[np.isfinite(I)]
    ilo, ihi = (np.percentile(ivals, 1), np.percentile(ivals, 99)) if ivals.size else (0.0, 1.0)
    fig, axes = plt.subplots(1, 2, figsize=(6, 3))
    axes[0].imshow(colormap_rgba_u8(I, "gray", ilo, ihi))
    axes[0].set_title(title_left)
    axes[0].axis("off")
    axes[1].imshow(colormap_rgba_u8(R, cmap, vmin, vmax))
    axes[1].set_title(title_right)
    axes[1].axis("off")
    H, W = R.shape
    if add_scalebar and px_um > 0:
        bar_px = max(2, min(int(round(sb_um / px_um)), int(0.8 * W)))
        for ax in axes:
            draw_scalebar(ax, W, H, bar_px, bar_px * px_um)
    if show_colorbar:
        sm = mpl.cm.ScalarMappable(
            norm=mpl.colors.Normalize(vmin=vmin, vmax=vmax),
            cmap=plt.get_cmap(cmap) if isinstance(cmap, str) else cmap,
        )
        cb = fig.colorbar(sm, ax=axes[1], fraction=0.046, pad=0.04)
        cb.set_label("FRET ratio")
    plt.tight_layout()
    os.makedirs(os.path.dirname(out_png) or ".", exist_ok=True)
    fig.savefig(out_png, dpi=300, **_PNG_KW)
    plt.close(fig)


def save_nesprin2_images(tag, suffix, R_full, rim, I, polys, cfg, dirs, eps,
                         ann_bgs=None, numer=None, denom=None) -> None:
    """Nesprin2 TIF32 full+rim, full/crop/panel PNGs
    (Nesprin2_FRET_Builder.py:1585-1731)."""
    H, W = R_full.shape

    if cfg.do_tif:
        for d in ("tif32_full", "tif32_rim"):
            os.makedirs(dirs[d], exist_ok=True)
        tiffio.write_tiff32(
            os.path.join(dirs["tif32_full"], f"{tag}_ratio_full_{suffix}.tif"),
            R_full,
        )
        tiffio.write_tiff32(
            os.path.join(dirs["tif32_rim"], f"{tag}_ratio_rim_{suffix}.tif"),
            np.where(rim, R_full, np.nan),
        )

    if not cfg.do_png:
        return

    if cfg.save_full:
        vals = R_full[np.isfinite(R_full)]
        lo, hi = _auto_minmax_np(vals, 1.0, 99.0)
        save_png_gray(
            R_full,
            os.path.join(dirs["png_full_ratio"], f"{tag}_ratio_full_{suffix}.png"),
            vmin=lo, vmax=hi, dpi=300,
        )
        ivals = I[np.isfinite(I)]
        ilo, ihi = ((np.percentile(ivals, 1), np.percentile(ivals, 99))
                    if ivals.size else (0.0, 1.0))
        save_png_gray(
            I, os.path.join(dirs["png_full_int"], f"{tag}_INT_full.png"),
            vmin=ilo, vmax=ihi, dpi=300,
        )

    if cfg.save_panel:
        save_panel_intensity_ratio(
            I, R_full, rim,
            os.path.join(dirs["png_panel"], f"{tag}_panel_{suffix}.png"),
            px_um=cfg.px_um, add_scalebar=cfg.add_scalebar,
            sb_um=cfg.scale_bar_um, cmap=cfg.cmap_name,
            vmin=cfg.fret_min, vmax=cfg.fret_max,
            show_colorbar=cfg.show_colorbar,
        )

    if not cfg.save_crop:
        return
    out_px = (cfg.crop_w, cfg.crop_h) if cfg.crop_fixed else None
    for i, P in enumerate(polys, 1):
        pts = np.asarray(P)
        x0, x1, y0, y1 = crop_bbox_poly(pts, W, H)

        if ann_bgs is not None:
            # rebuild the annulus-corrected per-ROI ratio on the crop only
            bg_n, bg_d = float(ann_bgs[0][i - 1]), float(ann_bgs[1][i - 1])
            nc = numer[y0:y1 + 1, x0:x1 + 1] - bg_n
            dc = denom[y0:y1 + 1, x0:x1 + 1] - bg_d
            if cfg.clip_neg:
                nc = np.maximum(nc, 0.0)
                dc = np.maximum(dc, 0.0)
            cropR = (nc + eps) / (dc + eps)
            if cfg.clip_ratio_on:
                cropR = np.where(cropR > cfg.clip_ratio_max, np.nan, cropR)
        else:
            cropR = R_full[y0:y1 + 1, x0:x1 + 1]
        cropI = I[y0:y1 + 1, x0:x1 + 1]

        P2 = pts.copy()
        P2[:, 0] -= x0
        P2[:, 1] -= y0
        crop_roi_full = rasterize_polygon_np(P2, cropR.shape)
        crop_rim = crop_roi_full & rim[y0:y1 + 1, x0:x1 + 1]

        vmin, vmax = resolve_vminmax_txt(
            cfg.crop_vmin_txt, cfg.crop_vmax_txt,
            lambda: cropR[crop_rim] if crop_rim.any() else cropR)

        save_png_colormap(
            cropR,
            os.path.join(dirs["png_crop_ratio"], f"{tag}_roi{i}_{suffix}_rim.png"),
            vmin=vmin, vmax=vmax, cmap=cfg.cmap_name, mask=crop_rim,
            scalebar_um=cfg.scale_bar_um if cfg.add_scalebar else None,
            px_um=cfg.px_um, show_colorbar=cfg.show_colorbar,
            dpi=300, out_px=out_px, cbar_label="FRET ratio",
        )

        ivals = cropI[np.isfinite(cropI)]
        ilo, ihi = ((np.percentile(ivals, 1), np.percentile(ivals, 99))
                    if ivals.size else (0.0, 1.0))
        save_png_gray(
            cropI,
            os.path.join(dirs["png_crop_int_no"], f"{tag}_roi{i}_INT_crop_full.png"),
            vmin=ilo, vmax=ihi, dpi=300, out_px=out_px,
        )
        if cfg.save_crop_intensity:
            I_vis = np.array(cropI, copy=True)
            I_vis[~crop_rim] = np.nan
            iv2 = I_vis[np.isfinite(I_vis)]
            ilo2, ihi2 = ((np.percentile(iv2, 1), np.percentile(iv2, 99))
                          if iv2.size else (0.0, 1.0))
            save_png_gray(
                I_vis,
                os.path.join(dirs["png_crop_int_r"], f"{tag}_roi{i}_INT_rim.png"),
                vmin=ilo2, vmax=ihi2, dpi=300, out_px=out_px,
            )


def save_fa_crop_colormap(img_crop, mask, roi_poly_crop, out_path,
                          cmap_name="jet", show_cbar=True,
                          vmin=None, vmax=None, sb_on=False, sb_len_um=20,
                          sb_text=True, sb_font=10, px_size=0.112,
                          out_w=500, out_h=500, out_dpi=600,
                          roi_lw=0.5, roi_color="gray"):
    """FA crop export: FA-mask-only colormap view with dashed ROI outline
    and inset colorbar (FA_Analyzer.py:213-264)."""
    fig = plt.figure(figsize=(out_w / out_dpi, out_h / out_dpi), dpi=out_dpi)
    fig.patch.set_facecolor("black")
    ax = fig.add_axes([0, 0, 1, 1])
    ax.set_facecolor("black")
    if vmin is None or vmax is None:
        valid = img_crop[mask]
        alo, ahi = ((np.percentile(valid, 1), np.percentile(valid, 99))
                    if valid.size else (0, 1))
        vmin = alo if vmin is None else vmin
        vmax = ahi if vmax is None else vmax
    low = cmap_name.lower()
    if low in ("blue", "cyan", "green", "yellow", "red", "magenta"):
        cmap = LinearSegmentedColormap.from_list(f"custom_{low}", ["black", low])
    elif low == "grayscale":
        cmap = plt.get_cmap("gray").copy()
    else:
        try:
            cmap = plt.get_cmap(cmap_name).copy()
        except ValueError:
            cmap = plt.get_cmap("jet").copy()
    cmap.set_bad(color="black")
    # masked-out pixels get alpha 0 over the black facecolor — identical
    # composite to the set_bad(black) masked-array draw, minus the float64
    # per-draw colormap pass
    ax.imshow(colormap_rgba_u8(img_crop, cmap, vmin, vmax, mask=mask),
              aspect="equal")
    P = np.asarray(roi_poly_crop)
    ax.plot(P[:, 0], P[:, 1], linestyle="--", linewidth=roi_lw,
            color=roi_color, alpha=0.8)
    if sb_on and px_size > 0:
        bar_px = sb_len_um / px_size
        h, w = img_crop.shape
        if bar_px < w:
            mx, my = int(w * 0.05), int(h * 0.05)
            x_end = w - mx
            ax.plot([x_end - bar_px, x_end], [h - my, h - my], color="white",
                    linewidth=3)
            if sb_text:
                ax.text(x_end - bar_px / 2, h - my - max(10, int(0.02 * h)),
                        f"{int(sb_len_um)} µm", color="white", ha="center",
                        va="bottom", fontsize=sb_font, fontweight="bold")
    ax.axis("off")
    if show_cbar:
        from mpl_toolkits.axes_grid1.inset_locator import inset_axes

        cax = inset_axes(ax, width="3%", height="40%", loc="center right",
                         borderpad=1)
        sm = mpl.cm.ScalarMappable(
            norm=mpl.colors.Normalize(vmin=vmin, vmax=vmax), cmap=cmap)
        cbar = plt.colorbar(sm, cax=cax, orientation="vertical")
        cbar.ax.yaxis.set_tick_params(color="white", labelcolor="white",
                                      labelsize=8)
        cbar.outline.set_edgecolor("white")
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path, facecolor="black", edgecolor="none", dpi=out_dpi,
                **_PNG_KW)
    plt.close(fig)


def save_morphology_images(img, polys, mets, tag, cfg,
                           png_full_dir, png_crop_dir) -> None:
    """MOR_by_ROI overlay PNGs: full frame with numbered cyan outlines +
    per-ROI crops with title metrics (src/MOR_by_ROI.py:436-505).

    Rendered through the direct-PIL compositor: the megapixel overlay and
    the per-cell crop figures were the measured wall of the image-output
    morphology workload (2.12 s/stage with matplotlib doing the draws,
    docs/DESIGN.md), and every element here — gray LUT image, polygon
    outlines, numbered labels, title strip, scalebar — is a flat stamp
    with no layout dependencies."""
    from . import pilcomp

    H, W = img.shape
    if cfg.save_full:
        # matplotlib-era geometry: figsize (8, 8*H/W) at dpi 200
        rgba = colormap_rgba_u8(img, "gray")
        canvas, box = pilcomp.compose_borderless(
            rgba, (1600, int(round(1600 * H / W))), dpi=200)
        for i, poly in enumerate(polys, 1):
            P = np.asarray(poly)
            pilcomp.stamp_polyline(canvas, box, W, H, P, dpi=200)
            pilcomp.stamp_text(canvas, box, W, H,
                               (float(P[:, 0].mean()), float(P[:, 1].mean())),
                               str(i), font_pt=10, dpi=200,
                               box_rgba=(0, 0, 0, 77))  # black alpha 0.3
        pilcomp.save_canvas_png(canvas, os.path.join(
            png_full_dir, f"{tag}_overlay_ch{cfg.sel_ch}.png"))

    if not cfg.save_crop:
        return
    os.makedirs(png_crop_dir, exist_ok=True)
    for i, (poly, met) in enumerate(zip(polys, mets), 1):
        P = np.asarray(poly)
        x0, x1, y0, y1 = crop_bbox_poly(P, W, H)
        crop = img[y0:y1 + 1, x0:x1 + 1]
        P2 = P.copy()
        P2[:, 0] -= x0
        P2[:, 1] -= y0
        if cfg.mask_outside:
            crop = crop * rasterize_polygon_np(P2, crop.shape).astype(crop.dtype)
        ch_, cw_ = crop.shape
        title = (f"{tag}  ROI#{i}  ch{cfg.sel_ch}  "
                 f"AR={met['aspect_ratio']:.2f}  "
                 f"Circ={met['circularity']:.3f}")
        # matplotlib-era geometry: figsize (5, 5*h/w) at dpi 220; by
        # default small crops cap at 2x blow-up (MorConfig.mpl_canvas)
        canvas, box = pilcomp.compose_titled(
            colormap_rgba_u8(crop, "gray"), 1100, title, font_pt=9, dpi=220,
            max_upscale=None if getattr(cfg, "mpl_canvas", False) else 2.0)
        pilcomp.stamp_polyline(canvas, box, cw_, ch_, P2, dpi=220)
        if cfg.add_scalebar and cfg.scale_bar_um is not None:
            bar_px = int(round(float(cfg.scale_bar_um) / cfg.px_um))
            max_bar = int(0.8 * cw_)
            if bar_px > max_bar and max_bar > 1:
                bar_px = max_bar
            bar_px = max(bar_px, 2)
            spec = scalebar_spec(cw_, ch_, bar_px * cfg.px_um, cfg.px_um)
            pilcomp.stamp_scalebar(canvas, box, cw_, ch_, spec, dpi=220)
        pilcomp.save_canvas_png(canvas, os.path.join(
            png_crop_dir, f"{tag}_roi{i}_ch{cfg.sel_ch}.png"))


def save_intensity_images(extras: dict, cfg, out_root: str) -> None:
    """TIF32 + TIF16-preview + PNG full/crop exports for one (stage, time)
    key (worker block Fluor_INT.py:917-1135)."""
    stid = extras["stid"]
    chs: Sequence[int] = extras["chs"]
    imgs_bc = extras.get("imgs_bc")
    if imgs_bc is None:
        imgs_bc = np.asarray(extras["imgs_bc_dev"])
    polys = extras["polys"]
    union_mask = extras["union_mask"]
    H, W = extras["shape"]

    if polys is not None:
        union = np.zeros((H, W), bool)
        for P in polys:
            union |= rasterize_polygon_np(P, (H, W))
    elif union_mask is not None:
        union = np.asarray(union_mask, bool)
    else:
        union = None

    tif32_dir = os.path.join(out_root, "TIFF")
    tif16_dir = os.path.join(out_root, "TIFF16")
    png_root = os.path.join(out_root, "PNG")

    if cfg.do_tif:
        os.makedirs(tif32_dir, exist_ok=True)
        os.makedirs(tif16_dir, exist_ok=True)
        for ci, ch in enumerate(chs):
            bc = imgs_bc[ci]
            img_to_save = bc
            if cfg.tif_mask_outside and union is not None:
                img_to_save = np.where(union, bc, 0.0).astype(np.float32)
            tiffio.write_tiff32(
                os.path.join(tif32_dir, f"{stid}_ch{ch}_bgcorr.tif"), img_to_save
            )
            vals = img_to_save[np.isfinite(img_to_save)]
            if vals.size > 0:
                lo, hi = _auto_minmax_np(vals, cfg.auto_lo, cfg.auto_hi)
                tiffio.write_tiff16(
                    os.path.join(tif16_dir, f"{stid}_ch{ch}_bgcorr_preview.tif"),
                    tiffio.normalize_to_u16(img_to_save, lo, hi),
                )

    if not cfg.do_png:
        return

    full_opt: PanelPngOptions = cfg.png_full
    crop_opt: PanelPngOptions = cfg.png_crop
    for ci, ch in enumerate(chs):
        bc = imgs_bc[ci]
        vals = bc[np.isfinite(bc)]
        color = cfg.channel_colors.get(ch, "Grayscale")

        if full_opt.enabled:
            cmap_full = full_opt.cmap if full_opt.cmap_on else get_cmap_for_color(color)
            vmin, vmax = full_opt.vminmax(vals, cfg.auto_lo, cfg.auto_hi)
            save_png_colormap(
                bc,
                os.path.join(png_root, "full", f"ch{ch}", f"{stid}_ch{ch}.png"),
                vmin=vmin, vmax=vmax, cmap=cmap_full,
                mask=union if full_opt.mask_outside else None,
                scalebar_um=full_opt.scalebar_um, px_um=cfg.px_um,
                show_colorbar=bool(full_opt.colorbar and full_opt.cmap_on),
                dpi=full_opt.dpi, cbar_label=f"ch{ch} Intensity",
                bar_anchor=full_opt.sb_anchor, bar_font=full_opt.sb_font,
            )

        if crop_opt.enabled and (polys is not None or union is not None):
            cmap_crop = crop_opt.cmap if crop_opt.cmap_on else get_cmap_for_color(color)
            crop_dir = os.path.join(png_root, "crop", f"ch{ch}")
            items = []
            if polys is not None:
                roi_list = list(range(1, len(polys) + 1))
                subset_roi = getattr(cfg, "subset_roi", None)
                if subset_roi is not None:
                    roi_list = ([int(subset_roi)]
                                if 1 <= int(subset_roi) <= len(polys) else [])
                for i in roi_list:
                    items.append((i, np.asarray(polys[i - 1]), None))
            else:
                ys, xs = np.where(union)
                if ys.size:
                    items.append((1, None, (ys, xs)))
            for i, P, coords in items:
                if P is not None:
                    minx, maxx = P[:, 0].min(), P[:, 0].max()
                    miny, maxy = P[:, 1].min(), P[:, 1].max()
                else:
                    ys, xs = coords
                    minx, maxx, miny, maxy = xs.min(), xs.max(), ys.min(), ys.max()
                x0, x1, y0, y1 = crop_bbox(minx, maxx, miny, maxy, W, H)
                if P is not None:
                    P2 = P.copy()
                    P2[:, 0] -= x0
                    P2[:, 1] -= y0
                    local_mask = rasterize_polygon_np(P2, (y1 - y0 + 1, x1 - x0 + 1))
                else:
                    local_mask = union[y0:y1 + 1, x0:x1 + 1]
                crop = bc[y0:y1 + 1, x0:x1 + 1]
                use_vals = crop[local_mask] if crop_opt.mask_outside else crop[np.isfinite(crop)]
                vmin, vmax = crop_opt.vminmax(use_vals, cfg.auto_lo, cfg.auto_hi)
                out_px = (cfg.crop_size, cfg.crop_size) if cfg.fixed_crop else None
                save_png_colormap(
                    crop,
                    os.path.join(crop_dir, f"{stid}_roi{i}_ch{ch}.png"),
                    vmin=vmin, vmax=vmax, cmap=cmap_crop,
                    mask=local_mask if crop_opt.mask_outside else None,
                    scalebar_um=crop_opt.scalebar_um, px_um=cfg.px_um,
                    show_colorbar=bool(crop_opt.colorbar and crop_opt.cmap_on),
                    dpi=crop_opt.dpi, out_px=out_px,
                    cbar_label=f"ch{ch} Intensity",
                    bar_anchor=crop_opt.sb_anchor, bar_font=crop_opt.sb_font,
                )
                # raw-value crop TIFF (worker block Fluor_INT.py:1078-1089)
                if getattr(cfg, "save_raw_crop_tif", False) and \
                        extras.get("imgs_raw") is not None and P is not None:
                    raw = np.asarray(extras["imgs_raw"][ci])
                    os.makedirs(tif32_dir, exist_ok=True)
                    tiffio.write_tiff32(
                        os.path.join(tif32_dir,
                                     f"{stid}_roi{i}_ch{ch}_raw.tif"),
                        raw[y0:y1 + 1, x0:x1 + 1].astype(np.float32),
                    )

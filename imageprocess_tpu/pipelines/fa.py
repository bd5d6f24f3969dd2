"""Focal-adhesion detection & quantification pipeline (the reference's
FA_Analyzer batch path).

Reference semantics: src/INT/FA_Analyzer.py — core ``analyze_fa_crop``
(:123-195: threshold mu+alpha*sigma over the WHOLE image, remove_small
(4-conn), binary_closing(disk), 8-conn label, regionprops, area
classification OK/Large/Small, mean_corr = max(0, mean_raw - bg)), global
stats with bg from a ``[::10, ::10]`` subsample (:624-626, 985-987), batch
loop ``_run_batch_process`` (:939-1052), merge report (:1054-1113), crop
export (:213-264, 1119-1279).

Device design: one jitted program per image computes the global stats and,
vmapped over ROI bbox tiles, the full segmentation chain (threshold, CCL,
morphology, region reductions).  Contour tracing for figures runs on host
per detected FA.  Numerics note: the reference runs morphology inside a
bbox+5 crop; our tile is larger, which is identical for closing radii <= 5
(the pad) since the skimage border-True erosion rule only differs at crop
edges.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from functools import partial
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd

from ..core import roiio, tiffio
from ..core.i18n import t
from ..geom.rasterize import EdgeRule, rasterize_polygons
from ..morphology.binary import binary_closing_skimage, disk
from ..morphology.ccl import label
from ..morphology.regions import region_props
from ..ops.percentile import masked_quantile
from .intensity import _bucket

FA_CSV_COLS = ["File", "Cell_ID", "Category", "Area_px", "Area_um2",
               "Mean_Intensity_Raw", "Mean_Intensity_Corr",
               "Int_Density_Raw", "Int_Density_Corr", "Background_Level",
               "Used_Alpha", "Global_Threshold", "Min_Area_Setting",
               "Max_Area_Setting", "Close_Radius_Setting",
               "Subtract_BG_Setting"]


@dataclass
class FaConfig:
    channel: int = 0
    px_size: float = 0.112          # µm/px (presets 0.112 / 0.223)
    alpha: float = 3.0
    min_area_um: float = 1.5
    max_area_um: float = 30.0
    close_radius: int = 1
    subtract_bg: bool = True
    save_ok_only: bool = False
    max_fa_per_cell: int = 256      # static bound for the device label pass
    do_master_report: bool = True
    master_name: str = "FA_Results_Master.xlsx"

    @property
    def min_px(self) -> float:
        return self.min_area_um / self.px_size ** 2

    @property
    def max_px(self) -> float:
        return self.max_area_um / self.px_size ** 2


def _global_stats_body(img: jnp.ndarray):
    """(nanmean, nanstd ddof=0, bg = p1 of img[::10, ::10])
    — FA_Analyzer.py:624-626.  Trace-level body shared by the per-image
    jit and the batched multi-frame program."""
    img = img.astype(jnp.float32)  # compact u16 upload, f32 on-chip
    finite = jnp.isfinite(img)
    n = jnp.maximum(finite.sum().astype(jnp.float32), 1.0)
    x = jnp.where(finite, img, 0.0)
    m = x.sum() / n
    var = (jnp.where(finite, (img - m) ** 2, 0.0)).sum() / n
    H, W = img.shape
    rows = jax.lax.broadcasted_iota(jnp.int32, (H, W), 0)
    cols = jax.lax.broadcasted_iota(jnp.int32, (H, W), 1)
    sample = (rows % 10 == 0) & (cols % 10 == 0)
    bg = masked_quantile(jnp.where(jnp.isfinite(img), img, jnp.inf),
                         sample & finite, 1000)
    return m, jnp.sqrt(var), bg


fa_global_stats = jax.jit(_global_stats_body)


def _fa_cells_body(
    img, local_polys, offsets, roi_valid, threshold, min_px,
    *, tile: int, close_radius: int, max_labels: int, do_remove_small: bool,
):
    """Per-cell FA segmentation + region reductions on bbox tiles
    (trace-level body shared by the per-image jit and the batched step).

    ROI masks use the matplotlib edge rule — the committed golden drawer
    mask shows skimage.draw.polygon (FA_Analyzer.py:1016-1018) agrees with
    it pixel-exactly on contour-derived vertices.  Returns per-cell label
    images and region properties arrays (area/sum/mean/bbox/centroid)."""
    masks = rasterize_polygons(local_polys, (tile, tile), EdgeRule.MPL)
    masks = masks & roi_valid[:, None, None]
    se = disk(close_radius) if close_radius > 0 else None

    from ..morphology.ccl import label_roots, _root_sizes

    def per_cell(mask_i, off):
        t = jax.lax.dynamic_slice(img, (off[0], off[1]), (tile, tile)).astype(
            jnp.float32)
        bw = (t > threshold) & mask_i
        if do_remove_small:
            # remove_small_objects with a traced float min_size
            roots = label_roots(bw, 1)
            sizes = _root_sizes(roots)
            keep = sizes[roots.ravel()].reshape(bw.shape).astype(jnp.float32) >= min_px
            bw = bw & keep
        if se is not None:
            bw = binary_closing_skimage(bw, se)
        # with_overflow: a cell with > max_labels FAs would alias label
        # slots and emit wrong area/mean rows — surface it instead
        lab, over = label(bw, connectivity=2, max_labels=max_labels,
                          with_overflow=True)
        props = region_props(lab, t, max_labels=max_labels)
        return lab, props, over

    return jax.vmap(per_cell)(masks, offsets)


fa_analyze_tiled = partial(jax.jit, static_argnames=(
    "tile", "close_radius", "max_labels", "do_remove_small"))(_fa_cells_body)


# per-FA property fields packed for the batched single-fetch result
_FA_PACK_FIELDS = ("area", "mean", "centroid_r", "centroid_c")


@partial(jax.jit, static_argnames=("tile", "close_radius", "max_labels",
                                   "do_remove_small"))
def fa_batched_step(
    imgs: jnp.ndarray,           # (B, H, W) raw dtype (u16 uploads compact)
    local_polys: jnp.ndarray,    # (B, N, V, 2) tile-local
    offsets: jnp.ndarray,        # (B, N, 2)
    roi_valid: jnp.ndarray,      # (B, N)
    alpha: jnp.ndarray,          # () float32
    min_px: jnp.ndarray,         # () float32
    *,
    tile: int,
    close_radius: int,
    max_labels: int,
    do_remove_small: bool,
):
    """A chunk of FA frames in ONE dispatch: per-image global stats
    (mu/sigma/bg, FA_Analyzer.py:624-626), threshold mu+alpha*sigma, and
    the per-cell segmentation chain — fused so the streaming runner pays a
    single device round trip per chunk.  Cell label images stay on device
    (the tables path never needs them); the result is one flat (B, K)
    array: the 4 packed per-FA property fields + n_labels, then the 4
    per-image scalars (mu, sigma, bg, threshold)."""
    B = imgs.shape[0]

    def one(img, lp, off, val):
        m, s, bg = _global_stats_body(img)
        thr = m + alpha * s
        _, props, over = _fa_cells_body(
            img, lp, off, val, thr, min_px, tile=tile,
            close_radius=close_radius, max_labels=max_labels,
            do_remove_small=do_remove_small)
        pack = jnp.stack([props[f].astype(jnp.float32)
                          for f in _FA_PACK_FIELDS]
                         + [jnp.broadcast_to(
                             props["n_labels"].astype(jnp.float32)[:, None],
                             props["area"].shape)], axis=0)
        # trailing per-image flag: any cell's FA count overflowed
        # max_labels (label slots would alias -> wrong rows)
        return pack, jnp.stack([m, s, bg, thr]), over.any()

    pack, scal, over = jax.vmap(one)(imgs, local_polys, offsets, roi_valid)
    return jnp.concatenate(
        [pack.reshape(B, -1), scal, over.astype(jnp.float32)[:, None]],
        axis=1)


def unpack_fa_flat(flat: np.ndarray, nb: int, max_labels: int):
    """Split :func:`fa_batched_step`'s flat result back into
    ({field: (B, N, L)}, n_labels (B, N) int, scalars (B, 4),
    overflow (B,) bool — True where a cell's FA count exceeded
    max_labels and the packed rows would alias)."""
    B = flat.shape[0]
    nf = len(_FA_PACK_FIELDS) + 1
    pack = flat[:, :nf * nb * max_labels].reshape(B, nf, nb, max_labels)
    scal = flat[:, -5:-1]
    over = flat[:, -1] > 0.0
    props = {f: pack[:, k] for k, f in enumerate(_FA_PACK_FIELDS)}
    n_labels = pack[:, nf - 1, :, 0].astype(np.int32)
    return props, n_labels, scal, over


def analyze_image(
    img: np.ndarray,
    rois: List[np.ndarray],
    cfg: FaConfig,
    stats: Optional[Tuple[float, float, float]] = None,
) -> Tuple[List[dict], float, float, Dict]:
    """All FA rows for one image (batch semantics, global settings).
    Returns (raw per-FA dicts, threshold, bg, extras for rendering)."""
    from ..ops.roistats import choose_tile, tile_offsets, pad_local_polys

    H, W = img.shape
    imgj = jnp.asarray(img)  # dtype preserved; device casts on-chip
    if stats is None:
        m, s, bg = (float(v) for v in fa_global_stats(imgj))
    else:
        m, s, bg = stats
    threshold = m + cfg.alpha * s

    if not rois:
        return [], threshold, bg, {}

    margin = cfg.close_radius + 1
    tile = choose_tile(rois, H, W, margin=margin)
    if tile is None:
        # pathological ROI larger than the short frame side: use the biggest
        # square tile that fits (clips nothing for real cell-sized ROIs)
        tile = min(H, W)
    offs = tile_offsets(rois, H, W, tile, margin=margin)
    nb = _bucket(len(rois))
    vb = _bucket(max(len(p) for p in rois), 32)
    lpv, offs_pad, valid = pad_local_polys(rois, offs, nb, vb)

    labs, props, over = fa_analyze_tiled(
        imgj, jnp.asarray(lpv), jnp.asarray(offs_pad), jnp.asarray(valid),
        jnp.float32(threshold), jnp.float32(cfg.min_px),
        tile=tile, close_radius=int(cfg.close_radius),
        max_labels=cfg.max_fa_per_cell,
        do_remove_small=cfg.min_px > 0,
    )
    if bool(np.asarray(over).any()):
        raise ValueError(
            f"a cell contains more than max_fa_per_cell="
            f"{cfg.max_fa_per_cell} focal adhesions — label slots would "
            "alias and the report rows would be wrong; re-run with a "
            "larger --max-fa-per-cell")
    labs = np.asarray(labs)
    props = {k: np.asarray(v) for k, v in props.items()}

    fa_rows: List[dict] = []
    for i in range(len(rois)):
        n = int(props["n_labels"][i])
        for r in range(n):
            area = float(props["area"][i, r])
            mean_raw = float(props["mean"][i, r])
            category = "OK"
            if area < cfg.min_px:
                category = "Small"
            elif area > cfg.max_px:
                category = "Large"
            mean_corr = max(0.0, mean_raw - bg) if cfg.subtract_bg else mean_raw
            fa_rows.append({
                "cell": i + 1,
                "label": r + 1,
                "category": category,
                "area": area,
                "mean_int_raw": mean_raw,
                "mean_int_corr": mean_corr,
                "int_den_raw": mean_raw * area,
                "int_den_corr": mean_corr * area,
                "bg_level": bg,
                "centroid": (float(props["centroid_r"][i, r]) + offs[i, 0],
                             float(props["centroid_c"][i, r]) + offs[i, 1]),
            })
    extras = {"labels": labs, "offsets": offs, "tile": tile}
    return fa_rows, threshold, bg, extras


def _load_rois(json_path: str) -> List[np.ndarray]:
    """FA's permissive ROI JSON reader (FA_Analyzer.py:650-658)."""
    data = roiio.load_roi_bundle(json_path)
    rois = []
    for item in data.get("rois", []):
        pts = item if isinstance(item, list) else item.get("rois", item)
        if pts:
            rois.append(np.array(pts))
    return rois


def list_fa_pairs(img_dir: str, roi_dir: str, channel: int):
    """(img_path, json_path, s_tag) triples: plain-sorted ``*.tif`` filtered
    by ``_{ch}.tif`` substring, s_tag = first ``_`` token, JSON must exist
    (FA_Analyzer.py:544-564)."""
    import glob as _glob

    out = []
    for img_path in sorted(_glob.glob(os.path.join(img_dir, "*.tif"))) + \
            sorted(_glob.glob(os.path.join(img_dir, "*.TIF"))):
        fname = os.path.basename(img_path)
        if f"_{channel}.tif" in fname or f"_{channel}.TIF" in fname:
            s_tag = fname.split("_")[0]
            json_path = os.path.join(roi_dir, f"{s_tag}.json")
            if os.path.exists(json_path):
                out.append((img_path, json_path, s_tag))
    return out


def run_fa_batch(
    img_dir: str,
    roi_dir: str,
    out_root: str,
    cfg: FaConfig,
    log=print,
    cancel=None,
) -> Dict[str, pd.DataFrame]:
    """Batch process (FA_Analyzer.py:939-1052): per-stage CSVs under
    ``individual_results/`` + optional master report."""
    indiv_dir = os.path.join(out_root, "individual_results")
    os.makedirs(indiv_dir, exist_ok=True)
    pairs = list_fa_pairs(img_dir, roi_dir, cfg.channel)
    results: Dict[str, pd.DataFrame] = {}
    for img_path, json_path, s_tag in pairs:
        if cancel is not None and cancel():
            log(t("cancelled"))
            break
        log(t("fa_processing").format(tag=s_tag))
        # per-file isolation: one unreadable TIFF/JSON logs and continues
        # — the reference's load_image_safe-is-None branch
        # (FA_Analyzer.py:978-981); the batched runner isolates the same
        # way via LoadError
        try:
            img = tiffio.read_2d(img_path, squeeze="smallest_axis")
            rois = _load_rois(json_path)
        except Exception as e:
            log(t("fa_load_failed").format(tag=s_tag, err=e))
            continue
        fa_rows, th_val, bg, _ = analyze_image(img, rois, cfg)
        file_rows = _fa_file_rows(
            s_tag, ((fa["cell"], fa["area"], fa["mean_int_raw"])
                    for fa in fa_rows), th_val, bg, cfg)
        if file_rows:
            df = pd.DataFrame(file_rows)[FA_CSV_COLS]
            df.to_csv(os.path.join(indiv_dir, f"{s_tag}_results.csv"),
                      index=False)
            results[s_tag] = df
    if cfg.do_master_report and results:
        merge_fa_report(out_root, cfg.master_name, log=log)
    return results


def _fa_file_rows(s_tag: str, fa_iter, th_val: float, bg: float,
                  cfg: FaConfig) -> List[dict]:
    """CSV-schema rows for one stage from per-FA (cell, area, mean_raw)
    tuples (category is recomputed from the config's area thresholds) —
    shared by the serial and batched runners."""
    rows = []
    for cell, area, mean_raw in fa_iter:
        category = "OK"
        if area < cfg.min_px:
            category = "Small"
        elif area > cfg.max_px:
            category = "Large"
        if cfg.save_ok_only and category != "OK":
            continue
        mean_corr = max(0.0, mean_raw - bg) if cfg.subtract_bg else mean_raw
        rows.append({
            "File": s_tag,
            "Cell_ID": cell,
            "Category": category,
            "Area_px": area,
            "Area_um2": area * cfg.px_size ** 2,
            "Mean_Intensity_Raw": mean_raw,
            "Mean_Intensity_Corr": mean_corr,
            "Int_Density_Raw": mean_raw * area,
            "Int_Density_Corr": mean_corr * area,
            "Background_Level": bg,
            "Used_Alpha": cfg.alpha,
            "Global_Threshold": th_val,
            "Min_Area_Setting": cfg.min_area_um,
            "Max_Area_Setting": cfg.max_area_um,
            "Close_Radius_Setting": cfg.close_radius,
            "Subtract_BG_Setting": cfg.subtract_bg,
        })
    return rows


def run_fa_batched(
    img_dir: str,
    roi_dir: str,
    out_root: str,
    cfg: FaConfig,
    log=print,
    batch_size: int = 4,
    mesh=None,
    prefetch_workers: int = 8,
    cancel=None,
) -> Dict[str, pd.DataFrame]:
    """Streaming batched FA tables (same outputs as :func:`run_fa_batch`):
    prefetch-thread decode overlaps device compute, frames chunk into ONE
    fused dispatch (global stats + threshold + per-cell chain,
    :func:`fa_batched_step`), optionally split over a ``Mesh``'s devices
    — the device replacement for the reference's serial batch loop
    (FA_Analyzer.py:939-1052).  Stages whose frame shape or ROI geometry
    falls outside the session hints drop to the per-image path inline."""
    from ..ops.roistats import choose_tile, pad_local_polys, tile_offsets
    from ..parallel.runner import (
        EmitFetchError, PrefetchLoader, per_device, round_batch_to_mesh,
        stream_batches,
    )

    indiv_dir = os.path.join(out_root, "individual_results")
    os.makedirs(indiv_dir, exist_ok=True)
    pairs = list_fa_pairs(img_dir, roi_dir, cfg.channel)
    results: Dict[str, pd.DataFrame] = {}
    margin = cfg.close_radius + 1

    from ..native import FrameBufferPool, decode_tiff_batch_hist

    frame_pool = FrameBufferPool()

    def _load(pair):
        img_path, json_path, s_tag = pair
        res = decode_tiff_batch_hist([img_path], 0, pool=frame_pool)
        if res is not None and res[0].ndim == 3:
            img = res[0][0]  # (1, H, W) view; base recycled in finalize
        else:
            img = tiffio.read_2d(img_path, dtype=None,
                                 squeeze="smallest_axis")
        return s_tag, img, _load_rois(json_path)

    loader = PrefetchLoader(_load, pairs, workers=max(1, prefetch_workers))

    batch_size = round_batch_to_mesh(batch_size, mesh)

    hint: Dict[str, int] = {}
    step_cache: Dict[tuple, object] = {}

    def step_for(tile, nb, vb):
        key = (tile, nb, vb)
        if key not in step_cache:
            step = partial(fa_batched_step, alpha=jnp.float32(cfg.alpha),
                           min_px=jnp.float32(cfg.min_px), tile=tile,
                           close_radius=int(cfg.close_radius),
                           max_labels=cfg.max_fa_per_cell,
                           do_remove_small=cfg.min_px > 0)
            step_cache[key] = (per_device(step, mesh) if mesh is not None
                               else step)
        return step_cache[key]

    def _write_stage(s_tag, file_rows):
        if not file_rows:
            return
        df = pd.DataFrame(file_rows)[FA_CSV_COLS]
        df.to_csv(os.path.join(indiv_dir, f"{s_tag}_results.csv"),
                  index=False)
        results[s_tag] = df

    def run_serial(entry):
        s_tag, img, rois = entry
        fa_rows, th_val, bg, _ = analyze_image(img, rois, cfg)
        _write_stage(s_tag, _fa_file_rows(
            s_tag, ((fa["cell"], fa["area"], fa["mean_int_raw"])
                    for fa in fa_rows), th_val, bg, cfg))
        frame_pool.put(img.base)

    sig = None

    def classify(item):
        nonlocal sig
        s_tag, img, rois = item
        log(t("fa_processing").format(tag=s_tag))
        if not rois:
            return "skip", None
        H, W = img.shape
        tile = choose_tile(rois, H, W, margin=margin)
        if sig is None and tile is not None:
            sig = img.shape
            hint.setdefault("tile", tile)
            hint.setdefault("nb", _bucket(len(rois)))
            hint.setdefault("vb", _bucket(max(len(p) for p in rois), 32))
        if (img.shape != sig or tile is None or tile > hint["tile"]
                or len(rois) > hint["nb"]
                or max(len(p) for p in rois) > hint["vb"]):
            return "serial", item
        return "batch", item

    def dispatch(chunk):
        tile, nb, vb = hint["tile"], hint["nb"], hint["vb"]
        B = len(chunk)
        pad_b = batch_size if mesh is not None else B
        H, W = chunk[0][1].shape
        imgs_b = np.zeros((pad_b, H, W), chunk[0][1].dtype)
        lp_b = np.zeros((pad_b, nb, vb, 2), np.float32)
        off_b = np.zeros((pad_b, nb, 2), np.int32)
        val_b = np.zeros((pad_b, nb), bool)
        for bi, (s_tag, img, rois) in enumerate(chunk):
            imgs_b[bi] = img
            offs = tile_offsets(rois, H, W, tile, margin=margin)
            lp, off_pad, valid = pad_local_polys(rois, offs, nb, vb)
            lp_b[bi], off_b[bi], val_b[bi] = lp, off_pad, valid
        flat = step_for(tile, nb, vb)(
            jnp.asarray(imgs_b), jnp.asarray(lp_b), jnp.asarray(off_b),
            jnp.asarray(val_b))
        try:
            # start the device->host result copy while the next chunk decodes
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
        props, n_labels, scal, over = unpack_fa_flat(
            flat, hint["nb"], cfg.max_fa_per_cell)
        for bi, (s_tag, _, rois) in enumerate(chunk):
            if over[bi]:
                # aliased label slots -> wrong rows: skip the stage loudly
                # (re-run with a larger --max-fa-per-cell)
                log(t("err_worker").format(
                    key=s_tag,
                    error=("FA count exceeded max_fa_per_cell="
                           f"{cfg.max_fa_per_cell}; raise "
                           "--max-fa-per-cell")))
                continue
            _m, _s, bg, th_val = (float(v) for v in scal[bi])
            fa_iter = ((i + 1, float(props["area"][bi, i, r]),
                        float(props["mean"][bi, i, r]))
                       for i in range(len(rois))
                       for r in range(int(n_labels[bi, i])))
            _write_stage(s_tag, _fa_file_rows(s_tag, fa_iter, th_val, bg,
                                              cfg))
        for _s_tag, img, _rois in chunk:
            frame_pool.put(img.base)  # (1, H, W) decode buffer now dead

    def _err_key(it):
        # LoadError.item is the raw (img_path, json_path, s_tag) loader
        # pair on a load failure, or the classified (s_tag, img, rois)
        # entry when a serial fallback / emit failed
        return it[2] if isinstance(it[2], str) else it[0]

    if stream_batches(
        loader, batch_size, classify, dispatch, finalize, run_serial,
        lambda err: log(t("err_worker").format(key=_err_key(err.item),
                                               error=err.error)),
        cancel=cancel,
    ):
        log(t("cancelled"))

    if cfg.do_master_report and results:
        merge_fa_report(out_root, cfg.master_name, log=log)
    return results


def analyze_image_with_overrides(
    img: np.ndarray,
    rois: List[np.ndarray],
    cfg: FaConfig,
    cell_settings: Optional[Dict[int, dict]] = None,
) -> Tuple[List[dict], Dict[int, float], float]:
    """Interactive-mode semantics: each cell analyzed with its own
    parameter override when present (FA_Analyzer per-cell settings,
    :646-666, restored via :func:`restore_cell_settings`).  Global stats are
    computed once; thresholds vary per cell via each cell's alpha.
    Returns (fa rows, {cell_idx0: threshold}, bg)."""
    from dataclasses import replace

    imgj = jnp.asarray(img)
    m, s, bg = (float(v) for v in fa_global_stats(imgj))
    cell_settings = cell_settings or {}
    rows: List[dict] = []
    thresholds: Dict[int, float] = {}
    for i, poly in enumerate(rois):
        over = cell_settings.get(i)
        cell_cfg = cfg if over is None else replace(
            cfg,
            alpha=over.get("alpha", cfg.alpha),
            min_area_um=over.get("min_area_um", cfg.min_area_um),
            max_area_um=over.get("max_area_um", cfg.max_area_um),
            close_radius=over.get("close_radius", cfg.close_radius),
            subtract_bg=over.get("subtract_bg", cfg.subtract_bg),
        )
        cell_rows, thr, _, _ = analyze_image(img, [poly], cell_cfg,
                                             stats=(m, s, bg))
        thresholds[i] = thr
        for r in cell_rows:
            r["cell"] = i + 1
            rows.append(r)
    return rows, thresholds, bg


def restore_cell_settings(out_root: str, s_tag: str) -> Dict[int, dict]:
    """Per-cell parameter overrides recovered from a previous run's
    ``individual_results/{s_tag}_results.csv`` — the reference's
    outputs-as-checkpoints resume mechanism (FA_Analyzer.py:572-608).
    Returns {cell_idx0: settings dict}."""
    indiv = os.path.join(out_root, "individual_results", f"{s_tag}_results.csv")
    out: Dict[int, dict] = {}
    if not os.path.exists(indiv):
        return out
    try:
        df = pd.read_csv(indiv)
    except Exception:
        return out
    if df.empty or "Used_Alpha" not in df.columns:
        return out
    for _, row in df.drop_duplicates(subset=["Cell_ID"]).iterrows():
        out[int(row["Cell_ID"]) - 1] = {
            "alpha": float(row["Used_Alpha"]),
            "min_area_um": float(row.get("Min_Area_Setting", 1.5)),
            "max_area_um": float(row.get("Max_Area_Setting", 30.0)),
            "close_radius": int(row.get("Close_Radius_Setting", 1)),
            "subtract_bg": bool(row.get("Subtract_BG_Setting", True)),
        }
    return out


def export_fa_crops(
    img_dir: str,
    roi_dir: str,
    out_root: str,
    cfg: FaConfig,
    cmap: str = "jet",
    sb_on: bool = True,
    sb_len_um: float = 10.0,
    dpi: int = 300,
    log=print,
) -> List[str]:
    """Per-cell FA-mask crop PNGs under ``crops_export/<s_tag>/Cell_N.png``
    (FA_Analyzer.py ExportDialog, :1119-1279 + save_crop_colormap :213-264)."""
    from ..report.render import save_fa_crop_colormap

    out_dir = os.path.join(out_root, "crops_export")
    pairs = list_fa_pairs(img_dir, roi_dir, cfg.channel)
    written: List[str] = []
    for img_path, json_path, s_tag in pairs:
        img = tiffio.read_2d(img_path, squeeze="smallest_axis")
        rois = _load_rois(json_path)
        _, thr, bg, extras = analyze_image(img, rois, cfg)
        if not extras:
            continue
        labels = extras["labels"]
        offs = extras["offsets"]
        tile = extras["tile"]
        file_dir = os.path.join(out_dir, s_tag)
        os.makedirs(file_dir, exist_ok=True)
        H, W = img.shape
        for i, roi_poly in enumerate(rois):
            xs, ys = roi_poly[:, 0], roi_poly[:, 1]
            x0 = max(0, int(np.floor(xs.min())) - 5)
            x1 = min(W, int(np.ceil(xs.max())) + 5)
            y0 = max(0, int(np.floor(ys.min())) - 5)
            y1 = min(H, int(np.ceil(ys.max())) + 5)
            img_crop = img[y0:y1, x0:x1]
            # the FA mask for this cell, re-windowed from its tile
            oy, ox = offs[i]
            bw_tile = labels[i] > 0
            bw = np.zeros((H, W), bool)
            bw[oy:oy + tile, ox:ox + tile] = bw_tile
            path = os.path.join(file_dir, f"Cell_{i + 1}.png")
            save_fa_crop_colormap(
                img_crop, bw[y0:y1, x0:x1],
                roi_poly - np.array([x0, y0], float), path,
                cmap_name=cmap, sb_on=sb_on, sb_len_um=sb_len_um,
                px_size=cfg.px_size, out_dpi=dpi,
            )
            written.append(path)
        log(t("fa_export").format(tag=s_tag, count=len(rois)))
    return written


def save_fa_figs(
    img_dir: str,
    roi_dir: str,
    out_root: str,
    cfg: FaConfig,
    dpi: int = 150,
    mat_dir: Optional[str] = None,
    log=print,
) -> List[str]:
    """Per-stage overview figures under ``fig/<s_tag>_FA.png`` (the golden
    tree's BND_FA/fig outputs): grayscale frame, cell outlines, detected FA
    mask overlay; with ``mat_dir``, legacy MATLAB boundaries matched by
    stage tag overlay as magenta dashed lines (FA_Analyzer.py:650-655,
    747-749)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from ..report.render import colormap_rgba_u8

    fig_dir = os.path.join(out_root, "fig")
    os.makedirs(fig_dir, exist_ok=True)
    written = []
    for img_path, json_path, s_tag in list_fa_pairs(img_dir, roi_dir, cfg.channel):
        img = tiffio.read_2d(img_path, squeeze="smallest_axis")
        rois = _load_rois(json_path)
        _, thr, bg, extras = analyze_image(img, rois, cfg)
        H, W = img.shape
        fa_mask = np.zeros((H, W), bool)
        if extras:
            tile = extras["tile"]
            for i, (oy, ox) in enumerate(extras["offsets"]):
                fa_mask[oy:oy + tile, ox:ox + tile] |= extras["labels"][i] > 0
        fig, ax = plt.subplots(figsize=(10, 10 * H / W))
        lo, hi = np.percentile(img, [1, 99])
        for i, poly in enumerate(rois, 1):
            P = np.asarray(poly, float)
            ax.plot(np.r_[P[:, 0], P[0, 0]], np.r_[P[:, 1], P[0, 1]],
                    color="yellow", lw=1.0, linestyle="--")
            ax.text(P[:, 0].mean(), P[:, 1].mean(), str(i), color="yellow",
                    fontsize=10, ha="center")
        if mat_dir:
            from ..core.roiio import find_matching_mat, load_matlab_boundaries

            mat_path = find_matching_mat(mat_dir, s_tag)
            if mat_path:
                for P in load_matlab_boundaries(mat_path):  # (N, 2) [x, y]
                    ax.plot(P[:, 0], P[:, 1], linewidth=1.0,
                            color="magenta", linestyle="--")
        ax.set_title(f"{s_tag}  alpha={cfg.alpha}  thr={thr:.1f}  bg={bg:.1f}")
        ax.set_axis_off()
        out = os.path.join(fig_dir, f"{s_tag}_FA.png")
        # tight_layout triggers a full draw: run it before the megapixel
        # image artists exist (layout depends only on the title), then
        # paint the base frame + FA overlay as pre-colormapped u8 RGBA
        fig.tight_layout(pad=0.2)
        base = colormap_rgba_u8(img, "gray", lo, hi)
        # composite the reference's 0.9-alpha red FA overlay in u8:
        # out = 0.9*red + 0.1*base, same pixels as the second imshow layer
        under = base[fa_mask, :3].astype(np.float32)
        base[fa_mask, :3] = (0.9 * np.float32([255.0, 51.0, 51.0])
                             + 0.1 * under + 0.5).astype(np.uint8)
        ax.imshow(base)
        fig.savefig(out, dpi=dpi)
        plt.close(fig)
        written.append(out)
        log(t("fa_fig").format(path=out))
    return written


def merge_fa_report(out_root: str, name: str = "FA_Results_Master.xlsx",
                    log=print) -> Optional[pd.DataFrame]:
    """File_Summary / Cell_Summary / All_Data master workbook
    (FA_Analyzer.py:1054-1113)."""
    import glob as _glob

    from ..report.xlsxlite import write_xlsx, _df_rows

    indiv_dir = os.path.join(out_root, "individual_results")
    csvs = _glob.glob(os.path.join(indiv_dir, "*.csv"))
    dfs = []
    for c in csvs:
        try:
            dfs.append(pd.read_csv(c))
        except Exception:
            pass
    if not dfs:
        return None
    full_df = pd.concat(dfs, ignore_index=True)

    cell_grp = full_df.groupby(["File", "Cell_ID", "Category"]).size().unstack(
        fill_value=0)
    for cat in ["OK", "Large", "Small"]:
        if cat not in cell_grp.columns:
            cell_grp[cat] = 0
    cell_grp = cell_grp[["OK", "Large", "Small"]]
    cell_grp["Total_Count"] = cell_grp.sum(axis=1)

    file_grp = full_df.groupby(["File", "Category"]).size().unstack(fill_value=0)
    for cat in ["OK", "Large", "Small"]:
        if cat not in file_grp.columns:
            file_grp[cat] = 0
    file_grp = file_grp[["OK", "Large", "Small"]]
    cells_per_file = full_df.groupby("File")["Cell_ID"].nunique()
    file_summary = file_grp.copy()
    file_summary["Total_FA_Count"] = file_summary.sum(axis=1)
    file_summary["Analyzed_Cells_Count"] = cells_per_file
    file_summary["Avg_FA_per_Cell"] = (
        file_summary["Total_FA_Count"] / file_summary["Analyzed_Cells_Count"]
    )
    file_summary["Avg_OK_FA_per_Cell"] = (
        file_summary["OK"] / file_summary["Analyzed_Cells_Count"]
    )
    file_summary = file_summary.round(2)

    out_xls = os.path.join(out_root, name)
    write_xlsx(out_xls, {
        "File_Summary": _df_rows(file_summary.reset_index()),
        "Cell_Summary": _df_rows(cell_grp.reset_index()),
        "All_Data": _df_rows(full_df),
    })
    log(t("log_save_xls").format(path=out_xls))
    return full_df

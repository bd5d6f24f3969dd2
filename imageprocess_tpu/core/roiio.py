"""ROI persistence: polygon JSON bundles, PNG masks, ImageJ .roi zips,
MATLAB v7.3 boundary files.

The on-disk formats are those of the reference so its datasets load
unchanged:

- ``roi/S01.json``: ``{"name", "image_shape": {"height","width"},
  "rois": [[[x, y], ...], ...], "view_params": {...}}``
  (src/roi_manual_drawer.py:1308-1324).
- ``roi/S01.png``: binary mask, white = inside (Fluor_INT.py:405-441).
- ``roi/zip/S01.zip``: ImageJ ROI files, one polygon each
  (src/roi_manual_drawer.py:1280-1292 via roifile; re-implemented here
  against the public ImageJ .roi byte layout).
- ``BNDb_S01.mat``: MATLAB v7.3 (HDF5) cell-of-cells of [y x] boundary
  arrays under dataset ``bdokcc`` (src/INT/FA_Analyzer.py:82-117).
"""

from __future__ import annotations

import json
import os
import struct
import zipfile
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


# --- JSON polygon bundles ---------------------------------------------------

def load_roi_polygons(json_path: str, min_vertices: int = 3) -> List[np.ndarray]:
    """Polygons as float (N, 2) arrays of [x, y]; drops degenerate entries
    (< *min_vertices*), like Fluor_INT.py:417-424."""
    with open(json_path, "r", encoding="utf-8") as f:
        data = json.load(f)
    polys = []
    for poly in data.get("rois", []):
        arr = np.asarray(poly, dtype=float)
        if arr.ndim == 2 and arr.shape[0] >= min_vertices:
            polys.append(arr)
    return polys


def load_roi_bundle(json_path: str) -> dict:
    with open(json_path, "r", encoding="utf-8") as f:
        return json.load(f)


def save_roi_bundle(
    json_path: str,
    name: str,
    image_shape: Tuple[int, int],
    polygons: Sequence[np.ndarray],
    view_params: Optional[dict] = None,
    generated_by: Optional[str] = None,
) -> None:
    """Atomic write of the reference JSON bundle format."""
    H, W = image_shape
    data: Dict = {
        "name": name,
        "image_shape": {"height": int(H), "width": int(W)},
        "rois": [np.asarray(p, dtype=float).tolist() for p in polygons],
    }
    if view_params is not None:
        data["view_params"] = view_params
    if generated_by is not None:
        data["generated_by"] = generated_by
    os.makedirs(os.path.dirname(json_path) or ".", exist_ok=True)
    tmp = json_path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(data, f, ensure_ascii=False, indent=1)
    os.replace(tmp, json_path)


# --- PNG union masks ----------------------------------------------------------

def load_mask_png(
    png_path: str, img_shape: Optional[Tuple[int, int]] = None
) -> np.ndarray:
    """Binary mask (white = True), cropped/zero-padded to *img_shape* when
    given (Fluor_INT.py:427-440)."""
    from PIL import Image

    with Image.open(png_path) as im:
        mask = np.array(im.convert("L")) > 0
    if img_shape is not None and mask.shape != tuple(img_shape):
        H, W = img_shape
        mask = mask[: min(H, mask.shape[0]), : min(W, mask.shape[1])]
        pad_h, pad_w = H - mask.shape[0], W - mask.shape[1]
        if pad_h or pad_w:
            mask = np.pad(mask, ((0, pad_h), (0, pad_w)), constant_values=False)
    return mask


def load_polys_or_mask(
    roi_base: str, img_shape: Optional[Tuple[int, int]] = None
) -> Tuple[Optional[List[np.ndarray]], Optional[np.ndarray]]:
    """(polygons, None) from ``<base>.json`` if present & non-empty, else
    (None, mask) from ``<base>.png``, else (None, None)."""
    json_path = roi_base + ".json"
    if os.path.exists(json_path):
        polys = load_roi_polygons(json_path)
        if polys:
            return polys, None
    png_path = roi_base + ".png"
    if os.path.exists(png_path):
        return None, load_mask_png(png_path, img_shape)
    return None, None


def count_rois(roi_base: str) -> int:
    """Work-estimate per frame: len(rois) in JSON, 1 for a PNG mask, else 0
    (Fluor_INT.py:443-459)."""
    json_path = roi_base + ".json"
    if os.path.exists(json_path):
        try:
            with open(json_path, "r", encoding="utf-8") as f:
                return max(0, len(json.load(f).get("rois", [])))
        except Exception:
            return 0
    return 1 if os.path.exists(roi_base + ".png") else 0


# --- ImageJ .roi ----------------------------------------------------------------
# Binary layout per the public ImageJ source (ij.io.RoiEncoder / RoiDecoder):
# 64-byte header starting with magic "Iout", version, roi type (0=polygon),
# bounding box as shorts, n coordinates, then relative int16 x coords followed
# by y coords.

_IJ_MAGIC = b"Iout"
_IJ_VERSION = 227
_IJ_TYPE_POLYGON = 0


def encode_imagej_roi(poly_xy: np.ndarray, name: str = "") -> bytes:
    """One polygon -> ImageJ ``.roi`` bytes (integer-pixel polygon ROI).

    When *name* is given it is persisted the ImageJ way (the reference's
    roifile writer does the same, src/roi_manual_drawer.py:1280-1292):
    header offset 60 points at a 64-byte header2 whose fields 16/20 give
    the name offset/length, followed by the name as UTF-16BE chars."""
    pts = np.asarray(poly_xy, dtype=float)
    xs = np.round(pts[:, 0]).astype(np.int32)
    ys = np.round(pts[:, 1]).astype(np.int32)
    left, top = int(xs.min()), int(ys.min())
    right, bottom = int(xs.max()), int(ys.max())
    n = len(xs)
    # the .roi format stores the bbox, vertex count, and relative coords as
    # signed 16-bit — validate up front so an out-of-range polygon (e.g. on
    # a stitched frame past x=32767) fails with an actionable message
    # instead of a bare struct.error mid-zip
    if not (-32768 <= top and bottom <= 32767
            and -32768 <= left and right <= 32767):
        raise ValueError(
            f"polygon bbox ({left},{top})-({right},{bottom}) exceeds the "
            "ImageJ .roi signed-16-bit coordinate range")
    if n > 32767 or right - left > 32767 or bottom - top > 32767:
        raise ValueError(
            "polygon exceeds the ImageJ .roi 16-bit limits "
            f"(n={n}, extent {right - left}x{bottom - top})")
    header = bytearray(64)
    header[0:4] = _IJ_MAGIC
    struct.pack_into(">h", header, 4, _IJ_VERSION)
    header[6] = _IJ_TYPE_POLYGON
    struct.pack_into(">hhhh", header, 8, top, left, bottom, right)
    struct.pack_into(">h", header, 16, n)
    body = bytearray()
    for v in xs - left:
        body += struct.pack(">h", int(v))
    for v in ys - top:
        body += struct.pack(">h", int(v))
    if not name:
        return bytes(header) + bytes(body)
    h2_off = 64 + len(body)
    struct.pack_into(">i", header, 60, h2_off)
    header2 = bytearray(64)
    struct.pack_into(">i", header2, 16, h2_off + 64)   # name offset
    name_bytes = name.encode("utf-16-be")
    # name length in UTF-16 code units (== ImageJ's Java char count), not
    # Python code points: non-BMP chars are surrogate PAIRS in UTF-16
    struct.pack_into(">i", header2, 20, len(name_bytes) // 2)
    return bytes(header) + bytes(body) + bytes(header2) + name_bytes


def decode_imagej_roi(blob: bytes) -> np.ndarray:
    """ImageJ ``.roi`` bytes -> (N, 2) float array of [x, y]."""
    if blob[0:4] != _IJ_MAGIC:
        raise ValueError("not an ImageJ ROI file")
    top, left, _bottom, _right = struct.unpack_from(">hhhh", blob, 8)
    n = struct.unpack_from(">h", blob, 16)[0]
    xs = np.frombuffer(blob, dtype=">i2", count=n, offset=64).astype(float) + left
    ys = np.frombuffer(blob, dtype=">i2", count=n, offset=64 + 2 * n).astype(float) + top
    return np.stack([xs, ys], axis=1)


def decode_imagej_roi_name(blob: bytes) -> str:
    """The ROI name persisted by :func:`encode_imagej_roi` ('' if none)."""
    if len(blob) < 64 or blob[0:4] != _IJ_MAGIC:
        return ""
    h2_off = struct.unpack_from(">i", blob, 60)[0]
    if h2_off <= 0 or h2_off + 64 > len(blob):
        return ""
    name_off = struct.unpack_from(">i", blob, h2_off + 16)[0]
    name_len = struct.unpack_from(">i", blob, h2_off + 20)[0]
    if name_off <= 0 or name_len <= 0 or name_off + 2 * name_len > len(blob):
        return ""
    return blob[name_off:name_off + 2 * name_len].decode("utf-16-be")


def save_imagej_roi_zip(zip_path: str, polygons: Sequence[np.ndarray],
                        base: str = "") -> None:
    """Zip of per-polygon .roi entries named ``roi_<N>.roi`` — the drawer's
    exact convention (src/roi_manual_drawer.py:1280-1292; verified against
    the committed golden roi/zip/S01.zip)."""
    os.makedirs(os.path.dirname(zip_path) or ".", exist_ok=True)
    tmp = zip_path + ".tmp"
    try:
        with zipfile.ZipFile(tmp, "w", zipfile.ZIP_DEFLATED) as zf:
            for i, poly in enumerate(polygons, 1):
                zf.writestr(f"roi_{i}.roi",
                            encode_imagej_roi(poly, f"roi_{i}"))
        os.replace(tmp, zip_path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)  # atomic-write contract: never leave a .tmp
        raise


def load_imagej_roi_zip(zip_path: str) -> List[np.ndarray]:
    """Polygons in ROI-number order.  Entries sort by natural key —
    lexicographic order would permute zips with >= 10 ROIs (roi_10 before
    roi_2), silently mis-pairing polygons with per-ROI result rows."""
    from .naming import natural_key

    polys = []
    with zipfile.ZipFile(zip_path) as zf:
        for info in sorted(zf.infolist(), key=lambda i: natural_key(i.filename)):
            if info.filename.lower().endswith(".roi"):
                polys.append(decode_imagej_roi(zf.read(info)))
    return polys


# --- MATLAB v7.3 boundaries ---------------------------------------------------

def find_matching_mat(mat_dir: str, s_tag: str) -> Optional[str]:
    """Locate the legacy MATLAB boundary file for a stage tag
    (FA_Analyzer.py:105-117): exact ``{s_tag}.mat``, then
    ``BNDb_{s_tag}.mat``, then any ``*.mat`` whose basename contains
    ``s{N}.mat`` or ``s{N}_`` for the tag's first integer (so ``S01``
    matches ``BNDb_e1s1.mat``)."""
    import glob as _glob
    import re

    if not os.path.isdir(mat_dir):
        return None
    for name in (f"{s_tag}.mat", f"BNDb_{s_tag}.mat"):
        p = os.path.join(mat_dir, name)
        if os.path.exists(p):
            return p
    m = re.search(r"\d+", s_tag)
    if m is None:
        return None
    num = int(m.group())
    # sorted for determinism (the reference takes OS glob order)
    for cand in sorted(_glob.glob(os.path.join(mat_dir, "*.mat"))):
        base = os.path.basename(cand)
        if f"s{num}.mat" in base or f"s{num}_" in base:
            return cand
    return None


def load_matlab_boundaries(mat_path: str, dataset: str = "bdokcc") -> List[np.ndarray]:
    """Boundary polygons from a MATLAB v7.3 (HDF5) cell-of-cells file, as
    (N, 2) [x, y] arrays.  MATLAB stores [y x] columns; we swap to [x y]
    like FA_Analyzer.py:82-117."""
    import h5py

    polys: List[np.ndarray] = []
    with h5py.File(mat_path, "r") as f:
        if dataset not in f:
            return polys
        outer = f[dataset]
        refs = np.asarray(outer).ravel()
        for ref in refs:
            cell = f[ref]
            inner_refs = np.asarray(cell).ravel()
            for iref in inner_refs:
                if isinstance(iref, h5py.Reference):
                    arr = np.asarray(f[iref]).T  # (N, 2) [y, x]
                else:
                    arr = np.asarray(cell).T
                if arr.ndim == 2 and arr.shape[1] >= 2 and arr.shape[0] >= 3:
                    polys.append(arr[:, [1, 0]].astype(float))
                if not isinstance(iref, h5py.Reference):
                    break
    return polys

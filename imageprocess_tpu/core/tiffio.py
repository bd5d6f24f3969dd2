"""TIFF decode/encode for 16-bit LZW microscopy frames.

Decode path order:
1. the native C++ LZW TIFF reader (``imageprocess_tpu.native``) when built —
   multi-threaded strip decode, zero Python in the inner loop;
2. Pillow (handles LZW-compressed grayscale TIFFs), imported only when
   the native tier cannot decode a file, and for writing.

The reference reads via tifffile with a PIL fallback and squeezes >2-D pages
by taking channel 0 (src/INT/Fluor_INT.py:350-368); FA_Analyzer instead picks
the *smallest* axis as the channel axis (src/INT/FA_Analyzer.py:44-72) —
exposed here as ``read_2d(..., squeeze="smallest_axis")``.

Writes are atomic (``.tmp`` + ``os.replace``), matching
src/roi_manual_drawer.py:1325-1328.
"""

from __future__ import annotations

import os
from typing import Literal

import numpy as np

try:  # the optional native decode tier
    from imageprocess_tpu.native import decode_tiff as _native_decode
except Exception:  # pragma: no cover - native lib not built
    _native_decode = None


def read_tiff(path: str, page: int = 0) -> np.ndarray:
    """Decode one TIFF page to a numpy array (dtype preserved)."""
    if _native_decode is not None:
        arr = _native_decode(path, page)
        if arr is not None:
            return arr
    from PIL import Image

    with Image.open(path) as im:
        try:
            im.seek(page)
        except EOFError:
            im.seek(0)
        return np.array(im)


def squeeze_first_channel(a: np.ndarray) -> np.ndarray:
    """>2-D page -> 2-D by taking channel 0 (Fluor_INT.py:362-368)."""
    if a.ndim > 2:
        a = a[..., 0] if a.ndim == 3 else a[0, ...]
    return a


def squeeze_smallest_axis(a: np.ndarray) -> np.ndarray:
    """>2-D page -> 2-D by slicing index 0 of the smallest axis, repeatedly
    (FA_Analyzer.py:44-72 heuristic for channel-first vs channel-last)."""
    while a.ndim > 2:
        a = np.take(a, 0, axis=int(np.argmin(a.shape)))
    return a


def read_2d(
    path: str,
    dtype=np.float32,
    squeeze: Literal["first_channel", "smallest_axis"] = "first_channel",
) -> np.ndarray:
    """2-D page as *dtype* (None = preserve the file dtype, letting device
    pipelines upload compact u16 and cast on-chip)."""
    a = read_tiff(path)
    a = squeeze_first_channel(a) if squeeze == "first_channel" else squeeze_smallest_axis(a)
    if dtype is None:
        return a
    return a.astype(dtype, copy=False)


def _atomic_save(arr: np.ndarray, path: str, **kwargs) -> None:
    from PIL import Image

    im = (Image.fromarray(arr, mode="F") if arr.dtype == np.float32
          else Image.fromarray(arr))
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    im.save(tmp, format="TIFF", **kwargs)
    os.replace(tmp, path)


def write_tiff32(path: str, img: np.ndarray) -> None:
    """Float32 single-channel TIFF (analysis-grade output)."""
    _atomic_save(np.asarray(img, dtype=np.float32), path)


def write_tiff16(path: str, img: np.ndarray) -> None:
    """Uint16 single-channel TIFF (preview-grade output)."""
    _atomic_save(np.asarray(img, dtype=np.uint16), path)


def write_tiff8(path: str, img: np.ndarray) -> None:
    """Uint8 single-channel TIFF (e.g. ROI masks, 0/255)."""
    _atomic_save(np.asarray(img, dtype=np.uint8), path)


def normalize_to_u16(
    img: np.ndarray, lo: float, hi: float, eps: float = 1e-12
) -> np.ndarray:
    """Clip to [lo, hi], normalize, scale to the full uint16 range — the
    reference's 16-bit preview transform (Fluor_INT.py:930-943)."""
    clipped = np.clip(img, lo, hi)
    norm = (clipped - lo) / (hi - lo + eps)
    # NaN pixels (QC'd saturation etc.) clip through unchanged; numpy's
    # float->uint16 cast of NaN is platform-defined (0 on x86, with a
    # RuntimeWarning) — pin the observed reference behavior explicitly.
    return (np.nan_to_num(norm, nan=0.0) * 65535).astype(np.uint16)

"""Native host-side decode tier (ctypes bindings to libiptiff.so).

``decode_tiff(path, page)`` returns a numpy array (uint8/uint16/float32,
(H, W) or (H, W, S)) or None when the native library is unavailable or the
file uses an unsupported layout (caller falls back to PIL — see
core.tiffio).  Classic TIFF and BigTIFF; stripped and tiled; none/LZW/
Deflate/PackBits strips; predictor 2; either endianness.

Build: ``make -C native`` (g++, no external deps).  The first use builds
the shared library from ``native/tiff_lzw.cpp`` when it is missing or
older than that source, so the binary always matches the committed code.
A failed build is reported (``RuntimeWarning`` with the compiler's
stderr, also kept in :data:`build_error`) and the callers fall back to
PIL.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
import warnings
from typing import Optional

import numpy as np

_LIB_PATH = os.path.join(os.path.dirname(__file__), "libiptiff.so")
_SRC = os.path.join(os.path.dirname(__file__), "..", "..", "native",
                    "tiff_lzw.cpp")
_lock = threading.Lock()
_lib = None
_tried = False

#: why the native library could not be built or loaded (compiler stderr
#: or loader error), or None
build_error: Optional[str] = None


def _fail(msg: str) -> None:
    global build_error
    build_error = msg
    warnings.warn(f"native TIFF decoder unavailable:\n{msg}", RuntimeWarning,
                  stacklevel=3)


def _stale() -> bool:
    """Library missing, or older than the source it is built from."""
    if not os.path.exists(_LIB_PATH):
        return True
    return (os.path.exists(_SRC)
            and os.path.getmtime(_SRC) > os.path.getmtime(_LIB_PATH))


def _try_build() -> None:
    """Compile the library next to this module.  Writes to a per-process
    temporary name and renames, so concurrent first uses (test workers)
    never load a half-written file."""
    if not os.path.exists(_SRC):
        return
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-march=native", "-fPIC", "-std=c++17", "-shared",
           "-o", tmp, _SRC, "-lpthread", "-lz"]
    try:
        p = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        _fail(f"{' '.join(cmd)}: {e}")
        return
    if p.returncode != 0:
        _fail(f"{' '.join(cmd)} exited {p.returncode}:\n{p.stderr.strip()}")
        return
    os.replace(tmp, _LIB_PATH)


def _bind(lib) -> bool:
    """Declare all expected symbols; False when any is missing (a stale
    libiptiff.so from an older source revision)."""
    try:
        _declare(lib)
        return True
    except AttributeError:
        return False


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if _stale():
            _try_build()
        if not os.path.exists(_LIB_PATH):
            return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError as e:
            _fail(f"loading {_LIB_PATH}: {e}")
            return None
        if not _bind(lib):
            _fail(f"{_LIB_PATH} lacks symbols of the current source")
            return None
        _lib = lib
        return _lib


def _declare(lib) -> None:
    lib.ip_tiff_info.argtypes = [
        ctypes.c_char_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
    ]
    lib.ip_tiff_info.restype = ctypes.c_int
    lib.ip_tiff_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_longlong,
    ]
    lib.ip_tiff_decode.restype = ctypes.c_int
    lib.ip_tiff_error.restype = ctypes.c_char_p
    lib.ip_tiff_decode_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.ip_tiff_decode_batch.restype = ctypes.c_int
    lib.ip_tiff_decode_batch_hist.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_longlong, ctypes.POINTER(ctypes.c_uint32),
    ]
    lib.ip_tiff_decode_batch_hist.restype = ctypes.c_int
    lib.ip_tiff_decode_batch_hist_tiles.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_longlong, ctypes.POINTER(ctypes.c_uint32),
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.ip_tiff_decode_batch_hist_tiles.restype = ctypes.c_int
    lib.ip_u16_percentile_strided.argtypes = [
        ctypes.POINTER(ctypes.c_uint16), ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_int,
    ]
    lib.ip_u16_percentile_strided.restype = ctypes.c_double
    lib.ip_u16_hist.argtypes = [
        ctypes.POINTER(ctypes.c_uint16), ctypes.c_longlong,
        ctypes.c_longlong, ctypes.POINTER(ctypes.c_uint32),
    ]
    lib.ip_u16_hist.restype = None


class FrameBufferPool:
    """Small thread-safe free-list of decode output buffers keyed by
    (shape, dtype).  Frames this size go through malloc's mmap path, so a
    plain allocate-per-key loop pays an munmap + fresh-page-fault cycle
    per frame (~200 MB/run at bench shapes); recycling keeps the pages
    warm.  Callers ``put()`` a buffer back ONLY once nothing references
    it — the next ``get()`` hands the same memory to a decoder that
    overwrites every byte."""

    def __init__(self, max_items: int = 64):
        self._lock = threading.Lock()
        self._free: dict = {}
        self._max = max_items
        self._count = 0

    def get(self, shape, dtype) -> np.ndarray:
        key = (tuple(shape), np.dtype(dtype).str)
        with self._lock:
            lst = self._free.get(key)
            if lst:
                self._count -= 1
                return lst.pop()
        return np.empty(shape, dtype)

    def put(self, arr: Optional[np.ndarray]) -> None:
        if arr is None or not isinstance(arr, np.ndarray):
            return
        if not arr.flags.c_contiguous or arr.base is not None:
            return  # only whole owned buffers are recyclable
        key = (arr.shape, arr.dtype.str)
        with self._lock:
            if self._count >= self._max:
                return
            self._free.setdefault(key, []).append(arr)
            self._count += 1


def decode_tiff_batch(paths, page: int = 0) -> Optional[np.ndarray]:
    """Decode N same-shaped TIFFs into one (N, H, W[, S]) array with a
    single native call (per-file thread pool in C++; per-file decode runs
    single-threaded inside the pool).  Every file must match the first
    file's (H, W, bits, samples) — the native side verifies and errors on
    mismatch rather than decoding into a misaligned slot.  Returns None
    when the native library is unavailable or any file is unsupported —
    callers fall back to per-file decode."""
    out = decode_tiff_batch_hist(paths, 0, page=page)
    return None if out is None else out[0]


def decode_tiff_batch_hist(paths, hist_stride: int, page: int = 0,
                           pool: Optional[FrameBufferPool] = None):
    """:func:`decode_tiff_batch` plus, when *hist_stride* >= 1 and the
    files are 16-bit single-sample, a per-file strided counting histogram
    of ``frame.ravel()[::hist_stride]`` accumulated DURING the decode pass
    (the background percentile rides the decoder's cache-hot rows — no
    second frame scan).  Returns (frames, hists (N, 65536) u32 or None),
    or None entirely when the native path is unavailable."""
    lib = _load()
    if lib is None or not paths:
        return None
    h = ctypes.c_int()
    w = ctypes.c_int()
    bits = ctypes.c_int()
    samples = ctypes.c_int()
    if lib.ip_tiff_info(paths[0].encode(), page, ctypes.byref(h),
                        ctypes.byref(w), ctypes.byref(bits),
                        ctypes.byref(samples)) != 0:
        return None
    dtype = (np.float32 if bits.value == 32
             else np.uint16 if bits.value == 16 else np.uint8)
    frame_shape = ((h.value, w.value) if samples.value == 1
                   else (h.value, w.value, samples.value))
    full_shape = (len(paths),) + frame_shape
    out = (pool.get(full_shape, dtype) if pool is not None
           else np.empty(full_shape, dtype=dtype))
    want_hist = (hist_stride >= 1 and bits.value == 16
                 and samples.value == 1)
    hists = np.zeros((len(paths), 65536), np.uint32) if want_hist else None
    arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
    rc = lib.ip_tiff_decode_batch_hist(
        arr, len(paths), page,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.nbytes // len(paths),
        h.value, w.value, bits.value, samples.value,
        int(hist_stride) if want_hist else 0,
        hists.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))
        if want_hist else None,
    )
    if rc != 0:
        return None
    return out, hists


def tiff_info(path: str, page: int = 0):
    """(H, W, bits, samples) from the TIFF header (a microsecond-scale
    header read — lets callers size ROI-tile requests BEFORE the decode),
    or None when the native library is unavailable / file unsupported."""
    lib = _load()
    if lib is None:
        return None
    h = ctypes.c_int()
    w = ctypes.c_int()
    bits = ctypes.c_int()
    samples = ctypes.c_int()
    if lib.ip_tiff_info(path.encode(), page, ctypes.byref(h),
                        ctypes.byref(w), ctypes.byref(bits),
                        ctypes.byref(samples)) != 0:
        return None
    return h.value, w.value, bits.value, samples.value


def decode_tiff_batch_hist_tiles(paths, hist_stride: int,
                                 offsets: np.ndarray, tile: int,
                                 page: int = 0, pad_tiles: int = 0,
                                 pool: Optional[FrameBufferPool] = None):
    """:func:`decode_tiff_batch_hist` plus fused ROI-tile extraction: the
    decoder's worker threads copy each requested ``tile``-square rectangle
    (``offsets`` (N, 2) int32 [oy, ox] rows, shared across the batch's
    files/channels) out of the just-decoded cache-warm frames, so the whole
    per-key host pipeline — decode, histogram, tile gather — is one
    GIL-free native call.  Returns (frames (C, H, W), hists or None,
    tiles (N + pad_tiles, C, tile, tile)); the ``pad_tiles`` extra lanes
    come back zeroed (batch programs mask them via roi_valid).  None when
    the native path is unavailable or the files aren't 16-bit
    single-sample."""
    lib = _load()
    if lib is None or not paths:
        return None
    h = ctypes.c_int()
    w = ctypes.c_int()
    bits = ctypes.c_int()
    samples = ctypes.c_int()
    if lib.ip_tiff_info(paths[0].encode(), page, ctypes.byref(h),
                        ctypes.byref(w), ctypes.byref(bits),
                        ctypes.byref(samples)) != 0:
        return None
    if bits.value != 16 or samples.value != 1:
        return None  # caller falls back to decode-then-gather
    offsets = np.ascontiguousarray(offsets, np.int32)
    n = int(offsets.shape[0])
    full_shape = (len(paths), h.value, w.value)
    out = (pool.get(full_shape, np.uint16) if pool is not None
           else np.empty(full_shape, np.uint16))
    want_hist = hist_stride >= 1
    hists = np.zeros((len(paths), 65536), np.uint32) if want_hist else None
    tiles_shape = (n + pad_tiles, len(paths), tile, tile)
    tiles = (pool.get(tiles_shape, np.uint16) if pool is not None
             else np.empty(tiles_shape, np.uint16))
    if pad_tiles:
        tiles[n:] = 0
    arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
    rc = lib.ip_tiff_decode_batch_hist_tiles(
        arr, len(paths), page,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.nbytes // len(paths),
        h.value, w.value, bits.value, samples.value,
        int(hist_stride) if want_hist else 0,
        hists.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))
        if want_hist else None,
        n, int(tile),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        tiles.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    if rc != 0:
        return None
    return out, hists, tiles


def u16_percentile_strided(arr: np.ndarray, stride: int, p1000: int) -> float:
    """Exact ``np.percentile(arr.ravel()[::stride], p1000/1000)`` for uint16
    arrays (counting pass, no sort — ~10x faster than np.percentile on this
    host).  Falls back to numpy when the native library is unavailable."""
    a = np.ascontiguousarray(arr, dtype=np.uint16)
    lib = _load()
    if lib is not None:
        return float(lib.ip_u16_percentile_strided(
            a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
            a.size, max(1, int(stride)), int(p1000),
        ))
    vals = a.ravel()[::max(1, int(stride))]
    if vals.size == 0:
        return 0.0
    return float(np.percentile(vals.astype(np.float64), p1000 / 1000.0))


def u16_hist(arr: np.ndarray, stride: int = 1) -> np.ndarray:
    """65536-bin counting histogram of ``arr.ravel()[::stride]`` (uint16).
    One native pass can serve several exact order statistics — see
    :func:`percentile_from_hist`.  Falls back to np.bincount."""
    a = np.ascontiguousarray(arr, dtype=np.uint16)
    lib = _load()
    if lib is not None:
        hist = np.zeros(65536, np.uint32)
        lib.ip_u16_hist(
            a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
            a.size, max(1, int(stride)),
            hist.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        )
        return hist
    return np.bincount(a.ravel()[::max(1, int(stride))],
                       minlength=65536).astype(np.uint32)


def hist_order_stats(hist: np.ndarray, p1000: int):
    """(lo, hi, g): the two exact integer order statistics and the
    interpolation weight for ``np.percentile(values, p1000/1000,
    method='linear')`` over a counting histogram — THE canonical (k, g)
    arithmetic (CLAUDE.md invariant; also implemented in C by
    ip_u16_percentile_strided).  Callers that percentile a MONOTONE
    TRANSFORM of the values (e.g. bg-corrected eps) transform lo/hi first
    and interpolate after — bit-identical to sorting transformed values."""
    cdf = np.cumsum(hist.astype(np.int64))
    n = int(cdf[-1])
    if n == 0:
        return 0, 0, 0.0
    idx = (n - 1) * int(p1000)
    k = idx // 100000
    g = (idx % 100000) / 100000.0
    lo = int(np.searchsorted(cdf, k, side="right"))
    hi = int(np.searchsorted(cdf, min(k + 1, n - 1), side="right"))
    return lo, hi, g


def percentile_from_hist(hist: np.ndarray, p1000: int) -> float:
    """Exact ``np.percentile(values, p1000/1000, method='linear')`` from a
    counting histogram of integer values."""
    lo, hi, g = hist_order_stats(hist, p1000)
    return float(lo) + g * float(hi - lo)


def hist_mode_from_hist(hist: np.ndarray, p1000: int) -> float:
    """The reference's "hist-mode" background (Fluor_INT.py:475-483) from a
    u16 counting histogram of the strided subsample, bit-identical to the
    device op (ops.background.histogram_mode_value) on integral frames.

    Identical-rounding argument: lo/hi are exact integers in float32; the
    per-value bin is ``f32((v - lo) / span) * 2048`` where the multiply by
    2048 is an exact exponent shift, so the single f32 division is the only
    rounding and IEEE-754 division agrees between numpy and XLA; the CDF is
    an exact integer cumsum cast to f32 then one f32 division.  This lets
    hist-mode runs ride the decoder's fused histogram pass instead of
    shipping full frames over the link (tests/test_batched_runner.py
    asserts host==device on golden frames)."""
    counts = np.asarray(hist, np.int64)
    nz = np.flatnonzero(counts)
    if nz.size == 0:
        return 0.0
    return _hist_mode_core(nz.astype(np.float32), counts[nz],
                           np.float32(nz[0]), np.float32(nz[-1]), p1000)


def hist_mode_from_values(vals: np.ndarray, p1000: int) -> float:
    """hist_mode_from_hist for a raw (already strided) value array — the
    fallback when the native decoder's fused histogram is unavailable or
    the frames are not integral.  float32 arithmetic mirrors the device op
    operation-for-operation."""
    v = np.asarray(vals, np.float32)
    v = v[np.isfinite(v)]
    if v.size == 0:
        return 0.0
    return _hist_mode_core(v, None, v.min(), v.max(), p1000)


def _hist_mode_core(v: np.ndarray, weights, lo, hi, p1000: int) -> float:
    """Shared 2048-bin binning/CDF/first-bin-midpoint body (the
    bit-identity rationale in hist_mode_from_hist's docstring applies to
    this code).  ``weights=None`` counts each value once."""
    span = np.float32(hi - lo) if hi > lo else np.float32(1.0)
    idx = ((v - lo) / span * np.float32(2048.0)).astype(np.int32)
    np.clip(idx, 0, 2047, out=idx)
    h2 = np.zeros(2048, np.int64)
    np.add.at(h2, idx, 1 if weights is None else weights)
    cdf = np.cumsum(h2).astype(np.float32) / np.float32(h2.sum())
    target = np.float32(p1000) / np.float32(100000.0)
    reach = cdf >= target
    if not reach.any():
        return float(hi)
    first = int(np.argmax(reach))
    bin_w = span / np.float32(2048.0)
    return float(lo + (np.float32(first) + np.float32(0.5)) * bin_w)


def decode_tiff(path: str, page: int = 0) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    h = ctypes.c_int()
    w = ctypes.c_int()
    bits = ctypes.c_int()
    samples = ctypes.c_int()
    rc = lib.ip_tiff_info(path.encode(), page, ctypes.byref(h),
                          ctypes.byref(w), ctypes.byref(bits),
                          ctypes.byref(samples))
    if rc != 0:
        return None
    dtype = (np.float32 if bits.value == 32
             else np.uint16 if bits.value == 16 else np.uint8)
    shape = ((h.value, w.value) if samples.value == 1
             else (h.value, w.value, samples.value))
    out = np.empty(shape, dtype=dtype)
    buf = out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    rc = lib.ip_tiff_decode(path.encode(), page, buf, out.nbytes)
    if rc != 0:
        return None
    return out

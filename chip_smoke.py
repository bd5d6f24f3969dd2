#!/usr/bin/env python
"""GPU smoke test: drive intensity tables, FRET tables and U-Net ROI
drawing through the CLI on an NVIDIA GPU, each checked against a plain
numpy reference.

    python chip_smoke.py                  # one card: every phase below
    python chip_smoke.py --devices 4      # four cards: runs on 4 vs on 1
    python chip_smoke.py --trace DIR      # also profile the warm intensity run

Phases (one process, one JAX client):

  device        the first JAX device must be a GPU (else exit non-zero)
  native        the C++ TIFF decoder builds from native/tiff_lzw.cpp
  data          16 stages x 2 channels of 2048x1536 u16 LZW TIFFs and 18
                ROI polygons per stage (bench.py's synthetic experiment)
  intensity     ``intensity --batched`` CSV vs a float64 numpy reference
  fret          ``fret`` (the batched tables runner) ratio_mean vs numpy
  segmentation  ``roi-auto --backend unet --checkpoint general`` on a
                synthcells 2048x1536 frame: U-Net forward vs the CPU
                backend, polygons vs ground truth, label-overflow flag

With ``--devices N`` only the multi-device path runs: ``intensity
--batched`` and ``roi-auto`` (on N synthcells frames, whole frames spread
over the devices) with ``--devices N`` against ``--devices 1``, which must
give the same CSV bytes and equal polygons, with every one of the N
devices holding buffers.

Earlier lines report each phase's wall seconds (first call, compile
included, apart from the warm call).  The last stdout line is
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``;
any failed check raises, so the script exits non-zero without it.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import shutil
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import numpy as np

import bench

N_STAGES = 16
H, W = bench.H, bench.W
CHANNELS = bench.CHANNELS
CMP_STAGES = ("S01", "S08", "S16")   # stages checked against the reference
INTENSITY_RTOL = 1e-4    # the repo's golden-parity bound
INTENSITY_ATOL = 1e-6    # same absolute floor as the golden test
FRET_RTOL = 1e-5         # elementwise f32 path, no matmul: no TF32 risk
# U-Net logits, card vs CPU backend.  The model computes in bfloat16 by
# design: every conv output is rounded to bf16 (8 mantissa bits, 2**-8
# relative), and the two backends sum the products in different orders,
# so single activations may land one bf16 step apart and the difference
# propagates through 18 convolutions and GroupNorms.  The bound is on
# |delta logit| relative to the largest logit of the tiles.
LOGIT_RTOL = 0.05
# synthcells "fluor" floors of tests/test_unet_general.py (IoU >= 0.3)
SEG_MIN_RECALL, SEG_MIN_IOU = 0.90, 0.70
SEG_MIN_SIZE_PX = 100    # as in tests/test_unet_general.py


def log(msg: str) -> None:
    print(f"[smoke] {msg}", flush=True)


def cli(argv) -> float:
    """Run ``imageprocess`` in this process; return its wall seconds."""
    from imageprocess_tpu.cli import main

    t0 = time.perf_counter()
    rc = main(list(argv))
    dt = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"imageprocess {' '.join(argv)} exited {rc}")
    return dt


# ---------------------------------------------------------------------------
# device and native tier
# ---------------------------------------------------------------------------

def phase_device():
    import jax

    import imageprocess_tpu  # noqa: F401 — configures the compile cache

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"no GPU: JAX's first device is {devs[0].platform!r}"
                         f" ({devs[0].device_kind})")
    log(f"device_kind {devs[0].device_kind!r}, {len(devs)} device(s)")
    log(f"card {bench.card_line()}")
    log(f"jax {jax.__version__}, compile cache "
        f"{jax.config.jax_compilation_cache_dir}")
    return devs


def phase_native() -> None:
    from imageprocess_tpu import native

    t0 = time.perf_counter()
    lib = native._load()
    if lib is None:
        raise RuntimeError(f"native TIFF decoder did not load: "
                           f"{native.build_error}")
    log(f"native decoder loaded ({time.perf_counter() - t0:.2f} s, "
        f"build included when the library was stale)")


# ---------------------------------------------------------------------------
# numpy references
# ---------------------------------------------------------------------------

def _read_tiff_pil(path: str) -> np.ndarray:
    """Reference decode through Pillow, independent of the native tier."""
    from PIL import Image

    with Image.open(path) as im:
        return np.array(im)


def _stage_masks(data_dir: str, stage: str, shape):
    from imageprocess_tpu.core import roiio
    from imageprocess_tpu.geom.rasterize import rasterize_polygon_np

    polys = roiio.load_roi_polygons(os.path.join(data_dir, "roi",
                                                 f"{stage}.json"))
    return [rasterize_polygon_np(p, shape) for p in polys]


def intensity_reference(data_dir: str, stage: str, ch: int, masks,
                        p: float = 1.0, stride: int = 4):
    """IntensityConfig defaults in float64: bg = np.percentile (linear)
    of every *stride*-th pixel, clip(x - bg, 0), nine stats per mask."""
    img = _read_tiff_pil(os.path.join(data_dir, f"{stage}_{ch}.TIF"))
    img = img.astype(np.float64)
    bg = np.percentile(img.ravel()[::stride], p)
    x = np.maximum(img - bg, 0.0)
    out = []
    for m in masks:
        v = x[m]
        out.append({
            "mean": v.mean(), "median": np.median(v), "std": v.std(),
            "p5": np.percentile(v, 5), "p95": np.percentile(v, 95),
            "vmin": v.min(), "vmax": v.max(), "vsum": v.sum(),
            "npx": float(v.size), "bg": bg,
        })
    return out


def fret_reference(data_dir: str, stage: str, donor: int, acceptor: int,
                   masks, p: float = 1.0, eps_p: float = 1.0,
                   eps_abs: float = 5.0):
    """FRET/Donor ratio means in float64: full-frame p-th percentile
    backgrounds, eps = max(eps_abs, eps_p-th percentile of the corrected
    donor frame), ratio = (Ac + eps) / (Dc + eps)."""
    def corrected(ch):
        img = _read_tiff_pil(os.path.join(data_dir, f"{stage}_{ch}.TIF"))
        img = img.astype(np.float64)
        return np.maximum(img - np.percentile(img.ravel(), p), 0.0)

    dc, ac = corrected(donor), corrected(acceptor)
    eps = max(eps_abs, np.percentile(dc.ravel(), eps_p))
    r = (ac + eps) / (dc + eps)
    return [r[m].mean() for m in masks]


def _read_csv(path: str):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def _rel_err(got: float, want: float) -> float:
    if np.isnan(got) and np.isnan(want):
        return 0.0
    if abs(got - want) <= INTENSITY_ATOL:
        return 0.0
    return abs(got - want) / max(abs(want), 1e-12)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_data(data_dir: str) -> None:
    t0 = time.perf_counter()
    bench._make_dataset(data_dir, N_STAGES, H, W)
    log(f"data: {N_STAGES} stages x {len(CHANNELS)} channels of {W}x{H} u16 "
        f"LZW, {bench.N_ROIS} ROIs/stage ({time.perf_counter() - t0:.1f} s)")


def phase_intensity(data_dir: str, out: str, trace_dir=None) -> dict:
    argv = ["intensity", data_dir, "--channels", *map(str, CHANNELS),
            "--batched", "--out", out, "--lang", "en"]
    cold = cli(argv)
    warm = cli(argv + (["--xprof", trace_dir] if trace_dir else []))
    log(f"intensity: first call {cold:.2f} s, warm call {warm:.2f} s, "
        f"compile ~{cold - warm:.2f} s")

    rows = _read_csv(os.path.join(out, "xls", "fluor_intensity_perROI.csv"))
    if len(rows) != N_STAGES * bench.N_ROIS:
        raise AssertionError(f"intensity CSV has {len(rows)} rows, want "
                             f"{N_STAGES * bench.N_ROIS}")
    worst = 0.0
    for stage in CMP_STAGES:
        srows = sorted((r for r in rows if r["stage"] == stage),
                       key=lambda r: int(r["roi"]))
        masks = _stage_masks(data_dir, stage, (H, W))
        for ch in CHANNELS:
            ref = intensity_reference(data_dir, stage, ch, masks)
            for r, want in zip(srows, ref):
                for k, v in want.items():
                    e = _rel_err(float(r[f"ch{ch}_{k}"]), float(v))
                    worst = max(worst, e)
                    if e > INTENSITY_RTOL:
                        raise AssertionError(
                            f"intensity {stage} roi {r['roi']} ch{ch}_{k}: "
                            f"{r[f'ch{ch}_{k}']} vs {v} (rel {e:.3g})")
    log(f"intensity parity: max rel err {worst:.3g} over {len(CMP_STAGES)} "
        f"stages x {len(CHANNELS)} channels x 10 columns "
        f"(bound {INTENSITY_RTOL})")
    return {"cold_s": cold, "warm_s": warm, "max_rel_err": worst}


def phase_fret(data_dir: str, out: str) -> dict:
    argv = ["fret", data_dir, "--donor-ch", str(CHANNELS[0]),
            "--acceptor-ch", str(CHANNELS[1]), "--out", out, "--lang", "en"]
    cold = cli(argv)
    warm = cli(argv)
    log(f"fret: first call {cold:.2f} s, warm call {warm:.2f} s, "
        f"compile ~{cold - warm:.2f} s")
    rows = _read_csv(os.path.join(out, "xls", "fret_ratio_perROI.csv"))
    worst = 0.0
    for stage in CMP_STAGES:
        srows = sorted((r for r in rows if r["stage"] == stage),
                       key=lambda r: int(r["roi"]))
        masks = _stage_masks(data_dir, stage, (H, W))
        ref = fret_reference(data_dir, stage, CHANNELS[0], CHANNELS[1], masks)
        if len(srows) != len(ref):
            raise AssertionError(f"fret {stage}: {len(srows)} rows, want "
                                 f"{len(ref)}")
        for r, want in zip(srows, ref):
            e = abs(float(r["ratio_mean"]) - want) / abs(want)
            worst = max(worst, e)
            if e > FRET_RTOL:
                raise AssertionError(f"fret {stage} roi {r['roi']}: ratio_mean"
                                     f" {r['ratio_mean']} vs {want} "
                                     f"(rel {e:.3g})")
    log(f"fret parity: ratio_mean max rel err {worst:.3g} over "
        f"{len(CMP_STAGES)} stages (bound {FRET_RTOL})")
    return {"cold_s": cold, "warm_s": warm, "max_rel_err": worst}


def _seg_frame(seg_dir: str, i: int = 0):
    """Full-size synthcells field *i* written as stage TIFF S<i+1>_1.TIF;
    returns (u16 frame, ground-truth polygons)."""
    from imageprocess_tpu.core import tiffio
    from imageprocess_tpu.models.synthcells import eval_frame

    ev = eval_frame(i, "fluor", H=H, W=W)
    frame = np.clip(ev["img"], 0, 65535).astype(np.uint16)
    os.makedirs(seg_dir, exist_ok=True)
    tiffio.write_tiff16(os.path.join(seg_dir, f"S{i + 1:02d}_1.TIF"), frame)
    return frame, ev["polys"]


def _forward_vs_cpu(frame: np.ndarray, n_tiles: int = 8) -> float:
    """U-Net logits of the frame's first *n_tiles* tiles on the card vs
    the same function on the CPU backend: max |delta| / max |logit|."""
    import jax
    import jax.numpy as jnp

    from imageprocess_tpu.segment.auto import AutoSegConfig, _unet_model
    from imageprocess_tpu.segment.cellseg import _host_stretch_lohi, tile_grid

    apply_fn, params, tile = _unet_model(
        AutoSegConfig(backend="unet", checkpoint="general"))
    lo, hi, u16 = _host_stretch_lohi(frame)
    den = 1e-6 if hi <= lo else hi - lo
    x = np.clip((u16.astype(np.float32) - np.float32(lo)) / np.float32(den),
                0.0, 1.0)
    ys, xs = tile_grid(*frame.shape, tile, 32)
    org = [(y, x0) for y in ys for x0 in xs][:n_tiles]
    tiles = np.stack([x[y:y + tile, x0:x0 + tile] for y, x0 in org])[..., None]
    fwd = jax.jit(apply_fn)
    gpu = np.asarray(fwd(params, jnp.asarray(tiles)))
    cpu_dev = jax.devices("cpu")[0]
    cpu = np.asarray(fwd(jax.device_put(params, cpu_dev),
                         jax.device_put(tiles, cpu_dev)))
    scale = float(np.abs(cpu[..., 0]).max())
    d = np.abs(gpu - cpu)
    rel = float(d[..., 0].max()) / max(scale, 1.0)
    agree = float(((gpu[..., 0] > 0) == (cpu[..., 0] > 0)).mean())
    log(f"U-Net forward, {len(org)} tiles card vs CPU: max |d logit| "
        f"{d[..., 0].max():.4g} (max |logit| {scale:.4g}, rel {rel:.3g}), "
        f"max |d flow| {d[..., 1:].max():.4g}, sign agreement {agree:.6f}")
    if rel > LOGIT_RTOL:
        raise AssertionError(f"U-Net logits differ by {rel:.3g} of the "
                             f"logit scale (bound {LOGIT_RTOL})")
    return rel


def phase_segmentation(root: str) -> dict:
    from imageprocess_tpu.core import roiio
    from imageprocess_tpu.segment.auto import AutoSegConfig, _unet_model
    from imageprocess_tpu.segment.cellseg import segment_frame_labels
    from imageprocess_tpu.segment.evalseg import match_instances

    seg_dir = os.path.join(root, "seg")
    frame, truth = _seg_frame(seg_dir)
    rel = _forward_vs_cpu(frame)

    argv = ["roi-auto", seg_dir, "--backend", "unet", "--checkpoint",
            "general", "--min-size-px", str(SEG_MIN_SIZE_PX), "--lang", "en"]
    cold = cli(argv)
    warm = cli(argv)
    log(f"roi-auto: first call {cold:.2f} s, warm call {warm:.2f} s, "
        f"compile ~{cold - warm:.2f} s")
    pred = roiio.load_roi_polygons(os.path.join(seg_dir, "roi", "S01.json"))
    m = match_instances(pred, truth, frame.shape, iou_threshold=0.3)
    log(f"segmentation: {len(pred)} polygons, {len(truth)} true cells, "
        f"recall {m['recall']:.4f}, mean IoU {m['mean_iou']:.4f} "
        f"(floors {SEG_MIN_RECALL}, {SEG_MIN_IOU})")
    if m["recall"] < SEG_MIN_RECALL or m["mean_iou"] < SEG_MIN_IOU:
        raise AssertionError(f"segmentation below the floors: {m}")

    cfg = AutoSegConfig(backend="unet", checkpoint="general",
                        min_size_px=SEG_MIN_SIZE_PX)
    apply_fn, params, tile = _unet_model(cfg)
    labels, over = segment_frame_labels(
        frame, apply_fn, params, tile=tile, min_size_px=SEG_MIN_SIZE_PX,
        max_labels=cfg.max_labels)
    n_lab = int(np.asarray(labels).max())
    log(f"label map: {n_lab} labels, overflow {bool(over)} "
        f"(max_labels {cfg.max_labels})")
    if bool(over) or n_lab > cfg.max_labels:
        raise AssertionError("device label map overflowed")
    return {"cold_s": cold, "warm_s": warm, "recall": m["recall"],
            "mean_iou": m["mean_iou"], "logit_rel": rel}


def phase_multi(root: str, data_dir: str, n: int) -> None:
    """Intensity and roi-auto over *n* devices vs one device."""
    import jax

    devs = jax.devices()[:n]
    if len(devs) < n:
        raise SystemExit(f"--devices {n}: only {len(devs)} device(s)")
    outs = {}
    for k in (1, n):
        out = os.path.join(root, f"int_d{k}")
        argv = ["intensity", data_dir, "--channels", *map(str, CHANNELS),
                "--batched", "--devices", str(k), "--out", out, "--lang", "en"]
        cold = cli(argv)
        warm = cli(argv)
        log(f"intensity --devices {k}: first call {cold:.2f} s, warm call "
            f"{warm:.2f} s")
        with open(os.path.join(out, "xls", "fluor_intensity_perROI.csv"),
                  "rb") as f:
            outs[k] = f.read()
    if outs[1] != outs[n]:
        a = list(csv.DictReader(outs[1].decode().splitlines()))
        b = list(csv.DictReader(outs[n].decode().splitlines()))
        cols = sorted({k for ra, rb in zip(a, b) for k in ra
                       if ra[k] != rb.get(k)})
        raise AssertionError(f"intensity CSV differs between --devices 1 "
                             f"and --devices {n}: {len(a)} vs {len(b)} "
                             f"rows, differing columns {cols}")
    log(f"intensity CSV identical for --devices 1 and {n} "
        f"({len(outs[1])} bytes)")

    from imageprocess_tpu.core import roiio

    # one frame per device, so every device segments one
    seg_dir = os.path.join(root, "seg")
    stages = [f"S{i + 1:02d}" for i in range(n)]
    for i in range(n):
        _seg_frame(seg_dir, i)
    polys = {}
    for k in (1, n):
        roi = os.path.join(root, f"roi_d{k}")
        argv = ["roi-auto", seg_dir, "--backend", "unet", "--checkpoint",
                "general", "--min-size-px", str(SEG_MIN_SIZE_PX),
                "--devices", str(k), "--lang", "en"]
        cold = cli(argv)
        warm = cli(argv)
        log(f"roi-auto --devices {k}: first call {cold:.2f} s, warm call "
            f"{warm:.2f} s")
        shutil.copytree(os.path.join(seg_dir, "roi"), roi)
        shutil.rmtree(os.path.join(seg_dir, "roi"))
        polys[k] = [roiio.load_roi_polygons(os.path.join(roi, f"{s}.json"))
                    for s in stages]
    for s, a, b in zip(stages, polys[1], polys[n]):
        if len(a) != len(b) or not all(
                np.array_equal(p, q) for p, q in zip(a, b)):
            n_diff = sum(not np.array_equal(p, q) for p, q in zip(a, b))
            raise AssertionError(
                f"roi-auto {s} polygons differ between --devices 1 and "
                f"--devices {n}: {len(a)} vs {len(b)} polygons, {n_diff} "
                f"differ")
    log(f"roi-auto polygons equal for --devices 1 and {n} "
        f"({sum(map(len, polys[1]))} polygons in {n} frames)")

    # the --devices 1 runs use device 0 only, so a peak of at least 1 MiB
    # on every other device shows that the multi-device runs placed work
    # there (one frame's U-Net tile batch alone is far larger)
    stats = [d.memory_stats() for d in devs]
    if None in stats and devs[0].platform != "gpu":
        log(f"no allocator statistics on {devs[0].platform}: placement "
            f"not checked")
        return
    peaks = [s.get("peak_bytes_in_use", 0) for s in stats]
    log(f"peak bytes in use per device: {peaks}")
    if min(peaks) < 1 << 20:
        raise AssertionError(f"not every device held buffers: {peaks}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=1, metavar="N",
                    help="run only the multi-device path over N devices")
    ap.add_argument("--trace", default=None, metavar="DIR",
                    help="profile the warm intensity run into DIR")
    ap.add_argument("--workdir", default=None,
                    help="keep data and outputs here (default: a temporary "
                         "directory, removed at exit)")
    args = ap.parse_args(argv)

    t_all = time.perf_counter()
    devs = phase_device()
    phase_native()
    root = args.workdir or tempfile.mkdtemp(prefix="ip_smoke_")
    try:
        data_dir = os.path.join(root, "data")
        phase_data(data_dir)
        if args.devices > 1:
            phase_multi(root, data_dir, args.devices)
            count = args.devices
        else:
            phase_intensity(data_dir, os.path.join(root, "int"), args.trace)
            phase_fret(data_dir, os.path.join(root, "fret"))
            phase_segmentation(root)
            count = 1
    finally:
        if args.workdir is None:
            shutil.rmtree(root, ignore_errors=True)
    log(f"all phases passed in {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

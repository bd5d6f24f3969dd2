#!/usr/bin/env python
"""Throughput benchmark: end-to-end intensity-pipeline throughput on 16-bit
LZW TIFF stacks (decode -> rasterize -> BG -> per-ROI stats -> CSV), plus
the device-only, decode-only, FRET and U-Net segmentation rates.

Runs on the ambient GPU and prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "Mpix/s", "vs_baseline": N, ...,
   "platform": "gpu", "device_kind": ..., "device_count": N,
   "card": "<nvidia-smi name, power limit>"}
It exits non-zero, printing no result, when JAX finds no GPU: a number
from another backend is never reported under these names.

Baseline: the reference's only measured number — 0.8 Mpix/s end-to-end for
the same workload shape on the author's CPU (BASELINE.md: 8 s for 1 stage,
18 ROIs, 2 channels of 2048x1536 u16 LZW, XLS on).
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

H, W = 1536, 2048
# 16 stages / batch 4 = 4 chunks per run, so the streaming runner actually
# pipelines: decode of chunk k+1 overlaps device work of chunk k
N_STAGES = int(os.environ.get("IP_BENCH_STAGES", "16"))
CHANNELS = (2, 3)
N_ROIS = 18
DATA_DIR = os.environ.get(
    "IP_BENCH_DATA", os.path.join(tempfile.gettempdir(),
                                  f"ip_bench_data_{N_STAGES}"))

BASELINE_MPIX_S = 0.8  # Mpix/s, BASELINE.md reference log

# every sub-metric measured so far
RESULTS = {}


def card_line() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` for the first card — the
    card's name and power limit, which every number here is quoted with."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"
    return out.strip().splitlines()[0] if out.strip() else "nvidia-smi: no card"


def require_gpu():
    """The JAX devices, or SystemExit(2) when the first is not a GPU."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"no GPU: JAX's first device is {devs[0].platform!r}"
                         f" ({devs[0].device_kind}); refusing to measure")
    return devs


def device_fields(devs) -> dict:
    return {"platform": devs[0].platform, "device_kind": devs[0].device_kind,
            "device_count": len(devs), "card": card_line()}


def _json_line(value: float, **extra) -> str:
    d = {
        "metric": "intensity_e2e_throughput",
        "value": round(value, 2),
        "unit": "Mpix/s",
        "vs_baseline": round(value / BASELINE_MPIX_S, 2),
        "rois_per_s": round(RESULTS.get("rois_per_s", 0.0), 1),
        # the device's own Mpix/s at bench shapes, decode excluded
        "device_mpix_s": round(RESULTS.get("device_mpix_s", 0.0), 1),
        # host decode ceiling (native batch LZW decode, same dataset)
        "decode_mpix_s": round(RESULTS.get("decode_mpix_s", 0.0), 1),
        # second workload: ratiometric FRET tables on the same stack
        "fret_e2e_mpix_s": round(RESULTS.get("fret_e2e_mpix_s", 0.0), 2),
        # host load sampled before the bench's own threads run: host-bound
        # numbers scale down ~1/(1+load) on a shared host
        "host_load": RESULTS.get("host_load", 0.0),
        "host_cpus": os.cpu_count(),
    }
    if "seg_mpix_s" in RESULTS:
        # fused U-Net instance-segmentation program (reference counterpart:
        # CPU Cellpose at ~0.01-0.05 Mpix/s)
        d["seg_mpix_s"] = round(RESULTS["seg_mpix_s"], 3)
    d.update(extra)
    return json.dumps(d)


def synthetic_polygons(n: int = N_ROIS):
    """The bench's ROI set: *n* 24-vertex circles of radius 60 on a
    200 x 300 px grid, the same on every stage.  Vertices are whole
    pixels, like ImageJ polygon ROIs."""
    th = np.linspace(0, 2 * np.pi, 24, endpoint=False)
    return [
        np.round(np.stack([
            150 + 200 * (i % 8) + 60 * np.cos(th),
            150 + 300 * (i // 8) + 60 * np.sin(th),
        ], -1))
        for i in range(n)
    ]


def _make_dataset(data_dir: str = DATA_DIR, n_stages: int = N_STAGES,
                  h: int = H, w: int = W):
    """Synthesize an *n_stages* x 2-channel u16 LZW TIFF experiment
    (``S##_<ch>.TIF``: 20 Gaussian blobs on Gaussian noise, seed 42) with
    :func:`synthetic_polygons` as every stage's ROI bundle."""
    from PIL import Image

    from imageprocess_tpu.core import roiio

    os.makedirs(os.path.join(data_dir, "roi"), exist_ok=True)
    rng = np.random.default_rng(42)
    H, W = h, w
    yy, xx = np.mgrid[0:H, 0:W]
    for s in range(1, n_stages + 1):
        for ch in CHANNELS:
            blobs = np.zeros((H, W), np.float32)
            for _ in range(20):
                cy, cx = rng.integers(100, H - 100), rng.integers(100, W - 100)
                r = rng.integers(20, 60)
                blobs += 3000.0 * np.exp(
                    -((yy - cy) ** 2 + (xx - cx) ** 2) / (2.0 * r * r)
                )
            img = (blobs + rng.normal(120, 15, (H, W))).clip(0, 65535).astype(np.uint16)
            Image.fromarray(img).save(
                os.path.join(data_dir, f"S{s:02d}_{ch}.TIF"),
                format="TIFF", compression="tiff_lzw",
            )
    polys = synthetic_polygons()
    for s in range(1, n_stages + 1):
        roiio.save_roi_bundle(
            os.path.join(data_dir, "roi", f"S{s:02d}.json"),
            f"S{s:02d}", (H, W), polys,
        )


def _device_only_mpix_s(reps: int | None = None) -> float:
    """Chip-efficiency metric: time the batched tiled intensity program on a
    pre-decoded, device-resident batch (decode and host I/O excluded).
    Separates device throughput from the host decode wall.

    The batch is tiled up to the streaming runner's autoscaler cap
    (IP_BENCH_DEVICE_B, default 32 frames/dispatch — the chunk size
    production reaches when the loader outruns the device)."""
    import glob

    import jax
    import jax.numpy as jnp

    from imageprocess_tpu.core import roiio
    from imageprocess_tpu.native import decode_tiff_batch
    from imageprocess_tpu.ops.percentile import p1000_of
    from imageprocess_tpu.ops.roistats import (
        choose_tile, pad_local_polys, tile_offsets,
    )
    from imageprocess_tpu.parallel.runner import batched_intensity_step_tiled

    if reps is None:
        reps = int(os.environ.get("IP_BENCH_DEVICE_REPS", "20"))
    paths = sorted(glob.glob(os.path.join(DATA_DIR, "S*.TIF")))
    frames = decode_tiff_batch(paths)
    if frames is None:
        raise RuntimeError("native TIFF decoder unavailable")
    B = int(os.environ.get("IP_BENCH_DEVICE_B", "32"))
    C = len(CHANNELS)
    imgs_b = frames.reshape(N_STAGES, C, H, W)
    if B != N_STAGES:  # tile the decoded stages up to the cap batch
        imgs_b = np.tile(imgs_b, ((B + N_STAGES - 1) // N_STAGES, 1, 1, 1))[:B]
    polys = roiio.load_roi_polygons(os.path.join(DATA_DIR, "roi", "S01.json"))
    tile = choose_tile(polys, H, W)
    nb = ((len(polys) + 7) // 8) * 8
    vb = ((max(len(p) for p in polys) + 31) // 32) * 32
    offs = tile_offsets(polys, H, W, tile)
    lp, off_pad, valid = pad_local_polys(polys, offs, nb, vb)
    lp_b = np.broadcast_to(lp, (B,) + lp.shape)
    off_b = np.broadcast_to(off_pad, (B,) + off_pad.shape)
    val_b = np.broadcast_to(valid, (B,) + valid.shape)
    p_b = np.full((B, C), p1000_of(1.0), np.int32)

    args = [jax.device_put(jnp.asarray(a))
            for a in (imgs_b, lp_b, off_b, val_b, p_b)]

    def step():
        jax.block_until_ready(
            batched_intensity_step_tiled(*args, tile=tile))

    step()  # compile
    mpix = B * C * H * W / 1e6
    best = 0.0
    for _ in range(reps):
        t0 = time.perf_counter()
        step()
        best = max(best, mpix / (time.perf_counter() - t0))
    return best


def _decode_only_mpix_s(reps: int = 7) -> float:
    """Host decode ceiling measured with the PRODUCTION call pattern: the
    per-key native batch entry with fused histograms and recycled output
    buffers, exactly what the streaming loader threads execute (a fresh
    np allocation per frame would hide the decoder's rate behind kernel
    page-zeroing)."""
    import glob

    from imageprocess_tpu.native import FrameBufferPool, decode_tiff_batch_hist

    paths = sorted(glob.glob(os.path.join(DATA_DIR, "S*.TIF")))
    keys = [paths[i:i + len(CHANNELS)]
            for i in range(0, len(paths), len(CHANNELS))]
    pool = FrameBufferPool()
    best = 0.0
    for _ in range(reps):
        t0 = time.perf_counter()
        tot = 0
        from imageprocess_tpu.pipelines.intensity import IntensityConfig

        stride = max(1, IntensityConfig().bg_stride)  # production hist stride
        for kp in keys:
            res = decode_tiff_batch_hist(kp, stride, pool=pool)
            if res is None:
                raise RuntimeError("native TIFF decoder unavailable")
            frames, _ = res
            tot += frames.size
            pool.put(frames)
        best = max(best, tot / 1e6 / (time.perf_counter() - t0))
    return best


def _fret_e2e_mpix_s(reps: int | None = None, warm: bool = True) -> float:
    """Second workload metric: two-channel ratiometric FRET tables
    (decode -> host BG/eps -> ROI tiles -> ratio stats -> XLSX) on the same
    dataset, channels 2/3 as donor/acceptor.  ``warm=False`` counts every
    rep (for a later re-sample after the first call paid the compile)."""
    from imageprocess_tpu.pipelines.fret import FretConfig, run_fret_batched

    cfg = FretConfig(donor_ch=CHANNELS[0], acceptor_ch=CHANNELS[1])
    out_root = os.path.join(DATA_DIR, "RES_bench_fret")
    mpix = N_STAGES * 2 * H * W / 1e6
    best = 0.0
    n_rows = 0
    if reps is None:
        reps = int(os.environ.get("IP_BENCH_FRET_REPS", "4"))
    for rep in range(reps):
        shutil.rmtree(out_root, ignore_errors=True)
        t0 = time.perf_counter()
        rows = run_fret_batched(DATA_DIR, cfg, out_root=out_root,
                                log=lambda *_: None, batch_size=4)
        dt = time.perf_counter() - t0
        n_rows = len(rows)
        if rep or not warm:  # rep 0 is compile warm-up on the first call
            best = max(best, mpix / dt)
    if n_rows != N_STAGES * N_ROIS:
        raise RuntimeError(f"fret row count {n_rows} != {N_STAGES * N_ROIS}")
    return best


def _seg_mpix_s() -> float:
    """U-Net instance segmentation throughput on one bench frame — the
    device segmentation path (tiling + forward + recomposition + flow
    labeling on the device, only frame up / labels back).  The reference's
    counterpart is Cellpose at 1-5 min per 3.1 Mpix frame on CPU
    (ROI_auto_drawer.py:198) = 0.01-0.05 Mpix/s."""
    from imageprocess_tpu.native import decode_tiff
    from imageprocess_tpu.segment.auto import AutoSegConfig, _unet_model
    from imageprocess_tpu.segment.cellseg import segment_frame_unet

    frame = decode_tiff(os.path.join(DATA_DIR, f"S01_{CHANNELS[0]}.TIF"))
    if frame is None:
        raise RuntimeError("native TIFF decoder unavailable")
    frame = frame.astype(np.float32)
    cfg = AutoSegConfig(backend="unet")
    apply_fn, params, tile = _unet_model(cfg)
    best = 0.0
    # >=2: rep 0 is compile warm-up and never recorded, so a configured 1
    # would silently yield 0.0 (indistinguishable from a failed run)
    reps = max(2, int(os.environ.get("IP_BENCH_SEG_REPS", "4")))
    for rep in range(reps):
        t0 = time.perf_counter()
        segment_frame_unet(frame, apply_fn, params, tile=tile)
        dt = time.perf_counter() - t0
        if rep:  # rep 0 is compile warm-up
            best = max(best, frame.size / 1e6 / dt)
    return best


def main() -> int:
    devs = require_gpu()
    # sample external load BEFORE our own threads contribute to it
    RESULTS["host_load"] = round(os.getloadavg()[0], 2)

    if not os.path.exists(os.path.join(DATA_DIR, f"S{N_STAGES:02d}_{CHANNELS[-1]}.TIF")):
        shutil.rmtree(DATA_DIR, ignore_errors=True)
        _make_dataset()

    from imageprocess_tpu.pipelines.intensity import (
        IntensityConfig, run_intensity_batched,
    )

    cfg = IntensityConfig(
        channels=CHANNELS,
        channel_colors={2: "Green", 3: "Red"},
        do_xls=True,
    )
    out_root = os.path.join(DATA_DIR, "RES_bench")
    devnull = lambda *_: None
    # decode threads: twice the cores (decode overlaps the main thread's
    # pack/fetch work), at least 8
    workers = max(8, (os.cpu_count() or 1) * 2)
    batch = int(os.environ.get("IP_BENCH_BATCH", "4"))

    def one_run():
        return run_intensity_batched(
            DATA_DIR, cfg, out_root=out_root, log=devnull,
            batch_size=batch, prefetch_workers=workers,
        )

    # warm-up: compile + cache
    t0 = time.perf_counter()
    one_run()
    warm = time.perf_counter() - t0

    # time-budgeted best-of: ALWAYS >=3 steady reps, then keep sampling
    # until the wall budget is spent, so a burst of host noise does not
    # cover every sample
    best = 0.0
    mpix = N_STAGES * len(CHANNELS) * H * W / 1e6
    budget_s = float(os.environ.get(
        "IP_BENCH_BUDGET_S", "45" if warm < 10 else ("20" if warm < 30 else "0")))
    reps = 0
    t_loop = time.perf_counter()
    while reps < 3 or (time.perf_counter() - t_loop < budget_s and reps < 60):
        t0 = time.perf_counter()
        rows = one_run()
        dt = time.perf_counter() - t0
        best = max(best, mpix / dt)
        reps += 1
    if len(rows) != N_STAGES * N_ROIS:
        raise RuntimeError(
            f"intensity row count {len(rows)} != {N_STAGES * N_ROIS}")
    RESULTS["rois_per_s"] = len(rows) * best / mpix

    # decode is sampled at THREE separate points of the run (3 reps each,
    # best-of across all), so one burst of host noise cannot cover them all
    def _sample_decode():
        RESULTS["decode_mpix_s"] = max(RESULTS.get("decode_mpix_s", 0.0),
                                       _decode_only_mpix_s(reps=3))

    _sample_decode()
    RESULTS["device_mpix_s"] = _device_only_mpix_s()
    _sample_decode()
    # fret too is sampled at two separated points (4 reps incl. warm-up,
    # then 2 counted reps after seg)
    RESULTS["fret_e2e_mpix_s"] = _fret_e2e_mpix_s()
    if os.environ.get("IP_BENCH_SEG", "1") == "1":
        RESULTS["seg_mpix_s"] = _seg_mpix_s()
    _sample_decode()
    RESULTS["fret_e2e_mpix_s"] = max(
        RESULTS["fret_e2e_mpix_s"], _fret_e2e_mpix_s(reps=2, warm=False))

    print(_json_line(best, **device_fields(devs)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python
"""Train the GENERALIST segmentation U-Net (unet_general_v1).

Capability being matched: pretrained Cellpose ``cyto3``
(src/ROI_auto_drawer.py:48-67) segments arbitrary cell images out of the
box.  unet_golden_v1 proves same-prep behavior only; this checkpoint
trains on a MIXTURE of appearance domains (models.synthcells: fluor /
dense-touching / inverted / ring / texture, cell radii 6-48 px) plus the
golden manual frame, and must pass BOTH the synthetic cross-domain eval
suite and the real golden held-out bar before being committed
(tests/test_unet_general.py).

Runs on whatever JAX backend is ambient (a GPU; on the CPU a step takes
seconds — use nohup).  Snapshots every 500 steps to
/tmp/unet_general_train/ so long CPU runs are salvageable.

Usage: PYTHONPATH=. python scripts/train_unet_general.py [steps] [out_dir]
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

GOLDEN = "/root/reference/Testsamples/1Flu_Intensity(BCC P0 and P1)/ANA"
DEFAULT_OUT = os.path.join(os.path.dirname(__file__), "..", "imageprocess_tpu",
                           "models", "pretrained", "unet_general_v1")
FEATURES = (16, 32, 64, 128)
TRAIN_TILE = 128          # crop size; inference tiles at 256 (see config)
BATCH = 8
POOL = 160                # pre-generated synthetic frames
FRAME_HW = 384
P_GOLDEN = 0.2            # share of steps drawn from the real golden frame
SNAP_DIR = "/tmp/unet_general_train"


def build_pool(rng):
    """Pre-generate POOL synthetic frames across domains and scales."""
    from imageprocess_tpu.models.synthcells import DOMAINS, frame_arrays, synth_frame

    scales = [(6.0, 16.0), (10.0, 28.0), (18.0, 48.0)]
    pool = []
    t0 = time.time()
    for i in range(POOL):
        dom = DOMAINS[i % len(DOMAINS)]
        r_range = scales[rng.integers(len(scales))]
        img, labels = synth_frame(rng, FRAME_HW, FRAME_HW, dom, r_range=r_range)
        pool.append(frame_arrays(img, labels))
    print(f"pool: {POOL} frames across {len(DOMAINS)} domains "
          f"({time.time() - t0:.0f}s)")
    return pool


def evaluate(params, apply_fn, tile=256):
    """Cross-domain synthetic suite + real golden held-out frame."""
    from imageprocess_tpu.core import roiio, tiffio
    from imageprocess_tpu.models.synthcells import DOMAINS, eval_frame
    from imageprocess_tpu.segment.cellseg import segment_frame_unet
    from imageprocess_tpu.segment.evalseg import match_instances

    rows = {}
    for dom in DOMAINS:
        ev = eval_frame(0, dom)
        pred = segment_frame_unet(ev["img"], apply_fn, params, tile=tile,
                                  min_size_px=100)
        m = match_instances(pred, ev["polys"], ev["img"].shape,
                            iou_threshold=0.3)
        rows[dom] = m
        print(f"  {dom:9s} {len(pred):3d} pred vs {len(ev['polys']):3d} gt — "
              f"recall {m['recall']:.2f} meanIoU {m['mean_iou']:.3f}")
    ev_img = tiffio.read_2d(os.path.join(GOLDEN, "e1_P0", "S01_4.TIF"))
    ev_polys = roiio.load_roi_polygons(
        os.path.join(GOLDEN, "e1_P0", "roi", "S01.json"))
    pred = segment_frame_unet(np.asarray(ev_img), apply_fn, params, tile=tile,
                              min_size_px=200)
    m = match_instances(pred, ev_polys, ev_img.shape, iou_threshold=0.3)
    rows["golden_e1_P0"] = m
    print(f"  golden    {len(pred):3d} pred vs {len(ev_polys):3d} gt — "
          f"recall {m['recall']:.2f} meanIoU {m['mean_iou']:.3f}")
    return rows


def main():
    steps = int(sys.argv[1]) if len(sys.argv) > 1 else 2500
    out = os.path.abspath(sys.argv[2] if len(sys.argv) > 2 else DEFAULT_OUT)
    import jax

    # IP_TRAIN_BACKEND=cpu trains on the host even where a GPU is present
    if os.environ.get("IP_TRAIN_BACKEND"):
        jax.config.update("jax_platforms", os.environ["IP_TRAIN_BACKEND"])
    import jax.numpy as jnp

    from imageprocess_tpu.core import roiio, tiffio
    from imageprocess_tpu.models.golden import frame_training_arrays, sample_crops
    from imageprocess_tpu.models.train import (TrainConfig, create_train_state,
                                               train_step)
    from imageprocess_tpu.models.unet import UNet

    print("backend:", jax.devices()[0])
    rng = np.random.default_rng(7)

    img = tiffio.read_2d(os.path.join(GOLDEN, "e2_P1", "S01_4.TIF"))
    polys = roiio.load_roi_polygons(os.path.join(GOLDEN, "e2_P1", "roi",
                                                 "S01.json"))
    golden = frame_training_arrays(np.asarray(img, np.float32), polys)
    pool = build_pool(rng)

    cfg = TrainConfig(features=FEATURES, tile=TRAIN_TILE, batch_size=BATCH,
                      decay_steps=steps)
    state = create_train_state(cfg, jax.random.PRNGKey(0))
    os.makedirs(SNAP_DIR, exist_ok=True)

    def save(params, path):
        os.makedirs(path, exist_ok=True)
        flat, _ = jax.tree_util.tree_flatten_with_path(params)
        np.savez_compressed(
            os.path.join(path, "params.npz"),
            **{jax.tree_util.keystr(k): np.asarray(v) for k, v in flat})
        with open(os.path.join(path, "config.json"), "w") as f:
            json.dump({"features": list(FEATURES), "tile": 256,
                       "train_tile": TRAIN_TILE, "steps": steps,
                       "train": "synthcells 5-domain mixture + e2_P1/S01_4",
                       "p_golden": P_GOLDEN}, f, indent=1)

    t0 = time.time()
    ema = None
    for i in range(steps):
        src = golden if rng.random() < P_GOLDEN else pool[rng.integers(len(pool))]
        imgs, pb, fb = sample_crops(rng, *src, TRAIN_TILE, BATCH)
        state, loss = train_step(state, jnp.asarray(imgs), jnp.asarray(pb),
                                 jnp.asarray(fb), w_grad=cfg.grad_loss_weight)
        if i % 50 == 0 or i == steps - 1:
            l = float(loss)
            ema = l if ema is None else 0.9 * ema + 0.1 * l
            print(f"step {i}: loss {l:.4f} (ema {ema:.4f}, "
                  f"{time.time() - t0:.0f}s)", flush=True)
        if i and i % 500 == 0:
            save(jax.device_get(state.params),
                 os.path.join(SNAP_DIR, f"step{i}"))

    params = jax.device_get(state.params)
    save(params, out)
    print("saved", out)

    model = UNet(features=FEATURES)
    evaluate(params, model.apply)


if __name__ == "__main__":
    main()

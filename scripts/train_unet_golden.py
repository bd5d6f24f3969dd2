#!/usr/bin/env python
"""Train the segmentation U-Net on the golden manual ROIs and persist the
checkpoint used by the `roi-auto --method unet` path.

Train frame: e2_P1/S01_4.TIF (11 hand-drawn cells); held-out eval frame:
e1_P0/S01_4.TIF (18 cells) — the ROIs were drawn on channel 4
(roi/S01.json view_params.selected_channel).  Runs on whatever JAX backend
is ambient (a GPU; the CPU works but is slow).

Usage: PYTHONPATH=. python scripts/train_unet_golden.py [steps]
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

GOLDEN = "/root/reference/Testsamples/1Flu_Intensity(BCC P0 and P1)/ANA"
OUT = os.path.join(os.path.dirname(__file__), "..", "imageprocess_tpu",
                   "models", "pretrained", "unet_golden_v1")
FEATURES = (16, 32, 64, 128)
TILE = 256
BATCH = 8


def main():
    steps = int(sys.argv[1]) if len(sys.argv) > 1 else 1200
    import jax
    import jax.numpy as jnp

    from imageprocess_tpu.core import roiio, tiffio
    from imageprocess_tpu.models.golden import (
        frame_training_arrays, sample_crops,
    )
    from imageprocess_tpu.models.train import (
        TrainConfig, create_train_state, train_step,
    )
    from imageprocess_tpu.models.unet import UNet
    from imageprocess_tpu.segment.cellseg import segment_frame_unet
    from imageprocess_tpu.segment.evalseg import match_instances

    img = tiffio.read_2d(os.path.join(GOLDEN, "e2_P1", "S01_4.TIF"))
    polys = roiio.load_roi_polygons(os.path.join(GOLDEN, "e2_P1", "roi",
                                                 "S01.json"))
    print(f"train frame {img.shape}, {len(polys)} cells; backend:",
          jax.devices()[0])
    x, probs, flows = frame_training_arrays(img.astype(np.float32), polys)

    cfg = TrainConfig(features=FEATURES, tile=TILE, batch_size=BATCH,
                      decay_steps=steps)
    state = create_train_state(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    t0 = time.time()
    for i in range(steps):
        imgs, pb, fb = sample_crops(rng, x, probs, flows, TILE, BATCH)
        state, loss = train_step(state, jnp.asarray(imgs), jnp.asarray(pb),
                                 jnp.asarray(fb),
                                 w_grad=cfg.grad_loss_weight)
        if i % 100 == 0 or i == steps - 1:
            print(f"step {i}: loss {float(loss):.4f} "
                  f"({time.time() - t0:.0f}s)")

    params = jax.device_get(state.params)
    os.makedirs(OUT, exist_ok=True)
    flat, _ = jax.tree_util.tree_flatten_with_path(params)
    np.savez_compressed(
        os.path.join(OUT, "params.npz"),
        **{jax.tree_util.keystr(k): np.asarray(v) for k, v in flat})
    import json
    with open(os.path.join(OUT, "config.json"), "w") as f:
        json.dump({"features": list(FEATURES), "tile": TILE,
                   "steps": steps, "train": "e2_P1/S01_4.TIF"}, f, indent=1)
    print("saved", OUT)

    # held-out eval: e1_P0 (18 cells)
    model = UNet(features=FEATURES)
    ev_img = tiffio.read_2d(os.path.join(GOLDEN, "e1_P0", "S01_4.TIF"))
    ev_polys = roiio.load_roi_polygons(os.path.join(GOLDEN, "e1_P0", "roi",
                                                    "S01.json"))
    pred = segment_frame_unet(np.asarray(ev_img), model.apply, params,
                              tile=TILE, min_size_px=200)
    m = match_instances(pred, ev_polys, ev_img.shape, iou_threshold=0.3)
    print(f"eval e1_P0: {len(pred)} predicted vs {len(ev_polys)} golden — "
          f"mean IoU {m['mean_iou']:.3f}, recall {m['recall']:.2f}, "
          f"precision {m['precision']:.2f}")


if __name__ == "__main__":
    main()

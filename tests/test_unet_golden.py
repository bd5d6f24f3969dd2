"""Learned segmentation quality bar on REAL golden data.

The committed checkpoint (models/pretrained/unet_golden_v1, trained by
scripts/train_unet_golden.py on e2_P1's 11 manual cells) must segment the
HELD-OUT golden frame e1_P0/S01_4.TIF: every manual polygon in the tested
region is recovered with high IoU.  This is the quality role the reference
delegates to pretrained Cellpose (src/ROI_auto_drawer.py:203,241).

Precision is not asserted: the manual annotation covers 18 of the many
cells in frame, so extra (unannotated-cell) detections are expected.
Full-frame numbers from the committed training run (2500 steps with
warmup-cosine lr decay):
43 predicted vs 18 golden — mean IoU 0.923, recall 1.00.
"""

import os

import numpy as np
import pytest

CKPT = os.path.join(os.path.dirname(__file__), "..", "imageprocess_tpu",
                    "models", "pretrained", "unet_golden_v1")
FEATURES = (16, 32, 64, 128)


@pytest.fixture(scope="module")
def golden_eval(golden_intensity_dir):
    from imageprocess_tpu.core import roiio, tiffio

    img = np.asarray(tiffio.read_2d(
        os.path.join(golden_intensity_dir, "e1_P0", "S01_4.TIF")))
    polys = roiio.load_roi_polygons(
        os.path.join(golden_intensity_dir, "e1_P0", "roi", "S01.json"))
    return img, polys


def test_unet_segments_golden_frame(golden_eval):
    """Full held-out frame (~26 s CPU inference): all 18 golden cells
    recovered at IoU >= 0.3 with mean matched IoU >= 0.8, and >= 90% of
    them at the stricter IoU >= 0.5 (measured: recall 1.0 / mean 0.887 at
    0.3; recall 0.94 / mean 0.913 at 0.5)."""
    import jax
    import jax.numpy as jnp

    from imageprocess_tpu.models.checkpoint import load_checkpoint
    from imageprocess_tpu.models.unet import UNet
    from imageprocess_tpu.segment.cellseg import segment_frame_unet
    from imageprocess_tpu.segment.evalseg import match_instances

    if not os.path.exists(os.path.join(CKPT, "params.npz")):
        pytest.fail("committed checkpoint missing: " + CKPT)

    img, polys = golden_eval
    model = UNet(features=FEATURES)
    like = model.init(jax.random.PRNGKey(0),
                      jnp.zeros((1, 256, 256, 1), jnp.float32))
    params = load_checkpoint(CKPT, like)

    pred = segment_frame_unet(img, model.apply, params, tile=256,
                              min_size_px=200)
    loose = match_instances(pred, polys, img.shape, iou_threshold=0.3)
    assert loose["recall"] == 1.0, (len(pred), loose)
    assert loose["mean_iou"] >= 0.8, loose
    strict = match_instances(pred, polys, img.shape, iou_threshold=0.5)
    assert strict["recall"] >= 0.9, strict


@pytest.fixture(scope="module")
def perturb_eval(golden_eval):
    """7-cell held-out eval window (rows 0:768, cols 1024:2048 of S01_4)
    with its golden polygons shifted to crop coordinates, plus the loaded
    model.  A quadrant keeps each perturbed inference ~15 s instead of the
    ~40 s full frame while still scoring 7 real manual cells."""
    import jax
    import jax.numpy as jnp

    from imageprocess_tpu.models.checkpoint import load_checkpoint
    from imageprocess_tpu.models.unet import UNet

    img, polys = golden_eval
    Y0, Y1, X0, X1 = 0, 768, 1024, 2048
    crop = img[Y0:Y1, X0:X1].astype(np.float32)
    keep = [i for i, p in enumerate(polys)
            if p[:, 0].min() >= X0 + 20 and p[:, 0].max() < X1 - 20
            and p[:, 1].min() >= Y0 + 20 and p[:, 1].max() < Y1 - 20]
    cp = [polys[i] - np.array([X0, Y0]) for i in keep]
    assert len(cp) == 7, keep

    model = UNet(features=FEATURES)
    like = model.init(jax.random.PRNGKey(0),
                      jnp.zeros((1, 256, 256, 1), jnp.float32))
    params = load_checkpoint(CKPT, like)
    return crop, cp, model, params


def _perturb(name, img, rng):
    sd, mean, mx = float(img.std()), float(img.mean()), float(img.max())
    if name == "gauss_noise":
        return img + rng.normal(0, 0.25 * sd, img.shape).astype(np.float32)
    if name == "poisson":  # photon-limited resample of the raw counts
        return rng.poisson(np.maximum(img, 0)).astype(np.float32)
    if name == "contrast_-30":
        return mean + (img - mean) * 0.7
    if name == "gamma_0.7":
        return ((img / mx) ** 0.7 * mx).astype(np.float32)
    if name == "gamma_1.4":
        return ((img / mx) ** 1.4 * mx).astype(np.float32)
    raise AssertionError(name)


@pytest.mark.parametrize("pert", ["gauss_noise", "poisson", "contrast_-30",
                                  "gamma_0.7", "gamma_1.4"])
def test_unet_robust_to_photometric_perturbations(perturb_eval, pert):
    """Robustness floor for the committed checkpoint: the capability being
    matched is pretrained-Cellpose generality (ROI_auto_drawer.py:48-67),
    so the golden bar alone (one clean frame, same prep as training) is not
    enough — v1 must also hold under photometric corruption.  Bars set
    from the measured margins (recall 7/7 on every perturbation, mean IoU
    0.846-0.940): >=6/7 recovered at IoU>=0.3, mean matched IoU >=0.75."""
    from imageprocess_tpu.segment.cellseg import segment_frame_unet
    from imageprocess_tpu.segment.evalseg import match_instances

    crop, cp, model, params = perturb_eval
    img = _perturb(pert, crop, np.random.default_rng(42))
    pred = segment_frame_unet(img, model.apply, params, tile=256,
                              min_size_px=200)
    m = match_instances(pred, cp, img.shape, iou_threshold=0.3)
    assert m["recall"] * len(cp) >= 6, (pert, m)
    assert m["mean_iou"] >= 0.75, (pert, m)


@pytest.mark.parametrize("scale", [0.75, 1.5])
def test_unet_robust_to_scale(perturb_eval, scale):
    """Magnification robustness: resample the eval window and its golden
    polygons together (measured: recall 7/7, mean IoU 0.937 / 0.812)."""
    from scipy.ndimage import zoom

    from imageprocess_tpu.segment.cellseg import segment_frame_unet
    from imageprocess_tpu.segment.evalseg import match_instances

    crop, cp, model, params = perturb_eval
    img = zoom(crop, scale, order=1).astype(np.float32)
    ps = [p * scale for p in cp]
    pred = segment_frame_unet(img, model.apply, params, tile=256,
                              min_size_px=int(200 * scale * scale))
    m = match_instances(pred, ps, img.shape, iou_threshold=0.3)
    assert m["recall"] * len(ps) >= 6, (scale, m)
    assert m["mean_iou"] >= 0.75, (scale, m)


def test_roi_auto_unet_default_checkpoint(golden_eval, tmp_path):
    """`roi-auto --method unet` with no explicit weights resolves the
    bundled golden checkpoint and produces ROI JSONs on a real frame crop
    (the round-1 gap: the learned path was never run on real data)."""
    from imageprocess_tpu.core import roiio, tiffio
    from imageprocess_tpu.segment.auto import AutoSegConfig, run_auto_drawer

    img, _ = golden_eval
    tiffio.write_tiff16(str(tmp_path / "S01_4.TIF"),
                        img[384:896, 1024:1536].astype(np.uint16))
    cfg = AutoSegConfig(backend="unet", min_size_px=200)
    written = run_auto_drawer(str(tmp_path), cfg, log=lambda *_: None)
    assert len(written) == 1
    polys = roiio.load_roi_polygons(written[0])
    assert len(polys) >= 1
    assert all(p.shape[1] == 2 for p in polys)

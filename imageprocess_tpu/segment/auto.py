"""Batch automatic cell segmentation — the ROI_auto_drawer replacement.

The reference (src/ROI_auto_drawer.py) runs Cellpose (torch) per image and
converts label masks to polygon JSONs via cv2 external contours with an
area >= 20 px filter (:298-310), writing the drawer's ROI JSON format with
a ``generated_by`` tag (:255-262).

Default device path (BASELINE.json config 3: "automatic
threshold+morphology segmentation on a multi-cell field of view"): one
jitted full-frame program — Gaussian smooth, threshold (percentile or
mu + k*sigma), morphological open/close, hole filling, small-object
removal, connected components — then the same cv2 polygonization and JSON
output.  Cellpose remains available as an optional escape hatch when the
package is importable (it is not part of this environment).
"""

from __future__ import annotations

import os
from collections import deque
from dataclasses import dataclass
from functools import partial
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core import naming, roiio, tiffio
from ..core.i18n import t
from ..morphology.binary import (binary_closing_skimage, binary_dilation,
                                 binary_erosion, disk)
from ..morphology.ccl import fill_holes, label, remove_small_objects
from ..morphology.contours import masks_to_polygons
from ..ops.percentile import masked_quantile
from ..ops.view import gaussian_blur

MIN_POLY_AREA = 20.0  # px, ROI_auto_drawer.py:304


# trained on the golden manual ROIs (scripts/train_unet_golden.py);
# held-out eval e1_P0: mean IoU 0.887, recall 1.00 — see tests/test_unet_golden.py
DEFAULT_UNET_CKPT = os.path.join(
    os.path.dirname(__file__), "..", "models", "pretrained", "unet_golden_v1"
)

# --checkpoint accepts these names as well as paths.  "golden" is the
# same-prep specialist; "general" is the cross-domain generalist trained on
# the synthcells 5-domain mixture (scripts/train_unet_general.py) — the
# Cellpose-cyto3 capability slot (src/ROI_auto_drawer.py:48-67) for data
# that looks nothing like the golden experiments.
NAMED_UNET_CKPTS = {
    "golden": DEFAULT_UNET_CKPT,
    "general": os.path.join(os.path.dirname(__file__), "..", "models",
                            "pretrained", "unet_general_v1"),
}


@dataclass
class AutoSegConfig:
    backend: str = "threshold"       # "threshold" | "unet" | "cellpose"
    channel: Optional[int] = None    # filename channel filter (None = all)
    timelapse: bool = False
    # threshold backend
    smooth_sigma: float = 2.0
    thr_mode: str = "percentile"     # "percentile" | "mean_std"
    thr_percentile: float = 90.0
    thr_k: float = 2.0
    open_radius: int = 2
    close_radius: int = 2
    min_size_px: int = 200
    max_labels: int = 1024
    # unet backend
    checkpoint: Optional[str] = None   # None -> bundled pretrained
    prob_threshold: float = 0.5
    flow_follow: bool = True           # Cellpose-style instance separation
    devices: int = 1                   # >1: frames spread over N devices
    # cellpose backend
    diameter: Optional[float] = None
    model_type: str = "cyto3"
    use_gpu: bool = False
    min_poly_area: float = MIN_POLY_AREA


@partial(jax.jit, static_argnames=(
    "smooth_sigma", "thr_mode", "open_radius", "close_radius", "min_size",
    "max_labels",
))
def auto_segment_step(
    img: jnp.ndarray,
    thr_p1000: jnp.ndarray,
    thr_k: jnp.ndarray,
    *,
    smooth_sigma: float,
    thr_mode: str,
    open_radius: int,
    close_radius: int,
    min_size: int,
    max_labels: int,
):
    """Full-frame threshold+morphology segmentation -> (labels, threshold)."""
    x = img
    if smooth_sigma > 0:
        x = gaussian_blur(x, smooth_sigma)
    finite = jnp.isfinite(x)
    if thr_mode == "mean_std":
        nf = jnp.maximum(finite.sum().astype(jnp.float32), 1.0)
        m = jnp.where(finite, x, 0.0).sum() / nf
        s = jnp.sqrt(jnp.where(finite, (x - m) ** 2, 0.0).sum() / nf)
        thr = m + thr_k * s
    else:
        thr = masked_quantile(jnp.where(finite, x, jnp.inf), finite, thr_p1000)
    bw = (x > thr) & finite
    if open_radius > 0:
        se = disk(open_radius)
        bw = binary_dilation(binary_erosion(bw, se, border_true=False), se)
    if close_radius > 0:
        bw = binary_closing_skimage(bw, disk(close_radius))
    bw = fill_holes(bw)
    if min_size > 0:
        bw = remove_small_objects(bw, min_size, connectivity=1)
    labels, over = label(bw, connectivity=2, max_labels=max_labels,
                         with_overflow=True)
    return labels, thr, over


_UNET_CACHE = {}


def _unet_model(cfg: AutoSegConfig):
    """(apply_fn, params, tile) for the configured checkpoint, cached.
    Called up front by run_auto_drawer so a bad checkpoint path fails the
    RUN with an actionable error instead of being swallowed N times by
    the per-file isolation."""
    import json

    from ..models.checkpoint import load_checkpoint
    from ..models.unet import UNet

    name = cfg.checkpoint or DEFAULT_UNET_CKPT
    ckpt = os.path.abspath(NAMED_UNET_CKPTS.get(name, name))
    if ckpt not in _UNET_CACHE:
        import jax

        with open(os.path.join(ckpt, "config.json")) as f:
            meta = json.load(f)
        tile = int(meta.get("tile", 128))
        model = UNet(features=tuple(meta["features"]))
        # load_checkpoint only needs the params TREE STRUCTURE — eval_shape
        # gives it without running a real forward pass or allocating the
        # adamw moment trees a full TrainState would carry
        template = jax.eval_shape(
            model.init, jax.random.PRNGKey(0),
            jnp.zeros((1, tile, tile, 1), jnp.float32))
        params = load_checkpoint(ckpt, like=template)
        _UNET_CACHE[ckpt] = (model.apply, params, tile)
    return _UNET_CACHE[ckpt]


def _unet_kw(cfg: AutoSegConfig) -> dict:
    return dict(prob_threshold=cfg.prob_threshold,
                min_size_px=cfg.min_size_px, max_labels=cfg.max_labels,
                flow_follow=cfg.flow_follow)


def _unet_segment(img: np.ndarray, cfg: AutoSegConfig) -> List[np.ndarray]:
    """Learned path: bundled (or user) U-Net checkpoint -> tiled inference
    (segment.cellseg) -> polygons."""
    from .cellseg import segment_frame_unet

    apply_fn, params, tile = _unet_model(cfg)
    return segment_frame_unet(img, apply_fn, params, tile=tile,
                              min_poly_area=cfg.min_poly_area,
                              **_unet_kw(cfg))


def _frame_starters(cfg: AutoSegConfig):
    """One callable per device slot: ``start(img)`` begins segmenting a
    frame and returns a callable that waits for its polygons.  The U-Net
    backend with ``devices`` N > 1 gets one slot per device, each running
    the single-device program with its own copy of the weights, so N
    frames are in flight and every frame's polygons are the ones a
    one-device run gives (the multi-device analog of the reference's
    Cellpose GPU batching, ROI_auto_drawer.py:192-203,241)."""
    if cfg.backend != "unet" or cfg.devices <= 1:
        return [lambda img: partial(auto_segment_frame, img, cfg)]
    from ..parallel.runner import make_mesh
    from .cellseg import labels_to_polygons, segment_frame_labels

    apply_fn, params, tile = _unet_model(cfg)

    def slot(device):
        p = jax.device_put(params, device)

        def start(img):
            out = segment_frame_labels(img, apply_fn, p, tile=tile,
                                       device=device, **_unet_kw(cfg))
            return partial(labels_to_polygons, out, cfg.max_labels,
                           cfg.min_poly_area)

        return start

    return [slot(d) for d in make_mesh(cfg.devices).devices.flat]


def auto_segment_frame(img: np.ndarray, cfg: AutoSegConfig) -> List[np.ndarray]:
    """One frame -> list of [x, y] polygons."""
    if cfg.backend == "cellpose":
        return _cellpose_segment(img, cfg)
    if cfg.backend == "unet":
        return _unet_segment(img, cfg)
    labels, _, over = auto_segment_step(
        jnp.asarray(img, jnp.float32),
        jnp.int32(int(round(cfg.thr_percentile * 1000))),
        jnp.float32(cfg.thr_k),
        smooth_sigma=cfg.smooth_sigma, thr_mode=cfg.thr_mode,
        open_radius=cfg.open_radius, close_radius=cfg.close_radius,
        min_size=cfg.min_size_px, max_labels=cfg.max_labels,
    )
    if bool(over):
        raise ValueError(
            f"component count exceeded max_labels={cfg.max_labels} — "
            "labels would alias; raise AutoSegConfig.max_labels")
    return masks_to_polygons(np.asarray(labels), cfg.min_poly_area)


def _cellpose_segment(img: np.ndarray, cfg: AutoSegConfig) -> List[np.ndarray]:
    """Optional Cellpose path (ROI_auto_drawer.py:203-248); requires the
    cellpose package, which is not bundled in this environment."""
    try:
        from cellpose import models  # type: ignore
    except ImportError as e:  # pragma: no cover
        raise RuntimeError(
            "cellpose is not installed; use backend='threshold'"
        ) from e
    model_cls = getattr(models, "CellposeModel", None) or models.Cellpose
    model = model_cls(gpu=cfg.use_gpu, model_type=cfg.model_type)
    out = model.eval(
        img, diameter=cfg.diameter,
        batch_size=4 if cfg.use_gpu else 1, channels=[0, 0],
    )
    masks = out[0]
    return masks_to_polygons(np.asarray(masks), cfg.min_poly_area)


def run_auto_drawer(
    img_dir: str,
    cfg: AutoSegConfig,
    roi_dir: Optional[str] = None,
    log=print,
) -> List[str]:
    """Batch loop (ROI_auto_drawer.py:177-273): segment every matching TIFF
    and write ``roi/S##[_t##].json`` bundles.  Returns written paths."""
    roi_dir = roi_dir or os.path.join(img_dir, "roi")
    os.makedirs(roi_dir, exist_ok=True)
    # fail FAST on configuration errors (bad checkpoint path, missing
    # cellpose package): the per-file isolation below is for data errors
    # and would otherwise swallow the same setup failure once per frame,
    # ending a misconfigured run "successfully" with zero output
    if cfg.backend == "unet":
        _unet_model(cfg)
    elif cfg.backend == "cellpose":
        try:
            import cellpose  # noqa: F401
        except ImportError as e:
            raise RuntimeError(
                "cellpose is not installed; use backend='threshold'"
            ) from e
    files = naming.list_tifs(img_dir)
    written = []
    gen = {
        "cellpose": f"cellpose:{cfg.model_type}",
        "unet": "imageprocess_tpu.unet",
    }.get(cfg.backend, "imageprocess_tpu.auto_threshold")
    starters = _frame_starters(cfg)
    pending = deque()       # frames in flight, oldest first

    def finish_oldest():
        base, tag, shape, wait = pending.popleft()
        try:
            polys = wait()
        except Exception as e:
            log(t("auto_seg_failed").format(name=base, err=e))
            return
        log(t("auto_found").format(tag=tag, count=len(polys)))
        if not polys:
            # the reference writes NO file for 0-cell frames
            # (ROI_auto_drawer.py:253-264) — downstream loops use file
            # presence to mean "annotated"
            return
        out = os.path.join(roi_dir, f"{tag}.json")
        roiio.save_roi_bundle(out, tag, shape, polys, generated_by=gen)
        written.append(out)

    n_started = 0
    for path in files:
        base = os.path.basename(path)
        k = naming.parse_tokens(base, cfg.timelapse, naming.ChannelGrammar.KEYWORD)
        if cfg.channel is not None and k.channel != cfg.channel:
            continue
        # stage-less names fall back to the bare filename, same as the
        # reference's _parse_tokens (ROI_auto_drawer.py:288-296) — a
        # folder without S## tokens still segments
        tag = naming.clean_base_for_save(base, cfg.timelapse,
                                         naming.ChannelGrammar.KEYWORD,
                                         strip_trailing_number_fallback=False)
        # per-file isolation: one corrupt TIFF or a failed inference logs
        # and continues, it doesn't abort the remaining frames
        # (ROI_auto_drawer.py:222-250)
        try:
            img = tiffio.read_2d(path)
        except Exception as e:
            log(t("auto_read_failed").format(name=base, err=e))
            continue
        if img.max() <= img.min():
            log(t("auto_blank_skip").format(name=base))
            continue
        try:
            wait = starters[n_started % len(starters)](img)
        except Exception as e:
            log(t("auto_seg_failed").format(name=base, err=e))
            continue
        n_started += 1
        pending.append((base, tag, img.shape, wait))
        if len(pending) >= len(starters):
            finish_oldest()
    while pending:
        finish_oldest()
    return written

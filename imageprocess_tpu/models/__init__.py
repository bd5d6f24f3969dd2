"""Learned segmentation models — the JAX replacement for the
reference's torch/Cellpose dependency (src/ROI_auto_drawer.py:17-31,
203-248).

``unet``: plain-JAX U-Net emitting a cell-probability map; ``train``: optax
training step, data-parallel over a device mesh; ``data``: synthetic and
pseudo-label dataset generation; ``checkpoint``: orbax persistence."""

from .unet import UNet  # noqa: F401
from .train import (  # noqa: F401
    TrainConfig,
    create_train_state,
    make_sharded_train_step,
    train_step,
)

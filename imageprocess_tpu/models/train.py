"""Training step for the segmentation U-Net.

Loss = sigmoid BCE on the cellprob channel + Dice + L2 on the gradient
head (Cellpose-style flow supervision).  ``make_sharded_train_step`` jits
the FULL step (forward, loss, backward, optax update) with the batch axis
sharded over a 1-D device mesh — pure data parallelism: XLA inserts the
gradient all-reduce (psum) automatically from the sharding annotations.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from functools import partial
from typing import Any, Callable, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .unet import UNet


@dataclass
class TrainConfig:
    features: Tuple[int, ...] = (32, 64, 128, 256)
    lr: float = 1e-3
    weight_decay: float = 1e-4
    grad_loss_weight: float = 0.5
    tile: int = 256          # training crop size (divisible by 2^depth)
    batch_size: int = 8
    # when set, lr follows a linear-warmup + cosine-decay schedule over
    # this many steps (a fixed lr oscillates late in small-data training)
    decay_steps: int = 0
    warmup_steps: int = 100


@partial(jax.tree_util.register_dataclass,
         data_fields=["step", "params", "opt_state"],
         meta_fields=["apply_fn", "tx"])
@dataclass(frozen=True)
class TrainState:
    """Parameters, optimizer state and step count as one pytree; the
    forward function and the optax transformation ride along as static
    metadata (the shape of flax's ``TrainState``)."""

    step: Any
    params: Any
    opt_state: Any
    apply_fn: Callable
    tx: optax.GradientTransformation

    @classmethod
    def create(cls, *, apply_fn, params, tx) -> "TrainState":
        return cls(step=jnp.zeros((), jnp.int32), params=params,
                   opt_state=tx.init(params), apply_fn=apply_fn, tx=tx)

    def apply_gradients(self, *, grads) -> "TrainState":
        updates, opt_state = self.tx.update(grads, self.opt_state, self.params)
        return dataclasses.replace(
            self, step=self.step + 1,
            params=optax.apply_updates(self.params, updates),
            opt_state=opt_state)


def create_train_state(cfg: TrainConfig, rng: jax.Array) -> TrainState:
    model = UNet(features=cfg.features)
    params = model.init(rng, jnp.zeros((1, cfg.tile, cfg.tile, 1),
                                       jnp.float32))
    if cfg.decay_steps:
        lr = optax.warmup_cosine_decay_schedule(
            init_value=cfg.lr * 0.05, peak_value=cfg.lr,
            warmup_steps=min(cfg.warmup_steps, cfg.decay_steps // 10 + 1),
            decay_steps=cfg.decay_steps, end_value=cfg.lr * 0.01)
    else:
        lr = cfg.lr
    tx = optax.adamw(lr, weight_decay=cfg.weight_decay)
    return TrainState.create(apply_fn=model.apply, params=params, tx=tx)


def _loss_fn(params, apply_fn, imgs, probs, grads_t, w_grad):
    out = apply_fn(params, imgs)
    logit = out[..., 0]
    bce = optax.sigmoid_binary_cross_entropy(logit, probs).mean()
    p = jax.nn.sigmoid(logit)
    inter = (p * probs).sum(axis=(1, 2))
    dice = 1.0 - (2 * inter + 1.0) / (p.sum(axis=(1, 2))
                                      + probs.sum(axis=(1, 2)) + 1.0)
    grad_l2 = ((out[..., 1:] - grads_t) ** 2).mean()
    return bce + dice.mean() + w_grad * grad_l2


@partial(jax.jit, static_argnames=("w_grad",))
def train_step(state: TrainState, imgs, probs, grads_t, w_grad: float = 0.5):
    """One optimization step. imgs: (B, T, T, 1) f32; probs: (B, T, T) in
    {0,1}; grads_t: (B, T, T, 2) flow targets."""
    loss, g = jax.value_and_grad(_loss_fn)(
        state.params, state.apply_fn, imgs, probs, grads_t, w_grad
    )
    return state.apply_gradients(grads=g), loss


def make_sharded_train_step(mesh: Mesh, w_grad: float = 0.5) -> Callable:
    """The same full step with batch inputs sharded over *mesh* (DP):
    params/opt-state replicated, batch split, gradients all-reduced by XLA."""
    axis = mesh.axis_names[0]
    data = NamedSharding(mesh, P(axis))
    repl = NamedSharding(mesh, P())

    @partial(jax.jit,
             in_shardings=(repl, data, data, data),
             out_shardings=(repl, repl),
             donate_argnums=(0,))
    def step(state, imgs, probs, grads_t):
        loss, g = jax.value_and_grad(_loss_fn)(
            state.params, state.apply_fn, imgs, probs, grads_t, w_grad
        )
        return state.apply_gradients(grads=g), loss

    return step


def synthetic_batch(rng: np.random.Generator, batch: int, tile: int):
    """Synthetic blob images + masks + flow targets for smoke training and
    the multi-chip dryrun (no data dependency)."""
    imgs = rng.normal(0.1, 0.05, (batch, tile, tile, 1)).astype(np.float32)
    probs = np.zeros((batch, tile, tile), np.float32)
    grads = np.zeros((batch, tile, tile, 2), np.float32)
    yy, xx = np.mgrid[0:tile, 0:tile]
    margin = min(20, tile // 4)
    r_hi = max(5, min(18, tile // 4))
    for b in range(batch):
        for _ in range(rng.integers(2, 5)):
            cy, cx = rng.integers(margin, tile - margin, 2)
            r = rng.integers(max(3, r_hi // 2), r_hi)
            d2 = (yy - cy) ** 2 + (xx - cx) ** 2
            blob = d2 <= r * r
            imgs[b, ..., 0] += 0.8 * np.exp(-d2 / (2.0 * r * r))
            probs[b][blob] = 1.0
            norm = np.sqrt(d2) + 1e-6
            grads[b, ..., 0] = np.where(blob, (cy - yy) / norm, grads[b, ..., 0])
            grads[b, ..., 1] = np.where(blob, (cx - xx) / norm, grads[b, ..., 1])
    return imgs, probs, grads

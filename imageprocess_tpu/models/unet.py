"""U-Net for fluorescence cell segmentation, in plain JAX.

NHWC layout, GroupNorm (batch-size independent, no cross-device sync),
bfloat16 convolutions with float32 params, and a ``cellprob`` + 2-channel
spatial-gradient head like Cellpose's output parameterization.

``UNet`` is a frozen (hashable) dataclass with the ``init(rng, x)`` /
``apply(variables, x)`` interface of a flax.linen module, so ``apply``
can be a static jit argument.  The variables tree keeps flax's key paths
(``['params']['ConvBlock_0']['Conv_0']['kernel']`` ...), so the bundled
``params.npz`` checkpoints load unchanged, and every layer computes what
the flax layer of that name computes (``tests/test_models.py`` checks
the forward against flax where flax is installed).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Sequence

import jax
import jax.numpy as jnp
from jax import lax

_DN = ("NHWC", "HWIO", "NHWC")
_GN_EPS = 1e-6
_lecun_normal = jax.nn.initializers.lecun_normal()


def _conv(p, x, dtype, precision=None):
    """flax ``nn.Conv`` (stride 1, SAME): operands cast to *dtype*, bias
    added in *dtype*."""
    x, k, b = (jnp.asarray(a, dtype) for a in (x, p["kernel"], p["bias"]))
    y = lax.conv_general_dilated(x, k, (1, 1), "SAME",
                                 dimension_numbers=_DN, precision=precision)
    return y + b.reshape(1, 1, 1, -1)


def _conv_transpose(p, x, dtype):
    """flax ``nn.ConvTranspose`` with kernel 2, stride 2, padding SAME."""
    x, k, b = (jnp.asarray(a, dtype) for a in (x, p["kernel"], p["bias"]))
    y = lax.conv_transpose(x, k, (2, 2), "SAME", dimension_numbers=_DN)
    return y + b.reshape(1, 1, 1, -1)


def _group_norm(p, x, num_groups: int):
    """flax ``nn.GroupNorm(dtype=float32)``: float32 statistics by the
    fast-variance formula, result in float32."""
    B, H, W, C = x.shape
    gs = C // num_groups
    xg = x.reshape(B, H, W, num_groups, gs).astype(jnp.float32)
    mu = xg.mean((1, 2, 4))
    mu2 = lax.square(xg).mean((1, 2, 4))
    var = jnp.maximum(0.0, mu2 - lax.square(mu))
    mean = jnp.repeat(mu, gs, axis=-1)[:, None, None, :]
    var = jnp.repeat(var, gs, axis=-1)[:, None, None, :]
    y = x - mean
    mul = lax.rsqrt(var + _GN_EPS) * p["scale"].reshape(1, 1, 1, C)
    y = y * mul
    y = y + p["bias"].reshape(1, 1, 1, C)
    return jnp.asarray(y, jnp.float32)


def _max_pool2(x):
    return lax.reduce_window(x, -jnp.inf, lax.max, (1, 2, 2, 1),
                             (1, 2, 2, 1), "VALID")


def _conv_block(p, x, features: int, dtype):
    for i in range(2):
        x = _conv(p[f"Conv_{i}"], x, dtype)
        x = _group_norm(p[f"GroupNorm_{i}"], x, min(8, features))
        x = jax.nn.relu(x)
    return x


def _init_conv(key, kh, kw, cin, cout):
    return {"kernel": _lecun_normal(key, (kh, kw, cin, cout), jnp.float32),
            "bias": jnp.zeros((cout,), jnp.float32)}


def _init_gn(c):
    return {"scale": jnp.ones((c,), jnp.float32),
            "bias": jnp.zeros((c,), jnp.float32)}


def _init_block(key, cin, cout):
    k0, k1 = jax.random.split(key)
    return {"Conv_0": _init_conv(k0, 3, 3, cin, cout), "GroupNorm_0": _init_gn(cout),
            "Conv_1": _init_conv(k1, 3, 3, cout, cout), "GroupNorm_1": _init_gn(cout)}


@dataclass(frozen=True)
class UNet:
    """Encoder-decoder with skip connections; returns (B, H, W, 3):
    channel 0 = cell probability logit, channels 1..2 = y/x gradient maps.
    H and W must be divisible by 2**len(features)."""

    features: Sequence[int] = (32, 64, 128, 256)
    out_channels: int = 3
    dtype: Any = jnp.bfloat16

    def __post_init__(self):
        object.__setattr__(self, "features", tuple(int(f)
                                                   for f in self.features))

    def init(self, rng: jax.Array, x: jnp.ndarray) -> Dict[str, Any]:
        """Random variables ``{'params': ...}`` for inputs shaped like *x*
        (lecun-normal kernels, zero biases, unit GroupNorm scales)."""
        feats = self.features
        n = len(feats)
        keys = iter(jax.random.split(rng, 3 * n + 2))
        params = {}
        cin = x.shape[-1]
        for i, f in enumerate(feats):
            params[f"ConvBlock_{i}"] = _init_block(next(keys), cin, f)
            cin = f
        params[f"ConvBlock_{n}"] = _init_block(next(keys), cin, 2 * feats[-1])
        cin = 2 * feats[-1]
        for j, f in enumerate(reversed(feats)):
            params[f"ConvTranspose_{j}"] = _init_conv(next(keys), 2, 2, cin, f)
            params[f"ConvBlock_{n + 1 + j}"] = _init_block(next(keys), 2 * f, f)
            cin = f
        params["Conv_0"] = _init_conv(next(keys), 1, 1, cin, self.out_channels)
        return {"params": params}

    def apply(self, variables: Dict[str, Any], x: jnp.ndarray) -> jnp.ndarray:
        p = variables["params"]
        feats = self.features
        n = len(feats)
        x = x.astype(self.dtype)
        skips = []
        for i, f in enumerate(feats):
            x = _conv_block(p[f"ConvBlock_{i}"], x, f, self.dtype)
            skips.append(x)
            x = _max_pool2(x)
        x = _conv_block(p[f"ConvBlock_{n}"], x, 2 * feats[-1], self.dtype)
        for j, (f, skip) in enumerate(zip(reversed(feats), reversed(skips))):
            x = _conv_transpose(p[f"ConvTranspose_{j}"], x, self.dtype)
            x = jnp.concatenate([x, skip], axis=-1)
            x = _conv_block(p[f"ConvBlock_{n + 1 + j}"], x, f, self.dtype)
        # the 1x1 head is declared float32: pin full precision so a GPU
        # does not run it in TF32
        x = _conv(p["Conv_0"], x, jnp.float32,
                  precision=lax.Precision.HIGHEST)
        return x.astype(jnp.float32)

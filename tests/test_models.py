"""Segmentation U-Net: shapes, training convergence smoke, sharded train
step on the 8-device CPU mesh, checkpoint round trip, tiled inference."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from imageprocess_tpu.models import (
    TrainConfig, UNet, create_train_state, make_sharded_train_step, train_step,
)
from imageprocess_tpu.models.train import synthetic_batch


@pytest.fixture(scope="module")
def tiny_cfg():
    return TrainConfig(features=(8, 16), tile=32, batch_size=4, lr=3e-3)


@pytest.fixture(scope="module")
def tiny_state(tiny_cfg):
    return create_train_state(tiny_cfg, jax.random.PRNGKey(0))


def test_unet_output_shape(tiny_state, tiny_cfg):
    x = jnp.zeros((2, tiny_cfg.tile, tiny_cfg.tile, 1))
    out = tiny_state.apply_fn(tiny_state.params, x)
    assert out.shape == (2, tiny_cfg.tile, tiny_cfg.tile, 3)
    assert out.dtype == jnp.float32


def test_train_step_decreases_loss(tiny_state, tiny_cfg):
    rng = np.random.default_rng(0)
    imgs, probs, grads = synthetic_batch(rng, tiny_cfg.batch_size, tiny_cfg.tile)
    state = tiny_state
    losses = []
    for _ in range(12):
        state, loss = train_step(state, jnp.asarray(imgs), jnp.asarray(probs),
                                 jnp.asarray(grads))
        losses.append(float(loss))
    assert losses[-1] < losses[0]
    assert np.isfinite(losses).all()


def test_sharded_train_step(tiny_cfg):
    from jax.sharding import NamedSharding, PartitionSpec as P

    from imageprocess_tpu.parallel.runner import make_mesh

    mesh = make_mesh(8)
    state = create_train_state(tiny_cfg, jax.random.PRNGKey(1))
    state = jax.device_put(state, NamedSharding(mesh, P()))
    step = make_sharded_train_step(mesh)
    rng = np.random.default_rng(1)
    imgs, probs, grads = synthetic_batch(rng, 8, tiny_cfg.tile)
    shard = NamedSharding(mesh, P("batch"))
    state2, loss = step(
        state,
        jax.device_put(jnp.asarray(imgs), shard),
        jax.device_put(jnp.asarray(probs), shard),
        jax.device_put(jnp.asarray(grads), shard),
    )
    assert int(state2.step) == 1 and np.isfinite(float(loss))


@pytest.mark.filterwarnings("ignore:Sharding info not provided")
def test_checkpoint_roundtrip(tiny_state, tmp_path):
    from imageprocess_tpu.models.checkpoint import load_checkpoint, save_checkpoint

    save_checkpoint(str(tmp_path / "ckpt"), tiny_state.params)
    restored = load_checkpoint(str(tmp_path / "ckpt"), like=tiny_state.params)
    leaves_a = jax.tree_util.tree_leaves(tiny_state.params)
    leaves_b = jax.tree_util.tree_leaves(restored)
    assert len(leaves_a) == len(leaves_b)
    for a, b in zip(leaves_a, leaves_b):
        assert np.allclose(np.asarray(a), np.asarray(b))


def test_segment_frame_unet_structural(tiny_state, tiny_cfg):
    """Random-init net: inference machinery produces valid polygon output
    (count depends on weights; shape/typing is what's pinned)."""
    from imageprocess_tpu.segment.cellseg import segment_frame_unet

    img = np.random.default_rng(0).normal(100, 10, (70, 90)).astype(np.float32)
    polys = segment_frame_unet(
        img, tiny_state.apply_fn, tiny_state.params,
        tile=tiny_cfg.tile, overlap=4, min_size_px=5,
    )
    for p in polys:
        assert p.ndim == 2 and p.shape[1] == 2


def test_segment_frame_unet_sharded_matches_single(tiny_state, tiny_cfg):
    """Inference placed on another device (roi-auto --devices N gives
    each device whole frames) returns the same instance polygons as the
    default device, and its label map stays on that device."""
    from imageprocess_tpu.segment.cellseg import (
        segment_frame_labels, segment_frame_unet,
    )

    img = np.random.default_rng(3).normal(100, 20, (96, 130)).astype(np.float32)
    kw = dict(tile=tiny_cfg.tile, overlap=4, min_size_px=5,
              prob_threshold=0.3)
    single = segment_frame_unet(img, tiny_state.apply_fn, tiny_state.params,
                                **kw)
    dev = jax.devices()[-1]
    params = jax.device_put(tiny_state.params, dev)
    placed = segment_frame_unet(img, tiny_state.apply_fn, params,
                                device=dev, **kw)
    assert len(single) == len(placed)
    for a, b in zip(single, placed):
        np.testing.assert_array_equal(a, b)
    labels, _ = segment_frame_labels(img, tiny_state.apply_fn, params,
                                     device=dev, **kw)
    assert labels.devices() == {dev}


@pytest.mark.parametrize("n_dev", [2, 4])
def test_run_auto_drawer_devices_match_one_device(tmp_path, n_dev):
    """roi-auto --devices N spreads whole frames over N devices: every
    frame's ROI file equals the one-device run's, byte for byte."""
    import os
    import shutil

    from imageprocess_tpu.core import tiffio
    from imageprocess_tpu.models.train import synthetic_batch
    from imageprocess_tpu.segment.auto import (
        DEFAULT_UNET_CKPT, AutoSegConfig, run_auto_drawer,
    )

    if not os.path.exists(os.path.join(DEFAULT_UNET_CKPT, "config.json")):
        pytest.skip("bundled checkpoint not present")
    imgs, _, _ = synthetic_batch(np.random.default_rng(7), n_dev + 1, 128)
    for i, im in enumerate(imgs):
        frame = (im[..., 0] * 10000).clip(0, 65535).astype(np.uint16)
        tiffio.write_tiff16(str(tmp_path / f"S{i + 1:02d}_1.TIF"), frame)
    out = {}
    for k in (1, n_dev):
        cfg = AutoSegConfig(backend="unet", min_size_px=30, devices=k)
        logs = []
        written = run_auto_drawer(str(tmp_path), cfg, log=logs.append)
        out[k] = {os.path.basename(w): open(w, "rb").read() for w in written}
        assert len(logs) == n_dev + 1          # one line per frame
        shutil.rmtree(tmp_path / "roi")
    assert out[1] and out[1] == out[n_dev]


def test_pretrained_unet_backend(tmp_path):
    """The bundled checkpoint segments synthetic blob frames end-to-end
    through the auto-drawer unet backend."""
    import os

    from imageprocess_tpu.core import roiio, tiffio
    from imageprocess_tpu.models.train import synthetic_batch
    from imageprocess_tpu.segment.auto import (
        DEFAULT_UNET_CKPT, AutoSegConfig, run_auto_drawer,
    )

    if not os.path.exists(os.path.join(DEFAULT_UNET_CKPT, "config.json")):
        pytest.skip("bundled checkpoint not present")
    imgs, probs, _ = synthetic_batch(np.random.default_rng(5), 1, 128)
    frame = (imgs[0, ..., 0] * 10000).clip(0, 65535).astype(np.uint16)
    tiffio.write_tiff16(str(tmp_path / "S01_1.TIF"), frame)
    cfg = AutoSegConfig(backend="unet", channel=1, min_size_px=30)
    written = run_auto_drawer(str(tmp_path), cfg, log=lambda *_: None)
    assert len(written) == 1
    bundle = roiio.load_roi_bundle(written[0])
    assert bundle["generated_by"] == "imageprocess_tpu.unet"
    n_true = int((probs[0] > 0.5).sum() > 0)
    assert len(bundle["rois"]) >= n_true  # finds at least one blob


# --- plain-JAX U-Net: flax parity, checkpoint layout, train state ---------

BUNDLED = ("unet_golden_v1", "unet_general_v1")


def _ckpt_dir(name):
    import os

    return os.path.join(os.path.dirname(__file__), "..", "imageprocess_tpu",
                        "models", "pretrained", name)


def _ckpt_features(name):
    import json
    import os

    with open(os.path.join(_ckpt_dir(name), "config.json")) as f:
        return tuple(json.load(f)["features"])


def _flax_unet(features):
    """The flax.linen U-Net the plain module replaces (same layer names,
    dtypes and defaults)."""
    nn = pytest.importorskip("flax.linen")

    class ConvBlock(nn.Module):
        features: int

        @nn.compact
        def __call__(self, x):
            for _ in range(2):
                x = nn.Conv(self.features, (3, 3), padding="SAME",
                            dtype=jnp.bfloat16, param_dtype=jnp.float32)(x)
                x = nn.GroupNorm(num_groups=min(8, self.features),
                                 dtype=jnp.float32)(x)
                x = nn.relu(x)
            return x

    class FlaxUNet(nn.Module):
        features: tuple

        @nn.compact
        def __call__(self, x):
            x = x.astype(jnp.bfloat16)
            skips = []
            for f in self.features:
                x = ConvBlock(f)(x)
                skips.append(x)
                x = nn.max_pool(x, (2, 2), strides=(2, 2))
            x = ConvBlock(self.features[-1] * 2)(x)
            for f, skip in zip(reversed(self.features), reversed(skips)):
                x = nn.ConvTranspose(f, (2, 2), strides=(2, 2),
                                     dtype=jnp.bfloat16,
                                     param_dtype=jnp.float32)(x)
                x = jnp.concatenate([x, skip], axis=-1)
                x = ConvBlock(f)(x)
            x = nn.Conv(3, (1, 1), dtype=jnp.float32,
                        param_dtype=jnp.float32)(x)
            return x.astype(jnp.float32)

    return FlaxUNet(features=features)


@pytest.mark.parametrize("name", BUNDLED)
def test_plain_unet_matches_flax_forward(name):
    """Random params (GroupNorm scales/biases perturbed too) in the
    bundled configuration: the plain forward equals flax's."""
    feats = _ckpt_features(name)
    flax_model = _flax_unet(feats)
    x = jax.random.normal(jax.random.PRNGKey(1), (2, 64, 64, 1))
    variables = UNet(features=feats).init(jax.random.PRNGKey(0), x)
    leaves, tdef = jax.tree_util.tree_flatten(variables)
    keys = jax.random.split(jax.random.PRNGKey(2), len(leaves))
    variables = jax.tree_util.tree_unflatten(
        tdef, [v + 0.1 * jax.random.normal(k, v.shape)
               for v, k in zip(leaves, keys)])
    flax_vars = flax_model.init(jax.random.PRNGKey(0), x)
    assert (jax.tree_util.tree_structure(flax_vars)
            == jax.tree_util.tree_structure(variables))
    want = np.asarray(flax_model.apply(variables, x))
    got = np.asarray(UNet(features=feats).apply(variables, x))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", BUNDLED)
def test_bundled_checkpoint_key_paths(name):
    """Both bundled params.npz files hold exactly the key paths of the
    plain module's variables tree, with matching shapes, and load."""
    import os

    from imageprocess_tpu.models.checkpoint import load_checkpoint

    feats = _ckpt_features(name)
    like = jax.eval_shape(UNet(features=feats).init, jax.random.PRNGKey(0),
                          jnp.zeros((1, 256, 256, 1), jnp.float32))
    flat, _ = jax.tree_util.tree_flatten_with_path(like)
    want = {jax.tree_util.keystr(k): v.shape for k, v in flat}
    data = np.load(os.path.join(_ckpt_dir(name), "params.npz"))
    assert {k: data[k].shape for k in data.files} == want
    params = load_checkpoint(_ckpt_dir(name), like=like)
    out = UNet(features=feats).apply(params, jnp.zeros((1, 32, 32, 1)))
    assert out.shape == (1, 32, 32, 3) and np.isfinite(np.asarray(out)).all()


def test_unet_is_a_hashable_static_argument():
    """``apply`` is a jit static argument of the fused segmentation
    program, so the module must be a hashable value: equal configurations
    compare and hash equal whatever sequence type the features came in."""
    a, b = UNet(features=[8, 16]), UNet(features=(8, 16))
    assert a == b and hash(a) == hash(b)
    assert hash(a.apply) == hash(a.apply)
    assert UNet(features=(8, 16)) != UNet(features=(8, 32))


def test_train_state_is_a_pytree(tiny_state):
    """Step, params and optimizer state are leaves; apply_fn and tx are
    static, so the state passes through jit and device_put whole."""
    leaves = jax.tree_util.tree_leaves(tiny_state)
    n_params = len(jax.tree_util.tree_leaves(tiny_state.params))
    assert len(leaves) > 2 * n_params   # params + adamw moments + step
    moved = jax.device_put(tiny_state, jax.devices()[0])
    assert moved.apply_fn == tiny_state.apply_fn and moved.tx is tiny_state.tx
    grads = jax.tree_util.tree_map(jnp.ones_like, tiny_state.params)
    nxt = jax.jit(lambda s, g: s.apply_gradients(grads=g))(tiny_state, grads)
    assert int(nxt.step) == int(tiny_state.step) + 1
    changed = [not np.array_equal(np.asarray(a), np.asarray(b)) for a, b in
               zip(jax.tree_util.tree_leaves(nxt.params),
                   jax.tree_util.tree_leaves(tiny_state.params))]
    assert all(changed)

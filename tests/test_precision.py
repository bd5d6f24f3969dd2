"""Convolutions that claim float32 (scipy/skimage) parity pin
``Precision.HIGHEST``, so a GPU never runs them in TF32 (10 mantissa
bits).  The pin is checked in the lowered program, and each op against
its scipy counterpart at a tight tolerance."""

import numpy as np
import pytest
import scipy.ndimage as ndi

import jax
import jax.numpy as jnp

from imageprocess_tpu.morphology.binary import _conv_count, disk
from imageprocess_tpu.ops.view import gaussian_blur, sobel_magnitude


def _img(seed=0, shape=(64, 80)):
    return np.random.default_rng(seed).random(shape).astype(np.float32) * 1000


def _conv_precisions(fn, *args):
    """Precision configs of every convolution in fn's lowered program."""
    text = jax.jit(fn).lower(*args).as_text()
    convs = [ln for ln in text.splitlines() if "convolution" in ln]
    assert convs, "no convolution in the lowered program"
    return convs


@pytest.mark.parametrize("name", ["gaussian", "sobel", "neighbour_count",
                                  "unet_head"])
def test_f32_convolutions_pin_highest(name):
    x = jnp.asarray(_img())
    if name == "gaussian":
        convs = _conv_precisions(lambda a: gaussian_blur(a, 2.0), x)
    elif name == "sobel":
        convs = _conv_precisions(sobel_magnitude, x)
    elif name == "neighbour_count":
        convs = _conv_precisions(lambda a: _conv_count(a, disk(2)), x)
    else:
        from imageprocess_tpu.models.unet import UNet

        model = UNet(features=(8, 16))
        xb = jnp.zeros((1, 32, 32, 1), jnp.float32)
        params = model.init(jax.random.PRNGKey(0), xb)
        convs = _conv_precisions(model.apply, params, xb)
        # only the float32 1x1 head is pinned; the bf16 body stays default
        convs = [ln for ln in convs if "f32" in ln.split("->")[-1]
                 and "bf16" not in ln]
        assert convs
    for ln in convs:
        assert "HIGHEST" in ln, ln


def test_gaussian_blur_pinned_matches_scipy_tightly():
    x = _img(1)
    ours = np.asarray(gaussian_blur(jnp.asarray(x), 1.5))
    ref = ndi.gaussian_filter(x.astype(np.float64), 1.5)
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-3)


def test_sobel_pinned_matches_scipy_tightly():
    x = _img(2)
    ours = np.asarray(sobel_magnitude(jnp.asarray(x)))
    gx = ndi.sobel(x.astype(np.float64), axis=1, mode="reflect") / 4.0
    gy = ndi.sobel(x.astype(np.float64), axis=0, mode="reflect") / 4.0
    ref = np.hypot(gx, gy) / np.sqrt(2.0)
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-3)


def test_neighbour_count_matches_scipy_exactly():
    rng = np.random.default_rng(3)
    bw = rng.random((40, 52)) > 0.6
    se = disk(3)
    ours = np.asarray(_conv_count(jnp.asarray(bw, jnp.float32), se))
    ref = ndi.correlate(bw.astype(np.int64), se.astype(np.int64),
                        mode="constant", cval=0)
    np.testing.assert_array_equal(ours, ref)

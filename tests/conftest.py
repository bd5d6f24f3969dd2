"""Test harness config.

Correctness CI runs on the JAX CPU backend with 8 virtual devices so the
multi-device sharding paths execute without GPUs.  Must run before the
first ``import jax`` anywhere in the test session.  Tests that need a GPU
carry the ``gpu`` marker and skip here; ``python chip_smoke.py`` runs the
same checks on the card.
"""

import os

# Correctness tests run on the local CPU backend with 8 virtual devices for
# the multi-device sharding paths: (a) switch platforms via jax.config as
# well as the environment (jax may already be imported by a plugin) and
# (b) set XLA_FLAGS before the CPU backend initializes (it's lazy).
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import pytest  # noqa: E402

GOLDEN_INTENSITY = (
    "/root/reference/Testsamples/1Flu_Intensity(BCC P0 and P1)/ANA"
)
GOLDEN_FA = "/root/reference/Testsamples/2FA_BND_INT (251127 FA test sample)/Python/ANA"


@pytest.fixture(scope="session")
def golden_intensity_dir():
    if not os.path.isdir(GOLDEN_INTENSITY):
        pytest.skip("golden intensity samples not available")
    return GOLDEN_INTENSITY


@pytest.fixture(scope="session")
def golden_fa_dir():
    if not os.path.isdir(GOLDEN_FA):
        pytest.skip("golden FA samples not available")
    return GOLDEN_FA

"""u16 tile-stats tier: the sort-free 16-step XLA bisection (production,
via ops.roistats.tile_stats_from_gathered) vs the masked_stats oracle."""

import numpy as np
import pytest

import jax.numpy as jnp

from imageprocess_tpu.ops.stats import STAT_FIELDS, masked_stats
from imageprocess_tpu.ops.tilestats_u16 import tile_stats_u16


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    N, C, t = 6, 2, 64
    tiles = rng.integers(0, 65536, (N, C, t, t)).astype(np.uint16)
    masks = rng.random((N, t, t)) > 0.4
    masks[4] = False         # empty ROI
    masks[5] = False
    masks[5, 0, :3] = True   # nearly-empty ROI (n=3)
    bgs = np.array([120.5, 37.25], np.float32)
    return tiles, masks, bgs


@pytest.mark.parametrize("clip", [True, False])
def test_bisect_matches_masked_stats(data, clip):
    tiles, masks, bgs = data
    got = {k: np.asarray(v) for k, v in tile_stats_u16(
        jnp.asarray(tiles), jnp.asarray(masks), jnp.asarray(bgs),
        clip_neg=clip).items()}
    N, C = tiles.shape[:2]
    for n in range(N):
        for c in range(C):
            xf = tiles[n, c].astype(np.float32) - bgs[c]
            if clip:
                xf = np.maximum(xf, 0)
            want = {k: np.asarray(v) for k, v in masked_stats(
                jnp.asarray(xf), jnp.asarray(masks[n])).items()}
            for f in STAT_FIELDS:
                a, b = got[f][c, n], want[f]
                if f == "npx":
                    assert a == b, (f, n, c)
                elif np.isnan(b):
                    assert np.isnan(a), (f, n, c)
                else:
                    assert a == b or abs(a - b) <= 1e-6 * max(1, abs(b)), (
                        f, n, c, a, b)


@pytest.mark.parametrize("clip", [True, False])
def test_bisect_tie_heavy_and_clip_boundary(clip):
    """Order statistics over LOW-CARDINALITY data (massive ties) and values
    straddling the background (clip boundary): the bisection must still
    agree exactly with sorting the transformed values — including the
    np.percentile interpolation between a clipped-to-0 order statistic and
    a positive one."""
    rng = np.random.default_rng(11)
    N, C, t = 6, 2, 48
    # values drawn from a tiny set around the background levels
    vals = np.array([0, 36, 37, 38, 120, 121, 4095], np.uint16)
    tiles = rng.choice(vals, size=(N, C, t, t)).astype(np.uint16)
    masks = rng.random((N, t, t)) > 0.3
    bgs = np.array([37.0, 120.5], np.float32)  # ties AT the background
    got = {k: np.asarray(v) for k, v in tile_stats_u16(
        jnp.asarray(tiles), jnp.asarray(masks), jnp.asarray(bgs),
        clip_neg=clip).items()}
    for n in range(N):
        for c in range(C):
            xf = tiles[n, c].astype(np.float32) - bgs[c]
            if clip:
                xf = np.maximum(xf, 0)
            want = {k: np.asarray(v) for k, v in masked_stats(
                jnp.asarray(xf), jnp.asarray(masks[n])).items()}
            for f in STAT_FIELDS:
                a, b = got[f][c, n], want[f]
                if f == "npx":
                    assert a == b, (f, n, c)
                else:
                    assert a == b or abs(a - b) <= 1e-6 * max(1, abs(b)), (
                        f, n, c, a, b)

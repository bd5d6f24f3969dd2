"""Per-device dispatch and the minimum dispatch batch: the sharded tables
runners give every frame the results of the single-device program."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from imageprocess_tpu.parallel.runner import (
    MIN_DISPATCH_FRAMES, batched_tile_stats_step, make_mesh, min_batch,
    per_device, round_batch_to_mesh,
)


def _batch(B, N=5, C=2, t=16, seed=0):
    rng = np.random.default_rng(seed)
    tiles = rng.integers(0, 4096, (B, N, C, t, t)).astype(np.uint16)
    sq = np.array([[2.5, 2.5], [12.5, 2.5], [12.5, 11.5], [2.5, 11.5]],
                  np.float32)
    lp = np.broadcast_to(sq, (B, N, 4, 2)).copy()
    valid = np.ones((B, N), bool)
    valid[:, -1] = False
    bgs = rng.uniform(50, 150, (B, C)).astype(np.float32)
    return tiles, lp, valid, bgs


def _equal(a, b):
    la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
    return len(la) == len(lb) and all(
        np.array_equal(np.asarray(x), np.asarray(y), equal_nan=True)
        for x, y in zip(la, lb))


@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_per_device_matches_single_device(n_dev):
    args = _batch(16)
    want = batched_tile_stats_step(*args)
    run = per_device(batched_tile_stats_step, make_mesh(n_dev))
    got = run(*(jnp.asarray(a) for a in args))
    assert _equal(got, want)
    # results come back together on the first device
    assert all(x.devices() == {jax.devices()[0]}
               for x in jax.tree_util.tree_leaves(got))


def test_min_batch_pads_one_frame_dispatches():
    calls = []

    def fn(*args):
        calls.append(args[0].shape[0])
        return batched_tile_stats_step(*args)

    args = _batch(MIN_DISPATCH_FRAMES + 1, seed=1)
    one = min_batch(fn)(*(a[:1] for a in args))
    assert calls == [MIN_DISPATCH_FRAMES]
    assert jax.tree_util.tree_leaves(one)[0].shape[0] == 1
    full = batched_tile_stats_step(*args)
    assert _equal(one, jax.tree_util.tree_map(lambda x: x[:1], full))
    min_batch(fn)(*args)
    assert calls[-1] == MIN_DISPATCH_FRAMES + 1   # no padding above it


@pytest.mark.parametrize("batch,n_dev,want", [(4, 4, 8), (20, 4, 20),
                                               (22, 4, 20), (9, 2, 8),
                                               (1, 1, 2), (8, 1, 8)])
def test_round_batch_to_mesh_gives_min_frames_per_device(batch, n_dev, want):
    assert round_batch_to_mesh(batch, make_mesh(n_dev)) == want
    assert round_batch_to_mesh(batch, None) == batch


@pytest.mark.parametrize("prog", ["intensity", "fret"])
def test_tables_results_independent_of_dispatch_size(prog):
    """The tables programs loop over frames, so a frame's statistics are
    the same in a dispatch of any size from MIN_DISPATCH_FRAMES up."""
    from imageprocess_tpu.pipelines.fret import batched_fret_tile_stats

    args = _batch(16, seed=2)
    fn = batched_tile_stats_step
    if prog == "fret":
        fn = batched_fret_tile_stats
        args = args + (np.full((16,), 5.0, np.float32),)
    want = fn(*args)
    for b in (MIN_DISPATCH_FRAMES, 3, 8):
        got = fn(*(a[b:2 * b] for a in args))
        assert _equal(got, jax.tree_util.tree_map(lambda x: x[b:2 * b], want))

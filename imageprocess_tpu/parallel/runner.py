"""Batch execution over a 1-D device mesh.

The reference parallelizes by fanning (stage, time) work keys over a
process pool (src/INT/Fluor_INT.py:2216-2229, src/FRET/
fret_ratio_builder.py:945-970).  The device equivalent: stack frames
into a (B, C, H, W) batch and run ONE jit-compiled program per chunk; on
a ``Mesh`` the chunk splits into one slice per device, each running the
same single-device program (:func:`per_device`); results gather back as
(B, ...) arrays.

Host-side, a ``PrefetchLoader`` thread pool decodes TIFFs ahead of device
compute (replacing ``as_completed`` result draining).
"""

from __future__ import annotations

import concurrent.futures as cf
from collections import deque
from functools import partial
from typing import Callable, Iterator, List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh



def make_mesh(n_devices: Optional[int] = None, axis: str = "batch") -> Mesh:
    """1-D mesh over the first *n_devices* (default: all)."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


#: fewest frames a tables program is dispatched with.  A GPU compiles
#: reductions by shape, so the tables programs loop over frames
#: (``lax.map``): the loop body has one frame's shape whatever the
#: batch, and a frame's statistics do not depend on the chunking or the
#: device count.  XLA inlines a loop of one trip, which then compiles
#: differently, so a dispatch carries at least two frames.
MIN_DISPATCH_FRAMES = 2


def round_batch_to_mesh(batch_size: int, mesh) -> int:
    """Round a runner's chunk size so every mesh-sharded dispatch divides
    evenly over the mesh's devices, with at least MIN_DISPATCH_FRAMES per
    device (short trailing chunks pad with valid=False lanes instead).
    No-op for single-device runs."""
    if mesh is None:
        return batch_size
    n_dev = len(mesh.devices.ravel())
    batch_size = max(batch_size, MIN_DISPATCH_FRAMES * n_dev)
    return batch_size - batch_size % n_dev


def min_batch(fn: Callable) -> Callable:
    """*fn* over a batch zero-padded to MIN_DISPATCH_FRAMES frames when it
    is shorter (the padded frames' results are dropped)."""
    def run(*args):
        b = args[0].shape[0]
        if b >= MIN_DISPATCH_FRAMES:
            return fn(*args)
        pad = MIN_DISPATCH_FRAMES - b
        out = fn(*(jnp.concatenate([jnp.asarray(a),
                                    jnp.zeros((pad,) + a.shape[1:], a.dtype)])
                   for a in args))
        return jax.tree_util.tree_map(lambda x: x[:b], out)

    return run


def per_device(fn: Callable, mesh: Mesh) -> Callable:
    """Data parallelism by dispatch: split every argument's leading (batch)
    axis into one equal slice per device of *mesh*, run the single-device
    program *fn* on each slice on its device, and concatenate the results
    on the first device.  Each device runs the program compiled for one
    device, so a frame's results depend only on the slice size (see
    MIN_DISPATCH_FRAMES), not on the device count; an automatically
    partitioned program rounded some reductions differently on a GPU."""
    devs = list(mesh.devices.flat)

    def run(*args):
        k = args[0].shape[0] // len(devs)
        outs = [fn(*(jax.device_put(a[i * k:(i + 1) * k], d) for a in args))
                for i, d in enumerate(devs)]
        return jax.tree_util.tree_map(
            lambda *xs: jnp.concatenate([jax.device_put(x, devs[0])
                                         for x in xs]), *outs)

    return run


def _intensity_one(imgs, polys, roi_valid, p1000s, *, bg_mode, bg_scope,
                   clip_neg, bg_stride):
    """Single-frame intensity compute: the REAL production program
    (pipelines.intensity.intensity_step), not a copy — the batched/sharded
    paths must stay numerically identical to the serial one by
    construction, and intensity_step also keeps the raw-u16 exact
    histogram background (no megapixel sort)."""
    from ..pipelines.intensity import intensity_step

    stats, area, bgs, _ = intensity_step(
        imgs, polys, roi_valid, p1000s,
        bg_mode=bg_mode, bg_scope=bg_scope,
        clip_neg=clip_neg, bg_stride=bg_stride,
    )
    return stats, area, bgs


@partial(
    jax.jit,
    static_argnames=("bg_mode", "bg_scope", "clip_neg", "bg_stride"),
)
def batched_intensity_step(
    imgs: jnp.ndarray,       # (B, C, H, W) float32
    polys: jnp.ndarray,      # (B, N, V, 2) float32
    roi_valid: jnp.ndarray,  # (B, N) bool
    p1000s: jnp.ndarray,     # (B, C) int32
    *,
    bg_mode: str = "percentile",
    bg_scope: str = "full",
    clip_neg: bool = True,
    bg_stride: int = 4,
):
    """vmapped whole-batch intensity program (single device)."""
    f = partial(_intensity_one, bg_mode=bg_mode, bg_scope=bg_scope,
                clip_neg=clip_neg, bg_stride=bg_stride)
    return jax.vmap(f)(imgs, polys, roi_valid, p1000s)


@partial(
    jax.jit,
    static_argnames=("tile", "bg_mode", "clip_neg", "bg_stride"),
)
def batched_intensity_step_tiled(
    imgs: jnp.ndarray,        # (B, C, H, W) u16/f32
    local_polys: jnp.ndarray,  # (B, N, V, 2) tile-local
    offsets: jnp.ndarray,      # (B, N, 2)
    roi_valid: jnp.ndarray,    # (B, N)
    p1000s: jnp.ndarray,       # (B, C)
    *,
    tile: int,
    bg_mode: str = "percentile",
    clip_neg: bool = True,
    bg_stride: int = 4,
):
    """Whole-batch tiled intensity program: one dispatch quantifies B frames
    (stats/areas/bgs as (B, ...) arrays).  This is the production path for
    timelapse stacks — the time axis IS the batch axis (SURVEY §5 "long
    context") — and the unit that shards over the mesh."""
    from ..pipelines.intensity import intensity_step_tiled

    f = partial(intensity_step_tiled, tile=tile, bg_mode=bg_mode,
                clip_neg=clip_neg, bg_stride=bg_stride)

    def one(img, lp, off, valid, p1000):
        stats, area, bgs, _ = f(img, lp, off, valid, p1000)
        return stats, area, bgs  # drop imgs_bc: keeps batch HBM bounded

    return jax.vmap(one)(imgs, local_polys, offsets, roi_valid, p1000s)


@partial(jax.jit, static_argnames=("clip_neg",))
def batched_tile_stats_step(
    tiles: jnp.ndarray,        # (B, N, C, t, t) raw tile pixels (u16 ok)
    local_polys: jnp.ndarray,  # (B, N, V, 2)
    roi_valid: jnp.ndarray,    # (B, N)
    bgs: jnp.ndarray,          # (B, C) float32 host-computed backgrounds
    *,
    clip_neg: bool = True,
):
    """Whole-batch minimum-transfer intensity program: the host gathers ROI
    tiles and computes the (scalar) backgrounds natively, so only ~10% of
    the pixel bytes cross the host->device link.  Frames run in a loop
    (see MIN_DISPATCH_FRAMES).  Returns (stats (B, C, N), area (B, N))."""
    from ..ops.roistats import tile_stats_from_gathered

    f = partial(tile_stats_from_gathered, clip_neg=clip_neg)
    return jax.lax.map(lambda a: f(*a), (tiles, local_polys, roi_valid, bgs))


def sharded_batched_tile_stats(mesh: Mesh, *, clip_neg=True) -> Callable:
    """batched_tile_stats_step with the batch axis split over *mesh*'s
    devices (:func:`per_device`)."""
    return per_device(partial(batched_tile_stats_step, clip_neg=clip_neg),
                      mesh)


def make_autoscaler(loader, batch_size: int, cap: int = 32):
    """Chunk-size auto-scaling shared by the batched runners: a
    (current_size, maybe_grow) pair.  maybe_grow doubles the size (up to
    *cap*) whenever the loader's decoded-and-waiting queue outruns 1.5x
    the current size; on a decode-bound host the queue never fills and
    the size never moves (no recompiles, no regression).  Doubling
    preserves any mesh divisibility of the starting size.  The cap of 32
    has not been measured on a GPU yet."""
    state = {"bs": batch_size}

    def current() -> int:
        return state["bs"]

    def maybe_grow() -> None:
        bs = state["bs"]
        if bs * 2 <= cap and loader.ready >= (3 * bs) // 2:
            state["bs"] = bs * 2

    return current, maybe_grow


class LoadError:
    """Sentinel yielded by PrefetchLoader when an item's load_fn raised:
    carries the item and the exception so callers can log-and-skip (the
    reference's best-effort worker error handling, SURVEY §5)."""

    def __init__(self, item, error):
        self.item = item
        self.error = error


class EmitFetchError(Exception):
    """Raised by an emit() callback when the device->host result fetch
    failed BEFORE any side effect ran (row append, buffer recycle, file
    write).  This is the only emit failure :func:`stream_batches` recovers
    by re-running the chunk's keys through the serial path — recovering
    after a partial emit would duplicate report rows and double-put
    recycled decode buffers into the FrameBufferPool."""


def stream_batches(loader, batch_size: int, classify, dispatch, emit,
                   serial, on_error, cancel=None, in_flight: int = 2) -> bool:
    """The batches-in-flight streaming protocol shared by the batched
    runners (intensity, fret): consume a PrefetchLoader, keep up to
    *in_flight* dispatched batches pending so host decode of chunk k+1
    overlaps device compute of chunk k, and preserve key order across
    serial fallbacks (buffered entries flush, then every in-flight batch
    drains, before a serial key's rows are emitted — the reference reports
    are key-ordered).

    Two in flight (the default) additionally hides the result FETCH: with
    one, emit(k) runs right after dispatch(k+1) and can block on k's
    remaining device compute plus the copy back; with two, k's
    packed result has had a whole extra pack+dispatch cycle for its
    copy_to_host_async to land, so emit(k) is a local read.  Results are
    emitted strictly in dispatch order either way.

    - batch_size: target chunk length — an int, or a zero-arg callable
      re-read before each chunk boundary (chunk-size auto-scaling)
    - classify(item) -> ("batch", entry) | ("serial", entry) | ("skip", _)
    - dispatch(entries) -> opaque record, or None when the chunk can't take
      the batch program (its entries are then serialized in order)
    - emit(record): fetch + emit a dispatched batch's rows
    - serial(entry): per-key fallback
    - on_error(LoadError): log-and-skip
    - cancel: optional zero-arg callable checked between items (the
      reference GUI's cancel flag, Fluor_INT.py:2219-2233).  On cancel,
      the already-dispatched in-flight chunk drains (its rows are kept)
      but buffered, never-dispatched entries are DROPPED — dispatching
      them would start new device work, possibly compiling a fresh
      partial-chunk shape.  Returns True if the run was cancelled.

    Fault isolation (the reference catches worker exceptions per future,
    Fluor_INT.py:1139-1143): a dispatch failure, or an emit failure raised
    as :class:`EmitFetchError` (the result fetch died before any side
    effect) — e.g. a device error mid-run — degrades that chunk to
    the per-key serial path instead of aborting the whole run; a key whose
    serial fallback ALSO fails is logged through on_error and skipped.
    Any OTHER emit exception means rows/buffers may already be partially
    emitted, so the chunk is NOT re-run (that would duplicate report rows
    and double-put pooled decode buffers); its keys are logged through
    on_error instead.
    """
    size = batch_size if callable(batch_size) else (lambda: batch_size)
    buf = []
    pending = deque()  # (opaque dispatch record, its entries) FIFO; the
    #                    entries ride along for serial recovery on emit
    #                    failure

    def serial_safe(entry):
        try:
            serial(entry)
        except Exception as e:  # noqa: BLE001 — log-and-skip per key
            on_error(LoadError(entry, e))

    def drain_one():
        rec, entries = pending.popleft()
        try:
            emit(rec)
        except EmitFetchError:  # result fetch failed pre-emit: redo
            for e in entries:   # the chunk per key (device may be back,
                serial_safe(e)  # or each key logs its own error)
        except Exception as exc:  # noqa: BLE001 — emit partially ran:
            for e in entries:     # re-running would duplicate rows /
                on_error(LoadError(e, exc))  # double-put pool buffers

    def drain_all():
        while pending:
            drain_one()

    def flush():
        if not buf:
            return
        entries = list(buf)  # copy: buf.clear() must not empty the
        buf.clear()          # chunk held by an in-flight record
        cap = max(1, in_flight)
        if cap > 1:
            # at capacity, drain the oldest BEFORE dispatching: its result
            # has had >= one full cycle to copy back, and peak memory stays
            # at `cap` chunks of live entries (each chunk's decode frames
            # ride in its entries until emit recycles them to the pool —
            # the cost of two-in-flight is one extra chunk of frames)
            while len(pending) >= cap:
                drain_one()
        try:
            rec = dispatch(entries)
        except Exception:  # noqa: BLE001 — dispatch failed: go serial
            drain_all()
            for e in entries:
                serial_safe(e)
            return
        if rec is None:
            drain_all()  # order: earlier chunks' rows before these keys'
            for e in entries:
                serial_safe(e)
        else:
            pending.append((rec, entries))
            if cap == 1:
                # one in flight keeps the r3 ordering — dispatch k+1 first,
                # THEN the blocking fetch of k, so they still overlap
                while len(pending) > 1:
                    drain_one()

    cancelled = False
    for item in loader:
        if cancel is not None and cancel():
            cancelled = True
            break
        if isinstance(item, LoadError):
            on_error(item)
            continue
        kind, entry = classify(item)
        if kind == "skip":
            continue
        if kind == "serial":
            flush()
            drain_all()
            serial_safe(entry)
            continue
        buf.append(entry)
        if len(buf) >= size():
            flush()
    if cancelled:
        buf.clear()
    else:
        flush()
    drain_all()
    return cancelled


class PrefetchLoader:
    """Decode-ahead host loader: maps *load_fn* over work items with a
    thread pool, yielding results in order while later decodes overlap
    device compute.  Items whose load raises yield a ``LoadError`` instead
    of aborting the iteration."""

    def __init__(self, load_fn: Callable, items: Sequence, workers: int = 8,
                 ahead: int = 16):
        self._load = load_fn
        self._items = list(items)
        self._workers = workers
        self._ahead = ahead
        #: decoded-and-waiting item count as of the last yield — consumers
        #: use this as the backpressure signal for chunk-size auto-scaling
        #: (decode running ahead of the device means bigger dispatches
        #: amortize the per-dispatch floor at no extra latency)
        self.ready = 0

    def __iter__(self) -> Iterator:
        pool = cf.ThreadPoolExecutor(self._workers)
        try:
            futures: List[cf.Future] = []
            it = iter(self._items)
            for _ in range(self._ahead):
                try:
                    futures.append(pool.submit(self._load, next(it)))
                except StopIteration:
                    break
            idx = 0
            while futures:
                fut = futures.pop(0)
                try:
                    futures.append(pool.submit(self._load, next(it)))
                except StopIteration:
                    pass
                self.ready = sum(f.done() for f in futures)
                try:
                    yield fut.result()
                except Exception as e:  # noqa: BLE001 - surfaced to caller
                    yield LoadError(self._items[idx], e)
                idx += 1
        finally:
            # abandoned mid-iteration (stream_batches' cancel path breaks
            # out of the loop): drop the up-to-`ahead` queued decodes
            # instead of blocking on them — cancel must return promptly,
            # not after seconds of dead decode work
            pool.shutdown(wait=False, cancel_futures=True)

"""Spatial sharding of a single large FOV across the device mesh.

SURVEY §2.3 documents this as an extension beyond the reference's data
parallelism: when one frame exceeds one device's memory (or when
latency on a single frame matters), shard the ROW axis over the mesh and
run the frame-level ops with explicit collectives:

- global background percentile: exact for u16 data via per-shard 65536-bin
  histograms + ``psum`` (one all-reduce of 256 KB), then an exact order
  statistic with np.percentile interpolation — no gather of pixel data;
- neighborhood ops (square dilation / erosion windows): halo exchange of
  boundary rows with ``ppermute``, then local reduce-windows;
- background-correct: pure elementwise after the psum (no communication).

All functions are ``shard_map``-ed over a 1-D mesh and jit-compiled; tests
run them on the 8-virtual-device CPU mesh against single-device oracles.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..morphology.ccl import _neighbor_min
from ..ops.percentile import exact_quantile_pos

U16_BINS = 65536


def _halo_exchange_rows(x: jnp.ndarray, halo: int, axis_name: str, fill):
    """Append *halo* rows from each neighbor.  Edge shards (which have no
    neighbor on that side) get rows filled with *fill*, which must be the
    identity element of the window reduction that will consume the halo
    (-inf for max/dilation, +inf for min/erosion, 0 for sum) — this matches
    single-device ``reduce_window(..., "SAME")`` border semantics, whose
    implicit padding is the init value."""
    idx = jax.lax.axis_index(axis_name)
    n = jax.lax.axis_size(axis_name)
    up = jax.lax.ppermute(x[:halo], axis_name,
                          [(i, (i - 1) % n) for i in range(n)])
    down = jax.lax.ppermute(x[-halo:], axis_name,
                            [(i, (i + 1) % n) for i in range(n)])
    # wrap-around neighbors are invalid at the edges -> identity fill
    top_pad = jnp.where(idx == 0, jnp.full_like(down, fill), down)
    bot_pad = jnp.where(idx == n - 1, jnp.full_like(up, fill), up)
    return jnp.concatenate([top_pad, x, bot_pad], axis=0)


def _u16_hist(x, weights=None):
    """(65536,) int32 histogram of a u16-valued array, optionally
    mask-weighted — the shard-local half of every psum percentile here."""
    xi = jnp.clip(x.astype(jnp.int32), 0, U16_BINS - 1).ravel()
    w = (jnp.ones(xi.shape, jnp.int32) if weights is None
         else weights.ravel().astype(jnp.int32))
    return jnp.zeros((U16_BINS,), jnp.int32).at[xi].add(w)


def _psum_hist_quantile(hist, axis: str, p1000):
    """Exact global percentile from per-shard u16 histograms: one psum,
    then the (k, g) order-statistic interpolation — the ONE implementation
    of the np.percentile linear rule over psum histograms (the value of
    the j-th order statistic is the first bin whose cdf exceeds j).
    NaN for an empty global histogram (quantile_from_sorted contract; an
    unguarded searchsorted over the all-zero cdf would return the garbage
    value 65536)."""
    hist = jax.lax.psum(hist, axis)
    n = hist.sum()
    k, g = exact_quantile_pos(n, jnp.int32(p1000))
    cdf = jnp.cumsum(hist)
    lo_v = jnp.searchsorted(cdf, k, side="right").astype(jnp.float32)
    hi_v = jnp.searchsorted(cdf, jnp.minimum(k + 1, n - 1),
                            side="right").astype(jnp.float32)
    return jnp.where(n > 0, lo_v + g * (hi_v - lo_v), jnp.nan)


def sharded_quantile_u16(mesh: Mesh, p1000: int):
    """Exact global percentile (np.percentile linear rule) of a row-sharded
    u16-valued frame via histogram psum."""
    axis = mesh.axis_names[0]

    def local(x):
        return _psum_hist_quantile(_u16_hist(x), axis, p1000)[None]

    fn = jax.jit(jax.shard_map(
        local, mesh=mesh, in_specs=P(axis, None), out_specs=P(axis),
    ))

    def run(img):
        out = fn(img)
        return out[0]

    return run


def sharded_bg_correct_u16(mesh: Mesh, p1000: int, clip_neg: bool = True):
    """Row-sharded background subtraction: exact global percentile (psum)
    then elementwise correct — frame never leaves the shards."""
    axis = mesh.axis_names[0]

    def local(x):
        b = _psum_hist_quantile(_u16_hist(x), axis, p1000)
        out = x.astype(jnp.float32) - b
        if clip_neg:
            out = jnp.maximum(out, 0.0)
        return out

    return jax.jit(jax.shard_map(
        local, mesh=mesh, in_specs=P(axis, None), out_specs=P(axis, None),
    ))


def _guard_halo(fn, mesh: Mesh, halo: int, what: str):
    """Refuse windows whose halo exceeds the rows a shard holds: the
    exchange can only ship one neighbor's rows, so a too-large window
    would silently produce a wrong (row-shifted / truncated) result —
    surface it as an actionable error instead."""
    n = mesh.shape[mesh.axis_names[0]]

    def run(x, *a, **k):
        rows = x.shape[0] // n
        if halo > rows:
            raise ValueError(
                f"{what}: window needs a {halo}-row halo but each of the "
                f"{n} shards holds only {rows} rows of the {x.shape[0]}-row "
                f"frame — use fewer devices or a single-device op")
        return fn(x, *a, **k)

    return run


def sharded_square_dilation(mesh: Mesh, k: int):
    """Row-sharded binary dilation with a (2k+1)^2 all-ones window —
    ppermute halo exchange + local separable reduce-window max.
    Matches morphology.binary.square_dilation on a single device."""
    axis = mesh.axis_names[0]

    def local(x):
        xf = x.astype(jnp.float32)
        xh = _halo_exchange_rows(xf, k, axis, -jnp.inf)
        y = jax.lax.reduce_window(
            xh, -jnp.inf, jax.lax.max, (2 * k + 1, 1), (1, 1), "VALID"
        )
        y = jax.lax.reduce_window(
            y, -jnp.inf, jax.lax.max, (1, 2 * k + 1), (1, 1), "SAME"
        )
        return y > 0.5

    return _guard_halo(jax.jit(jax.shard_map(
        local, mesh=mesh, in_specs=P(axis, None), out_specs=P(axis, None),
    )), mesh, k, "sharded_square_dilation")


def sharded_square_erosion(mesh: Mesh, k: int):
    """Row-sharded binary erosion with a (2k+1)^2 all-ones window — the
    min-window dual of :func:`sharded_square_dilation`.  The halo identity
    is +inf, so out-of-frame pixels act as foreground (reduce_window SAME
    parity: a single-device ``reduce_window(x, +inf, min, SAME)`` gives the
    identical border behavior)."""
    axis = mesh.axis_names[0]

    def local(x):
        xf = x.astype(jnp.float32)
        xh = _halo_exchange_rows(xf, k, axis, jnp.inf)
        y = jax.lax.reduce_window(
            xh, jnp.inf, jax.lax.min, (2 * k + 1, 1), (1, 1), "VALID"
        )
        y = jax.lax.reduce_window(
            y, jnp.inf, jax.lax.min, (1, 2 * k + 1), (1, 1), "SAME"
        )
        return y > 0.5

    return _guard_halo(jax.jit(jax.shard_map(
        local, mesh=mesh, in_specs=P(axis, None), out_specs=P(axis, None),
    )), mesh, k, "sharded_square_erosion")


def sharded_rim_mask(mesh: Mesh, rim_px: int):
    """Row-sharded nuclear-envelope rim mask — EXACT parity with the
    single-device ``morphology.edt.rim_mask`` (Nesprin2_FRET_Builder.py:
    409-414 semantics).

    The radius-clamped squared EDT only looks rim_px pixels away, so a
    rim_px-row halo exchange makes each shard's local EDT exact.  The halo
    fill for edge shards is True (foreground): out-of-image is NOT
    background in the reference/scipy semantics, and only background
    pixels act as distance sources."""
    axis = mesh.axis_names[0]

    def local(u):
        from ..morphology.edt import clamped_sq_edt

        u = u.astype(bool)
        if rim_px <= 0:
            return u
        uh = _halo_exchange_rows(u, rim_px, axis, True)
        sq = clamped_sq_edt(uh, rim_px)[rim_px:-rim_px]
        return u & (sq <= jnp.float32(rim_px * rim_px))

    return _guard_halo(jax.jit(jax.shard_map(
        local, mesh=mesh, in_specs=P(axis, None), out_specs=P(axis, None),
    )), mesh, rim_px, "sharded_rim_mask")


def sharded_annulus_mask(mesh: Mesh, inner_px: int, outer_px: int):
    """Row-sharded square-dilation annulus — parity with
    ``morphology.binary.annulus_mask`` (Nesprin2's per-ROI local-BG ring,
    src/FRET/Nesprin2_FRET_Builder.py:416-427), one halo exchange sized
    for the OUTER window shared by both dilations."""
    inner_px = max(1, int(inner_px))
    outer_px = int(outer_px)
    if outer_px <= inner_px:
        outer_px = inner_px + 1
    axis = mesh.axis_names[0]
    o = outer_px

    def local(x):
        xf = x.astype(jnp.float32)
        xh = _halo_exchange_rows(xf, o, axis, -jnp.inf)
        L = x.shape[0]

        def dilate(k):
            y = jax.lax.reduce_window(
                xh, -jnp.inf, jax.lax.max, (2 * k + 1, 1), (1, 1), "VALID"
            )
            y = jax.lax.dynamic_slice_in_dim(y, o - k, L, axis=0)
            y = jax.lax.reduce_window(
                y, -jnp.inf, jax.lax.max, (1, 2 * k + 1), (1, 1), "SAME"
            )
            return y > 0.5

        return dilate(outer_px) & ~dilate(inner_px)

    return _guard_halo(jax.jit(jax.shard_map(
        local, mesh=mesh, in_specs=P(axis, None), out_specs=P(axis, None),
    )), mesh, outer_px, "sharded_annulus_mask")


def _sharded_roots(fg, axis: str, n_shards: int, connectivity: int):
    """Shard-local piece of distributed CCL: every foreground pixel ends
    up labeled with its component's GLOBAL minimum flat index.

    Local min-label propagation with pointer jumping runs to a fixpoint
    with no collectives (shard-divergent trip counts are fine); an outer
    loop exchanges one boundary label row per neighbor (``ppermute``) and
    re-runs the local fixpoint until a ``psum`` of change flags reaches
    zero — a component snaking across k shards converges in <= k rounds
    and the frame is never gathered.  Path compression hops only through
    labels homed in THIS shard; foreign labels compress in their home
    shard on later rounds.  Returns (roots int32 (h, W), sentinel)."""
    h, W = fg.shape
    H = h * n_shards
    sentinel = jnp.int32(H * W)
    i = jax.lax.axis_index(axis)
    base = (i * h * W).astype(jnp.int32)
    idx = base + jnp.arange(h * W, dtype=jnp.int32).reshape(h, W)
    L0 = jnp.where(fg, idx, sentinel)

    def jump(L):
        flat = L.ravel()
        local_ptr = flat - base
        ours = (local_ptr >= 0) & (local_ptr < h * W)
        ptr = jnp.clip(local_ptr, 0, h * W - 1)
        hop = jnp.where(ours, flat[ptr], flat)
        return jnp.where(fg, jnp.minimum(flat, hop).reshape(h, W), sentinel)

    def local_fix(L, halo_top, halo_bot):
        ext0 = jnp.concatenate([halo_top[None], L, halo_bot[None]], 0)

        def body(state):
            Lc, _ = state
            ext = ext0.at[1:-1].set(Lc)
            Ln = _neighbor_min(ext, sentinel, connectivity)[1:-1]
            Ln = jnp.where(fg, Ln, sentinel)
            Ln = jump(jump(Ln))
            return Ln, jnp.any(Ln != Lc)

        # initial flag must be marked varying over the manual axis to
        # match the loop-carried (shard-local) change flag
        start = jax.lax.pcast(jnp.bool_(True), (axis,), to="varying")
        L, _ = jax.lax.while_loop(lambda s: s[1], body, (L, start))
        return L

    def outer(state):
        L, _ = state
        ext = _halo_exchange_rows(L, 1, axis, sentinel)
        Ln = local_fix(L, ext[0], ext[-1])
        changed = jax.lax.psum(jnp.any(Ln != L).astype(jnp.int32), axis)
        return Ln, changed > 0

    sent_row = jnp.full((W,), sentinel, jnp.int32)
    L = local_fix(L0, sent_row, sent_row)
    L, _ = jax.lax.while_loop(lambda s: s[1], outer, (L, jnp.bool_(True)))
    return L, sentinel


def _rank_roots(L, fg, sentinel, axis: str, max_labels: int):
    """Consecutive 1..K raster-order numbering (skimage parity): rank each
    root within the sorted union of every shard's root set (one
    ``all_gather`` of max_labels ints per shard).

    Returns (labels, overflow): overflow > 0 when any shard's distinct
    root count reached the max_labels capacity — labels would ALIAS
    beyond it (unique truncates, dropped roots searchsort onto wrong
    ranks), so callers must surface this instead of returning silently
    wrong components."""
    uniq = jnp.unique(L, size=max_labels + 1, fill_value=sentinel)
    # capacity check: a frame with background always has the sentinel in
    # its root set; if it got squeezed out of the size-limited unique, the
    # shard had > max_labels distinct roots
    local_over = ~jnp.any(uniq == sentinel)
    allu = jax.lax.all_gather(uniq, axis).ravel()
    ug = jnp.unique(allu, size=max_labels + 1, fill_value=sentinel)
    global_over = ~jnp.any(ug == sentinel)
    over = jax.lax.psum((local_over | global_over).astype(jnp.int32), axis)
    comp = jnp.searchsorted(ug, L.ravel()).astype(jnp.int32)
    lab = jnp.where(fg.ravel(), comp + 1, 0).reshape(fg.shape)
    return lab, over


def sharded_label(mesh: Mesh, connectivity: int = 2, max_labels: int = 1024):
    """Row-sharded connected-component labeling — EXACT skimage ``label``
    numbering parity with the single-device ``morphology.ccl`` (components
    numbered 1..K in raster order of their first pixel)."""
    axis = mesh.axis_names[0]
    n_shards = len(mesh.devices.ravel())

    def local(fg):
        roots, sentinel = _sharded_roots(fg, axis, n_shards, connectivity)
        lab, over = _rank_roots(roots, fg, sentinel, axis, max_labels)
        return lab, over[None]

    fn = jax.jit(jax.shard_map(
        local, mesh=mesh, in_specs=P(axis, None),
        out_specs=(P(axis, None), P(axis)),
    ))

    def run(fg):
        lab, over = fn(fg)
        if int(np.asarray(over)[0]) > 0:
            raise ValueError(
                f"sharded_label: component count exceeded max_labels="
                f"{max_labels}; labels would alias — raise max_labels")
        return lab

    return run


def sharded_remove_small(mesh: Mesh, min_size: int, connectivity: int = 1,
                         max_labels: int = 1024):
    """Row-sharded ``remove_small_objects`` (skimage parity: strict
    ``< min_size`` removal, 4-connected default): distributed roots ->
    ranked component ids -> one ``psum`` of the (max_labels+2,) component
    size table."""
    axis = mesh.axis_names[0]
    n_shards = len(mesh.devices.ravel())

    def local(fg):
        roots, sentinel = _sharded_roots(fg, axis, n_shards, connectivity)
        lab, over = _rank_roots(roots, fg, sentinel, axis, max_labels)
        sizes = jnp.zeros(max_labels + 2, jnp.int32).at[lab.ravel()].add(1)
        sizes = jax.lax.psum(sizes, axis)
        keep = sizes[lab.ravel()].reshape(fg.shape) >= min_size
        return fg & keep, over[None]

    fn = jax.jit(jax.shard_map(
        local, mesh=mesh, in_specs=P(axis, None),
        out_specs=(P(axis, None), P(axis)),
    ))

    def run(fg):
        out, over = fn(fg)
        if int(np.asarray(over)[0]) > 0:
            raise ValueError(
                f"sharded_remove_small: component count exceeded max_labels="
                f"{max_labels}; sizes would alias — raise max_labels")
        return out

    return run


def sharded_closing_disk(mesh: Mesh, radius: int):
    """Row-sharded skimage binary_closing with a disk SE (the FA chain's
    smoothing pass): one 2r-row halo serves both the dilation (out-of-
    frame = False) and the erosion (out-of-frame = True, skimage's
    border_true) — after dilating the haloed block, the rows BEYOND the
    frame on edge shards are forced True so the erosion sees skimage's
    border convention; interior block edges only corrupt rows within r of
    the halo boundary, which the 2r crop discards."""
    from ..morphology.binary import _dilate, _erode, _se_key, disk

    if radius <= 0:
        return jax.jit(jax.shard_map(
            lambda x: x.astype(bool), mesh=mesh,
            in_specs=P(mesh.axis_names[0], None),
            out_specs=P(mesh.axis_names[0], None)))
    axis = mesh.axis_names[0]
    n_shards = len(mesh.devices.ravel())
    key = _se_key(disk(radius))
    r2 = 2 * radius

    def local(x):
        h = x.shape[0]
        i = jax.lax.axis_index(axis)
        xh = _halo_exchange_rows(x.astype(bool), r2, axis, False)
        d = _dilate(xh, key)
        rows = jnp.arange(h + 2 * r2)
        out_of_frame = ((i == 0) & (rows < r2)) | (
            (i == n_shards - 1) & (rows >= r2 + h))
        d = jnp.where(out_of_frame[:, None], True, d)
        e = _erode(d, key, True)
        return e[r2:r2 + h]

    return _guard_halo(jax.jit(jax.shard_map(
        local, mesh=mesh, in_specs=P(axis, None), out_specs=P(axis, None),
    )), mesh, r2, "sharded_closing_disk")


def sharded_fa_stats(mesh: Mesh):
    """Row-sharded FA global statistics (FA_Analyzer.py:624-626 semantics):
    whole-image nan-mean/nan-std for the threshold, background = exact p1
    of the GLOBAL ``img[::10, ::10]`` subsample — all via psum reductions
    and a histogram psum, the frame never leaves the shards.  Input must
    be u16-integral-valued (microscopy frames are)."""
    axis = mesh.axis_names[0]

    def local(x):
        h, W = x.shape
        i = jax.lax.axis_index(axis)
        xf = x.astype(jnp.float32)
        finite = jnp.isfinite(xf)
        n = jax.lax.psum(finite.sum().astype(jnp.float32), axis)
        n = jnp.maximum(n, 1.0)
        m = jax.lax.psum(jnp.where(finite, xf, 0.0).sum(), axis) / n
        var = jax.lax.psum(
            jnp.where(finite, (xf - m) ** 2, 0.0).sum(), axis) / n
        # [::10, ::10] over GLOBAL row indices
        grow = i * h + jnp.arange(h)
        gcol = jnp.arange(W)
        sample = ((grow % 10 == 0)[:, None] & (gcol % 10 == 0)[None, :]
                  & finite)
        bg = _psum_hist_quantile(_u16_hist(x, weights=sample), axis, 1000)
        return jnp.stack([m, jnp.sqrt(var), bg])[None]

    fn = jax.jit(jax.shard_map(
        local, mesh=mesh, in_specs=P(axis, None), out_specs=P(axis),
    ))

    def run(img):
        out = np.asarray(fn(img))
        return float(out[0, 0]), float(out[0, 1]), float(out[0, 2])

    return run


def sharded_fa_segment(mesh: Mesh, alpha: float, min_px: float,
                       close_radius: int, max_labels: int = 1024):
    """The FA segmentation chain (threshold mu + alpha*sigma inside the
    cell mask -> remove_small_objects -> binary_closing(disk) -> label,
    src/INT/FA_Analyzer.py:123-195) on a row-sharded frame, composed from
    the sharded primitives.  Returns (labels, threshold, bg)."""
    stats = sharded_fa_stats(mesh)
    rm = sharded_remove_small(mesh, int(np.ceil(min_px)), 1, max_labels)
    close = sharded_closing_disk(mesh, close_radius)
    lab = sharded_label(mesh, 2, max_labels)

    @jax.jit
    def _threshold(img, roi, thr):
        return (img.astype(jnp.float32) > thr) & roi

    def run(img, roi_mask):
        mu, sigma, bg = stats(img)
        thr = mu + alpha * sigma
        bw = _threshold(img, roi_mask, jnp.float32(thr))
        bw = rm(bw)
        bw = close(bw)
        return lab(bw), thr, bg

    return run


def shard_frame(mesh: Mesh, img: np.ndarray):
    """Place a (H, W) frame row-sharded over the mesh (H must divide)."""
    axis = mesh.axis_names[0]
    return jax.device_put(img, NamedSharding(mesh, P(axis, None)))

"""Core jittable spectrogram rasterization pipeline.

One :func:`render_matrix` call reproduces, on device, everything the
reference's ``make_spectrogram`` does to the *data* between numpy input and
the colored pixels matplotlib's ``imshow`` produces
(reference plotting.py:92-330):

1. pitch-category masked ``nansum`` collapse (:func:`collapse_cube`;
   reference plotting.py:188, fast/plotting.py:121-131)
2. all-NaN-column + energy-range masking (reference plotting.py:191-195)
3. descending-energy flip (reference plotting.py:200-202)
4. zoom-window / x-range row selection (host passes a contiguous
   ``t_start``/``t_count`` window; reference plotting.py:204-219)
5. percentile color bounds over the filtered matrix
   (reference plotting.py:259, percentile_utils.py:47-89)
6. log-z masking/floors or linear-z NaN/inf substitution
   (reference plotting.py:264-315)
7. ``imshow(extent=..., origin='lower', aspect='auto')`` pixel-replication
   resampling onto a fixed output grid, including the nonlinear warp a log
   y-axis applies to the drawn image (reference plotting.py:280-284,316-321,
   352-353)
8. colormap LUT application with matplotlib's ``Colormap.__call__`` index
   rule (``int(norm * 256)`` clipped to ``[0, 255]``)

All shapes are static: callers pad the time/energy axes and pass validity
counts, so one compiled program serves every orbit in a padding bucket.
``render_panels`` vmaps the whole pipeline across the rows of a figure (and
across figures), which is where the device throughput comes from: an entire
multirow grid -- or a whole batch of orbits -- rasterizes in one device
dispatch instead of one matplotlib Agg draw per panel.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

_BIG = np.float32(3.0e38)


@dataclass(frozen=True)
class RenderSpec:
    """Static configuration for one panel rasterization program.

    Hashable so it can be a ``jax.jit`` static argument; a distinct spec
    (size or scale combo) compiles a distinct XLA program.
    """

    height: int
    width: int
    y_scale: str = "linear"  # 'linear' | 'log'
    z_scale: str = "linear"  # 'linear' | 'log'
    low_percentile: float = 1.0
    high_percentile: float = 99.0
    bg_rgba: tuple[int, int, int, int] = (255, 255, 255, 255)


def collapse_cube(cube: jax.Array, pitch_mask: jax.Array, t_valid: jax.Array | int) -> jax.Array:
    """Collapse a (T, A, E) cube to (T, E) with masked ``nansum`` semantics.

    ``pitch_mask`` is a boolean (A,) selecting pitch-angle bins (the
    reference slices ``data[:, mask, :]`` then ``np.nansum(..., axis=1)``,
    fast/plotting.py:121-131).  NaNs count as zero; +/-inf propagate as in
    ``np.nansum``.  Rows at or beyond ``t_valid`` are forced to NaN so
    downstream all-NaN-column logic ignores padding.
    """
    cube = jnp.asarray(cube)
    masked = jnp.where(pitch_mask[None, :, None], cube, jnp.nan)
    finite_or_inf = ~jnp.isnan(masked)
    collapsed = jnp.sum(jnp.where(finite_or_inf, masked, 0.0), axis=1)
    # np.nansum over an all-NaN (or empty) selection yields 0.0, which the
    # sum-of-zeros above already produces.
    t_index = jax.lax.broadcasted_iota(jnp.int32, collapsed.shape, 0)
    return jnp.where(t_index < t_valid, collapsed, jnp.nan)


def _sortable_u32(flat: jax.Array, ok: jax.Array) -> jax.Array:
    """Map float32 values to uint32 keys whose unsigned order is the IEEE
    total order XLA's float sort uses (``-inf < ... < -0.0 < +0.0 < ... <
    +inf``, NaNs last): non-negative floats set the sign bit, negative
    floats flip every bit.  Entries with ``ok`` False map to 0xFFFFFFFF (a
    NaN pattern), above every valid key including +inf -- so order
    statistics at ranks below the valid count are exact.
    """
    bits = jax.lax.bitcast_convert_type(flat.astype(jnp.float32), jnp.uint32)
    neg = bits >> jnp.uint32(31)
    keys = jnp.where(
        neg.astype(bool), ~bits, bits | jnp.uint32(0x80000000)
    )
    return jnp.where(ok, keys, jnp.uint32(0xFFFFFFFF))


def select_order_stats(keys: jax.Array, ranks: jax.Array) -> jax.Array:
    """The values at ``ranks`` of the ascending-sorted ``keys`` -- no sort.

    Binary search on the key bits (MSB to LSB): the rank-``k`` element is
    built prefix by prefix, setting bit ``b`` exactly when at most ``k``
    keys are smaller than ``prefix | 1<<b``.  32 fused compare+reduce
    passes over the data replace the O(N log N) sort network -- the op
    becomes HBM-bandwidth-bound (measured ~4x faster than the shared sort
    at FAST panel shapes, tools/bench_percentile_sort.py), and the result
    is bit-identical to ``jnp.sort(keys)[ranks]`` because the search runs
    in the same total order the sort uses.

    ``keys`` is the (N,) uint32 array from :func:`_sortable_u32`;
    ``ranks`` an (R,) int32 of 0-indexed order statistics (may repeat).
    Returns the (R,) float32 values (bitcast back from the found keys).
    """
    ranks = jnp.asarray(ranks, jnp.int32)

    def body(i, prefix):
        bit = jnp.uint32(1) << jnp.uint32(31 - i)
        cand = prefix | bit  # (R,)
        below = jnp.sum(
            (keys[:, None] < cand[None, :]).astype(jnp.int32), axis=0
        )
        return jnp.where(below <= ranks, cand, prefix)

    found = jax.lax.fori_loop(
        0, 32, body, jnp.zeros(ranks.shape, jnp.uint32)
    )
    # Invert _sortable_u32's mapping.
    neg = ~(found >> jnp.uint32(31)).astype(bool)
    bits = jnp.where(neg, ~found, found & jnp.uint32(0x7FFFFFFF))
    return jax.lax.bitcast_convert_type(bits, jnp.float32)


def _percentile_ranks(q, n: jax.Array):
    """numpy's virtual index for percentile ``q`` of ``n`` values:
    ``(lo, hi, frac)`` with ``pos = q/100 * (n-1)`` (same float32
    arithmetic as ``np.percentile``'s float32 path)."""
    pos = jnp.asarray(q, jnp.float32) / 100.0 * jnp.maximum(n - 1, 0).astype(jnp.float32)
    lo = jnp.floor(pos).astype(jnp.int32)
    hi = jnp.ceil(pos).astype(jnp.int32)
    frac = pos - lo.astype(jnp.float32)
    return lo, hi, frac


def masked_nanpercentile(values: jax.Array, valid: jax.Array, q: jax.Array | float) -> jax.Array:
    """``np.nanpercentile`` (linear interpolation) over ``values[valid]``.

    Sort-free with static shapes: the two bracketing order statistics at
    ``pos = q/100 * (n-1)`` come from the bitwise binary-search selection
    (:func:`select_order_stats` -- bit-identical to sorting), and the result interpolates between them with
    numpy's exact ``_lerp`` arithmetic.  Returns NaN when nothing is valid.
    """
    flat = jnp.ravel(values)
    ok = jnp.ravel(valid) & ~jnp.isnan(flat)
    n = jnp.sum(ok)
    keys = _sortable_u32(flat, ok)
    lo, hi, frac = _percentile_ranks(q, n)
    s = select_order_stats(keys, jnp.stack([lo, hi]))
    v = _numpy_lerp(s[0], s[1], frac)
    # frac == 0 short-circuits so +/-inf endpoints don't produce inf-inf NaNs.
    v = jnp.where(frac == 0, s[0], v)
    return jnp.where(n > 0, v, jnp.nan)


def _block_fma(p: jax.Array) -> jax.Array:
    """Identity that stops XLA from contracting ``a + p``/``b - p`` to FMA.

    XLA:CPU emits ``llvm.fmuladd`` for any multiply feeding an add/sub,
    single-rounding the pair, while numpy rounds the product first -- the
    results differ in the last ulp for ~20%% of operand triples (measured),
    which breaks the host/device bit-parity contract on percentile bounds.
    A select whose arms differ survives both the HLO algebraic simplifier
    and LLVM instcombine (bitcast round-trips and optimization_barrier do
    NOT -- both get folded and the contraction proceeds, also measured);
    semantically this is the identity, NaN arm included.
    """
    return jnp.where(jnp.isnan(p), jnp.float32(jnp.nan), p)


def _numpy_lerp(a: jax.Array, b: jax.Array, t: jax.Array) -> jax.Array:
    """numpy's ``_lerp``, branch for branch AND rounding for rounding.

    ``a + (b-a)*t`` below ``t == 0.5`` and ``b - (b-a)*(1-t)`` above --
    NOT the symmetric ``a*(1-t) + b*t`` form -- with the product rounded
    to float32 before the add (see ``_block_fma``), exactly as numpy's
    float32 ufunc loop evaluates it (mirrored by
    ops/exact_percentile.numpy_lerp_percentile on the host).
    """
    diff = b - a
    return jnp.where(
        t >= 0.5,
        b - _block_fma(diff * (jnp.float32(1.0) - t)),
        a + _block_fma(diff * t),
    )


def _kept_energy_order(m_all_nan_col: jax.Array, e_valid: jax.Array, energy: jax.Array):
    """Resolve which energy columns survive masking and in what draw order.

    Returns ``(kept_pos, n_kept, flip, y0, y1)`` where ``kept_pos[j]`` is
    the original column index of the j-th kept bin (original file order),
    ``flip`` mirrors the reference's descending-energy reversal, and
    ``y0``/``y1`` are the *drawn* extent endpoints (post-flip first/last
    kept energies; reference plotting.py:200-202,284).
    """
    e_keep = (~m_all_nan_col) & e_valid
    n_e = energy.shape[0]
    iota = jax.lax.broadcasted_iota(jnp.int32, (n_e, 1), 0)[:, 0]
    key = jnp.where(e_keep, iota, n_e + 1)
    kept_pos = jnp.argsort(key)  # kept columns first, original order
    n_kept = jnp.sum(e_keep).astype(jnp.int32)
    first = energy[kept_pos[0]]
    last = energy[kept_pos[jnp.maximum(n_kept - 1, 0)]]
    flip = first > last
    y0 = jnp.where(flip, last, first)
    y1 = jnp.where(flip, first, last)
    return kept_pos, n_kept, flip, y0, y1


@functools.partial(jax.jit, static_argnames=("spec",))
def render_matrix(
    matrix: jax.Array,
    energy: jax.Array,
    e_valid: jax.Array,
    t_valid: jax.Array,
    t_start: jax.Array,
    t_count: jax.Array,
    x_map: jax.Array,
    z_bounds: jax.Array,
    lut: jax.Array,
    spec: RenderSpec,
    zb_e_valid: jax.Array | None = None,
    zb_full_time: jax.Array | bool = False,
    out_h: jax.Array | int | None = None,
    out_w: jax.Array | int | None = None,
) -> dict[str, jax.Array]:
    """Rasterize one collapsed (T, E) matrix to an RGBA tile.

    Parameters
    ----------
    matrix : (T, E) float32
        Collapsed spectrogram matrix; rows at/after ``t_valid`` must be NaN
        (as :func:`collapse_cube` produces).
    energy : (E,) float32
        Energy value per column (unfiltered).
    e_valid : (E,) bool
        Energy-range mask ``(energy >= y_min) & (energy <= y_max)``.
    t_valid : int32
        Number of real (unpadded) time rows in ``matrix``.
    t_start, t_count : int32
        Contiguous time window selected by zoom/x-clipping (host-computed
        via searchsorted over the host-resident time array; reference
        plotting.py:204-219).
    x_map : (2,) float32
        ``col_f = x_map[0] * px + x_map[1]`` maps output pixel column to a
        fractional matrix-row index in ``[0, t_count]``; out-of-range pixels
        render as background.  Encodes xlim vs. data extent (zoom columns
        may have blank margins, reference plotting.py:238-253).
    z_bounds : (2,) float32
        Explicit (z_min, z_max); NaN entries mean "compute the percentile
        bound" (reference percentile_utils.py:47-89).
    lut : (256, 4) uint8
        Colormap lookup table (:func:`..ops.colormap_lut`).
    spec : RenderSpec
        Static geometry/scale configuration.
    zb_e_valid : (E,) bool, optional
        Energy mask used only for the percentile *bounds* selection.  The
        FAST grids compute color bounds over the extrema-restricted energy
        range while the panel still displays 0-4000
        (reference fast/plotting.py:118-134,288-296 vs plotting.py:618-656).
        Defaults to ``e_valid``.
    zb_full_time : bool scalar, optional
        When true, percentile bounds pool the full file's rows rather than
        the zoom window (the FAST grids bound on the unzoomed matrix,
        reference fast/plotting.py:131-134).
    out_h, out_w : int32 scalars, optional
        Actual output size when ``spec.height``/``spec.width`` are padded
        bucket dimensions; pixels at or beyond them render as background
        and the host crops.  Letting these be *dynamic* means one compiled
        program serves every figure geometry in a bucket instead of one
        XLA program per exact tile size.  Default: the full static size.
        NOTE: the returned ``rgba`` is in origin-lower order (row 0 =
        bottom); the host flips after cropping.

    Returns
    -------
    dict
        ``rgba`` (H, W, 4) uint8; scalars ``vmin``, ``vmax`` (resolved
        color bounds), ``y0``, ``y1`` (drawn y extent), ``n_kept`` (kept
        energy columns), ``empty`` (bool: nothing to draw, the reference's
        ``(None, None)`` return path).
    """
    H, W = spec.height, spec.width
    out_h = jnp.asarray(H if out_h is None else out_h, jnp.int32)
    out_w = jnp.asarray(W if out_w is None else out_w, jnp.int32)
    T, E = matrix.shape
    a = _analyze_matrix(
        matrix, energy, e_valid, t_valid, t_start, t_count, z_bounds, spec, zb_e_valid, zb_full_time
    )
    idx = a["idx"].astype(jnp.int32)
    kept_pos, n_kept, flip = a["kept_pos"], a["n_kept"], a["flip"]
    y0, y1, vmin, vmax, empty = a["y0"], a["y1"], a["vmin"], a["vmax"], a["empty"]

    # --- imshow extent resampling (pixel replication) ----------------------
    px_i = jax.lax.broadcasted_iota(jnp.int32, (1, W), 1)
    px = px_i.astype(jnp.float32)
    col_f = x_map[0] * px + x_map[1]
    x_ok = (col_f >= 0.0) & (col_f <= t_count.astype(jnp.float32)) & (px_i < out_w)
    col = jnp.clip(col_f.astype(jnp.int32), 0, jnp.maximum(t_count - 1, 0))
    t_idx = jnp.clip(t_start + col, 0, T - 1)

    py_r = jax.lax.broadcasted_iota(jnp.int32, (H, 1), 0)
    py = (py_r.astype(jnp.float32) + 0.5) / out_h.astype(jnp.float32)
    y_ok = py_r < out_h
    nk = jnp.maximum(n_kept, 1).astype(jnp.float32)
    if spec.y_scale == "log":
        # Drawn image warps with the log axis: pixel -> data y via the
        # log-scaled ylim, then extent pixel replication in data space.
        ly0 = jnp.log10(jnp.maximum(y0, 1e-37))
        ly1 = jnp.log10(jnp.maximum(y1, 1e-37))
        y_data = jnp.power(10.0, ly0 + py * (ly1 - ly0))
        row_f = (y_data - y0) / jnp.where(y1 == y0, 1.0, y1 - y0) * nk
    else:
        row_f = py * nk
    row = jnp.clip(row_f.astype(jnp.int32), 0, jnp.maximum(n_kept - 1, 0))
    row_eff = jnp.where(flip, n_kept - 1 - row, row)
    e_idx = kept_pos[jnp.clip(row_eff, 0, E - 1)]  # (H, 1)

    tile_idx = idx[t_idx[0], :][:, e_idx[:, 0]]  # (W, H) gather rows then cols
    tile_idx = tile_idx.T  # (H, W)
    visible = x_ok & y_ok & ~empty  # (H, W) after broadcast

    lut_ext = jnp.concatenate(
        [jnp.asarray(lut, jnp.uint8), jnp.asarray(spec.bg_rgba, jnp.uint8)[None, :]], axis=0
    )
    final_idx = jnp.where(visible, tile_idx, 256)
    rgba = lut_ext[final_idx]  # (H, W, 4), origin='lower': row 0 = bottom
    # Flip vertically so the last row is the image bottom (PNG convention);
    # with padded buckets the valid region lands at rows [H-out_h, H), so
    # hosts crop ``rgba[H-out_h:, :out_w]``.
    rgba = rgba[::-1, :, :]

    return {
        "rgba": rgba,
        "vmin": vmin,
        "vmax": vmax,
        "y0": y0,
        "y1": y1,
        "n_kept": n_kept,
        "empty": empty,
    }


def _analyze_matrix(
    matrix: jax.Array,
    energy: jax.Array,
    e_valid: jax.Array,
    t_valid: jax.Array,
    t_start: jax.Array,
    t_count: jax.Array,
    z_bounds: jax.Array,
    spec: RenderSpec,
    zb_e_valid: jax.Array | None = None,
    zb_full_time: jax.Array | bool = False,
    skip_percentile: bool = False,
) -> dict[str, jax.Array]:
    """Masking, color bounds, normalization, and colormap quantization.

    Everything in ``make_spectrogram``'s data path that depends on the
    matrix *values* -- the output ``idx`` (T, E) uint8 plus small mapping
    metadata fully determine the pixels, so this is all a host ever needs
    to read back from the device (the resampling to screen pixels is pure
    index arithmetic either side can do).
    """
    T, E = matrix.shape
    matrix = matrix.astype(jnp.float32)
    energy = energy.astype(jnp.float32)

    t_index = jax.lax.broadcasted_iota(jnp.int32, (T, 1), 0)[:, 0]
    in_file = t_index < t_valid
    # All-NaN-column mask over the full (unzoomed) file rows
    # (reference plotting.py:191).
    col_all_nan = jnp.all(jnp.isnan(matrix) | ~in_file[:, None], axis=0)
    kept_pos, n_kept, flip, y0, y1 = _kept_energy_order(col_all_nan, e_valid, energy)

    in_window = in_file & (t_index >= t_start) & (t_index < t_start + t_count)
    e_keep = (~col_all_nan) & e_valid
    sel = in_window[:, None] & e_keep[None, :]
    empty = (n_kept == 0) | (t_count <= 0)

    # --- color bounds (reference plotting.py:259-277,307-315) -------------
    if zb_e_valid is None:
        zb_sel = sel
    else:
        zb_rows = jnp.where(jnp.asarray(zb_full_time), in_file, in_window)
        zb_sel = zb_rows[:, None] & ((~col_all_nan) & zb_e_valid)[None, :]
    zmin_arg, zmax_arg = z_bounds[0], z_bounds[1]
    if skip_percentile:
        # Caller guarantees both bounds are explicit (the given-extrema
        # half of a flagship batch): the sort never runs.
        vmin = zmin_arg.astype(jnp.float32)
        vmax = zmax_arg.astype(jnp.float32)
    else:
        # ONE 4-rank bitwise selection answers both percentile bounds --
        # no sort (VERDICT r4 item 5: the O(T*E log) sort was ~80% of the
        # percentile chain's device time; the selection is bit-identical
        # and HBM-bound, tools/bench_percentile_sort.py).
        flat = jnp.ravel(matrix)
        ok = jnp.ravel(zb_sel) & ~jnp.isnan(flat)
        n_ok = jnp.sum(ok)
        keys = _sortable_u32(flat, ok)
        lo1, hi1, frac1 = _percentile_ranks(spec.low_percentile, n_ok)
        lo2, hi2, frac2 = _percentile_ranks(spec.high_percentile, n_ok)
        stats = select_order_stats(keys, jnp.stack([lo1, hi1, lo2, hi2]))

        def _pct(s_lo, s_hi, frac):
            # numpy's _lerp branch for branch and rounding for rounding
            # (see _numpy_lerp/_block_fma): the symmetric form and the
            # FMA-contracted form each differ from np.percentile in the
            # last float32 ulp and can flip a colormap bin against the
            # host backend.
            v = _numpy_lerp(s_lo, s_hi, frac)
            v = jnp.where(frac == 0, s_lo, v)
            return jnp.where(n_ok > 0, v, jnp.nan)

        vmin = jnp.where(
            jnp.isnan(zmin_arg), _pct(stats[0], stats[1], frac1), zmin_arg
        ).astype(jnp.float32)
        vmax = jnp.where(
            jnp.isnan(zmax_arg), _pct(stats[2], stats[3], frac2), zmax_arg
        ).astype(jnp.float32)

    finite_positive = jnp.isfinite(matrix) & (matrix > 0) & sel
    safe_vmin = jnp.where(
        jnp.any(finite_positive),
        jnp.min(jnp.where(finite_positive, matrix, _BIG)),
        jnp.float32(1e-10),
    )

    if spec.z_scale == "log":
        vmin = jnp.maximum(jnp.maximum(vmin, safe_vmin), 1e-10)
        work = jnp.where(~jnp.isfinite(matrix) | (matrix <= 0), vmin, matrix)
        log_vmin = jnp.log10(vmin)
        log_span = jnp.log10(vmax) - log_vmin
        ramp = (jnp.log10(jnp.maximum(work, 1e-37)) - log_vmin) / jnp.where(log_span == 0, 1.0, log_span)
        # matplotlib's Normalize fills 0 for EVERY cell when vmin == vmax
        # (the reference's LogNorm path paints the whole panel LUT[0]).
        # The degeneracy test must use the raw bounds: XLA may lower the
        # scalar and elementwise log10 differently (observed 8e-9 apart
        # for identical inputs on CPU), so ``log_span == 0`` is not a
        # reliable vmin==vmax detector under jit.
        norm = jnp.where(vmin == vmax, 0.0, ramp)
    else:
        work = jnp.where(jnp.isnan(matrix), vmin, matrix)
        work = jnp.where(jnp.isneginf(work), vmin, work)
        work = jnp.where(jnp.isposinf(work), vmax, work)
        # Degenerate/invalid bounds fall back to the substituted matrix's
        # own min/max (reference plotting.py:313-315).
        bad = ~(jnp.isfinite(vmin) & jnp.isfinite(vmax) & (vmax > vmin))
        fb_min = jnp.min(jnp.where(sel, work, _BIG))
        fb_max = jnp.max(jnp.where(sel, work, -_BIG))
        vmin = jnp.where(bad & ~empty, fb_min, vmin)
        vmax = jnp.where(bad & ~empty, fb_max, vmax)
        span = vmax - vmin
        # Same matplotlib rule as the log arm: vmin == vmax -> norm 0
        # everywhere.  (After the fallback recompute this only happens for
        # constant substituted data, where the ramp is 0 anyway -- the
        # explicit where keeps the semantics independent of how XLA
        # evaluates the division.)
        ramp = (work - vmin) / jnp.where(span == 0, 1.0, span)
        norm = jnp.where(vmin == vmax, 0.0, ramp)

    # matplotlib Colormap.__call__ index rule: int(norm * N), N==256,
    # under -> 0, over -> N-1 (the default under/over colors).  NaN cells
    # (NaN percentile bounds surviving to the ramp -- the NaN-span case
    # the host path pins at render/host_quantize.py:151) map to LUT[0]
    # explicitly; clip propagates NaN and the NaN->uint8 convert is
    # platform-defined under XLA just as it is in C.
    norm = jnp.where(jnp.isnan(norm), 0.0, norm)
    idx = jnp.clip(jnp.floor(norm * 256.0), 0, 255).astype(jnp.uint8)

    return {
        "idx": idx,
        "kept_pos": kept_pos.astype(jnp.int32),
        "n_kept": n_kept,
        "flip": flip,
        "y0": y0,
        "y1": y1,
        "vmin": vmin,
        "vmax": vmax,
        "empty": empty,
    }


@functools.partial(jax.jit, static_argnames=("spec", "skip_percentile"))
def quantize_matrix(
    matrix: jax.Array,
    energy: jax.Array,
    e_valid: jax.Array,
    t_valid: jax.Array,
    t_start: jax.Array,
    t_count: jax.Array,
    z_bounds: jax.Array,
    spec: RenderSpec,
    zb_e_valid: jax.Array | None = None,
    zb_full_time: jax.Array | bool = False,
    skip_percentile: bool = False,
) -> dict[str, jax.Array]:
    """Jitted :func:`_analyze_matrix`: the light-readback production path.

    Returns the quantized colormap-index matrix (T, E) uint8 plus mapping
    metadata.  The host resamples to screen pixels with
    :func:`configurable_spectrograms_tpu.render.tile.resample_indices`,
    keeping device->host traffic ~300x smaller than shipping RGBA tiles
    (that path, :func:`render_matrix`, remains for fully-on-device use).
    ``skip_percentile=True`` (static) compiles a sort-free program for
    panels whose color bounds are both explicit.
    """
    return _analyze_matrix(
        matrix, energy, e_valid, t_valid, t_start, t_count, z_bounds, spec,
        zb_e_valid, zb_full_time, skip_percentile,
    )


@functools.partial(jax.jit, static_argnames=("spec",))
def render_panels(
    matrices: jax.Array,
    energies: jax.Array,
    e_valids: jax.Array,
    t_valids: jax.Array,
    t_starts: jax.Array,
    t_counts: jax.Array,
    x_maps: jax.Array,
    z_bounds: jax.Array,
    luts: jax.Array,
    spec: RenderSpec,
) -> dict[str, jax.Array]:
    """Vmapped :func:`render_matrix` across a batch of panels.

    All leading dimensions are the panel axis; one dispatch rasterizes a
    whole figure (or a whole batch of figures sharing a ``RenderSpec``).
    """

    def one(m, en, ev, tv, ts, tc, xm, zb, lut):
        return render_matrix(m, en, ev, tv, ts, tc, xm, zb, lut, spec)

    return jax.vmap(one)(
        matrices, energies, e_valids, t_valids, t_starts, t_counts, x_maps, z_bounds, luts
    )

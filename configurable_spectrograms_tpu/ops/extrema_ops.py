"""Device-side statistics for the folder-wide extrema pass.

The reference's extrema scan pools every positive sample of every file in
host memory and re-runs ``np.nanpercentile`` per orbit
(reference fast/extrema.py:245-285) -- O(total samples) memory.  Here each
file reduces on device to two fixed-size summaries:

* per-energy-bin positive-finite counts (E,), feeding the 99%%-cumulative
  energy-coverage rule, exactly as the reference computes it;
* a 4096-bin log10 histogram of positive-finite collapsed values, from
  which any percentile is answered by the containing bin's UPPER edge
  instead of an exact pool.  Accuracy: the returned value is within one
  bin (24 decades / 4096 = 0.0059 dex, < 1.4%% relative) of the upper
  straddling *sample*; on dense pools (real FAST folders pool millions
  of positives) that is the whole error.  On sparse pools, where
  ``np.nanpercentile`` interpolates between two distant samples, the
  upper-edge rule errs above the interpolated value by up to the
  samples' gap -- deliberately conservative: a too-high z_max only
  compresses the color ramp, while a too-low one would clip it.  The
  reference then applies ``math.ceil`` to the result, absorbing most of
  the dense-pool error.

These summaries are tiny, mergeable by addition, and therefore shard
cleanly: :mod:`configurable_spectrograms_tpu.parallel.extrema` psums them
across a device mesh.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from configurable_spectrograms_tpu.ops.spectrogram import collapse_cube

HIST_BINS = 4096
LOG_LO = -12.0
LOG_HI = 12.0


def sorted_bincount(bins: jax.Array, n_bins: int) -> jax.Array:
    """Histogram of integer *bins* via sort + vectorized binary search.

    Sort + ``searchsorted`` over the bin edges stands in for a scatter-add
    (``.at[].add``) histogram, which compiled to a long serialized loop on
    the accelerator this was first written for; whether a scatter-add is
    the faster choice on a GPU is unmeasured.  Entries >= ``n_bins`` fall
    off the end (use as the invalid/overflow slot).
    """
    s = jnp.sort(jnp.ravel(bins))
    edges = jax.lax.broadcasted_iota(jnp.int32, (n_bins + 1, 1), 0)[:, 0]
    starts = jnp.searchsorted(s, edges, side="left")
    return (starts[1:] - starts[:-1]).astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=())
def file_extrema_stats(cube: jax.Array, t_valid: jax.Array) -> dict[str, jax.Array]:
    """Reduce one (T, A, E) cube to extrema summaries.

    Returns ``counts`` (E,) int32 positive-finite samples per energy bin of
    the pitch-collapsed matrix, and ``hist`` (HIST_BINS,) int32 log10
    histogram of the positive-finite collapsed values.
    """
    A = cube.shape[1]
    collapsed = collapse_cube(cube, jnp.ones((A,), bool), t_valid)  # (T, E)
    fp = jnp.isfinite(collapsed) & (collapsed > 0)
    counts = jnp.sum(fp, axis=0).astype(jnp.int32)
    logv = jnp.log10(jnp.where(fp, collapsed, 1.0))
    bin_f = (logv - LOG_LO) / (LOG_HI - LOG_LO) * HIST_BINS
    bins = jnp.clip(bin_f.astype(jnp.int32), 0, HIST_BINS - 1)
    flat_bins = jnp.where(jnp.ravel(fp), jnp.ravel(bins), HIST_BINS)  # invalid -> overflow
    return {"counts": counts, "hist": sorted_bincount(flat_bins, HIST_BINS)}


@functools.lru_cache(maxsize=4)
def _batched_stats_fn(sharded: bool, mesh=None):
    """The (cached) jitted per-file stats program, optionally mesh-sharded.

    When sharded, files partition over the data-parallel mesh's ``data``
    axis: the per-file reduction needs zero collectives, so each device scans
    its shard of the archive -- the extrema pre-pass's multi-chip fan-out
    (the host-pooled equivalent is reference fast/extrema.py:245-285).
    Production callers pass the mesh they already captured:
    ``data_parallel_mesh()`` is backend-state-dependent (it returns None
    once the host backend is forced), so re-resolving it here could
    disagree with the caller's padding mid-flip and raise.
    """
    batched = jax.vmap(file_extrema_stats)
    if not sharded:
        return jax.jit(batched)
    from jax.sharding import NamedSharding, PartitionSpec as P

    if mesh is None:
        from configurable_spectrograms_tpu.parallel.mesh import data_parallel_mesh

        mesh = data_parallel_mesh()
    lane = NamedSharding(mesh, P("data"))
    return jax.jit(batched, in_shardings=(lane, lane), out_shardings=lane)


#: Diagnostics for the last device extrema dispatch (the multichip dryrun
#: asserts the pre-pass actually spans the mesh, mirroring
#: ``render.figure.LAST_DISPATCH`` for the render path).
LAST_DISPATCH: dict[str, int] = {"lanes": 0, "devices": 0}


def collapsed_positives(cube: np.ndarray) -> np.ndarray:
    """The reference's pooled samples for one file: positive finite values
    of the pitch-collapsed (nansum over axis 1) float32 matrix
    (reference fast/extrema.py:260-267).  The single host-side definition
    of this math -- the exact-percentile tracker and the extrema pass both
    use it, so their pools can never drift apart.
    """
    collapsed = np.where(np.isnan(cube), np.float32(0.0), cube).sum(axis=1, dtype=np.float32)
    return collapsed[np.isfinite(collapsed) & (collapsed > 0)]


def value_bins(values: np.ndarray) -> np.ndarray:
    """The log10 histogram bin of each positive finite float32 value.

    The single host-side definition of the binning (identical float32
    arithmetic to :func:`file_extrema_stats` on device); the
    exact-percentile tracker's rank/gather consistency depends on every
    consumer binning identically.
    """
    logv = np.log10(values, dtype=np.float32)
    return np.clip(
        ((logv - np.float32(LOG_LO)) / np.float32(LOG_HI - LOG_LO) * np.float32(HIST_BINS)).astype(np.int32),
        0,
        HIST_BINS - 1,
    )


def host_file_stats(cube: np.ndarray) -> dict[str, np.ndarray]:
    """Pure-numpy mirror of :func:`file_extrema_stats` (same float32 math).

    The host backend's extrema statistics and the device path's parity
    reference.
    """
    collapsed = np.where(np.isnan(cube), np.float32(0.0), cube).sum(axis=1, dtype=np.float32)
    fp = np.isfinite(collapsed) & (collapsed > 0)
    counts = fp.sum(axis=0).astype(np.int32)
    hist = np.bincount(value_bins(collapsed[fp]), minlength=HIST_BINS).astype(np.int32)
    return {"counts": counts, "hist": hist}


def batched_file_stats(cubes: list[np.ndarray]) -> list[dict[str, np.ndarray]]:
    """Compute :func:`file_extrema_stats` for many host cubes in one dispatch.

    Cubes are padded to the max (T, A, E) in the batch (NaN padding, which
    the collapse masks out via ``t_valid`` and nansum semantics).  On a
    multi-device host the file batch additionally pads to a multiple of
    the device count (all-NaN dummy files reduce to empty summaries) and
    shards over the mesh.  On the host backend (``CST_RENDER_BACKEND=host``,
    or ``auto`` after it demoted the device) the stats compute in numpy.
    """
    if not cubes:
        return []
    from configurable_spectrograms_tpu.render.figure import _host_backend_active, probe_device_link

    probe_device_link()
    if _host_backend_active():
        return [host_file_stats(np.asarray(c, np.float32)) for c in cubes]
    from configurable_spectrograms_tpu.parallel.mesh import data_parallel_mesh

    mesh = data_parallel_mesh()
    n = len(cubes)
    n_lanes = n
    if mesh is not None:
        d = int(mesh.devices.size)
        n_lanes = ((n + d - 1) // d) * d
    Tm = max(c.shape[0] for c in cubes)
    Am = max(c.shape[1] for c in cubes)
    Em = max(c.shape[2] for c in cubes)
    batch = np.full((n_lanes, Tm, Am, Em), np.nan, np.float32)
    t_valids = np.zeros((n_lanes,), np.int32)
    for i, c in enumerate(cubes):
        T, A, E = c.shape
        batch[i, :T, :A, :E] = c
        t_valids[i] = T
    from configurable_spectrograms_tpu.render.figure import (
        _BACKEND,
        _bounded_call,
        _dispatch_timeout,
        force_host_after_dispatch_failure,
    )

    def _dispatch():
        if mesh is not None:
            # Explicit placement: multi-process jit refuses numpy inputs
            # with non-trivial shardings (see render/figure._enqueue_group).
            from jax.sharding import NamedSharding, PartitionSpec

            lane_sh = NamedSharding(mesh, PartitionSpec("data"))
            args = (jax.device_put(batch, lane_sh), jax.device_put(t_valids, lane_sh))
        else:
            args = (jnp.asarray(batch), jnp.asarray(t_valids))
        out = _batched_stats_fn(mesh is not None, mesh)(*args)
        LAST_DISPATCH["lanes"] = n_lanes
        LAST_DISPATCH["devices"] = len(getattr(out["counts"].sharding, "device_set", ())) or 1
        return np.asarray(out["counts"]), np.asarray(out["hist"])

    # Same hazard as the render path: a link dying between the preflight
    # and this transfer hangs forever without a bound, deadlocking the
    # whole extrema pre-pass.  On expiry the abandoned thread pins this
    # chunk's padded batch for the process lifetime -- a bounded one-time
    # cost, since callers chunk to <= flush_batch_size orbits
    # (fast/extrema.py:202-203).
    ok, value = _bounded_call(_dispatch, _dispatch_timeout())
    if not ok:
        from configurable_spectrograms_tpu.utils.logging import log_error

        if _BACKEND["mode"] == "device":
            raise RuntimeError(
                "extrema dispatch/readback exceeded CST_DEVICE_DISPATCH_TIMEOUT "
                "with CST_RENDER_BACKEND=device"
            )
        force_host_after_dispatch_failure()
        log_error(
            "[BACKEND] extrema dispatch/readback timed out; abandoning the "
            "transfer and finishing the scan on the host backend"
        )
        return [host_file_stats(np.asarray(c, np.float32)) for c in cubes]
    counts, hist = value
    return [
        {"counts": counts[i, : cubes[i].shape[2]], "hist": hist[i]} for i in range(n)
    ]


def hist_percentile(hist: np.ndarray, q: float) -> float:
    """Percentile of the values summarized by a log10 *hist* (upper-edge rule).

    Linear-interpolation position like ``np.nanpercentile`` on the sample
    count, resolved to the containing bin's upper edge in value space.
    Returns 0.0 for an empty histogram.
    """
    n = int(hist.sum())
    if n == 0:
        return 0.0
    pos = q / 100.0 * (n - 1)
    cum = np.cumsum(hist)
    b = int(np.searchsorted(cum, pos + 1.0, side="left"))
    b = min(b, HIST_BINS - 1)
    edge = LOG_LO + (b + 1) / HIST_BINS * (LOG_HI - LOG_LO)
    return float(10.0**edge)

"""Sharded batch rasterization over a device mesh.

The render path is embarrassingly parallel across panels, so scaling is
pure data parallelism: pad the panel batch to a multiple of the ``data``
axis, place every per-panel input with ``NamedSharding(mesh, P('data'))``,
and jit once -- XLA partitions the whole collapse+percentile+resample+LUT
pipeline with zero collectives and each device rasterizes its shard.  This
is the replacement for the reference's 4-process plot pool
(reference fast/batch_directory.py:337).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from configurable_spectrograms_tpu.ops.spectrogram import RenderSpec, collapse_cube, render_matrix


@functools.lru_cache(maxsize=None)
def _sharded_render_fn(spec_key: tuple, mesh_key):
    mesh, = mesh_key
    spec = RenderSpec(*spec_key)

    def one(cube, pm, tv, en, ev, ts, tc, xm, zb, lut, oh, ow):
        m = collapse_cube(cube, pm, tv)
        return render_matrix(m, en, ev, tv, ts, tc, xm, zb, lut, spec, out_h=oh, out_w=ow)

    batched = jax.vmap(one)
    sharding = NamedSharding(mesh, P("data"))
    return jax.jit(
        batched,
        in_shardings=(sharding,) * 12,
        out_shardings=sharding,
    )


def sharded_batch_render(
    mesh: Mesh,
    spec: RenderSpec,
    cubes: np.ndarray,
    pitch_masks: np.ndarray,
    t_valids: np.ndarray,
    energies: np.ndarray,
    e_valids: np.ndarray,
    t_starts: np.ndarray,
    t_counts: np.ndarray,
    x_maps: np.ndarray,
    z_bounds: np.ndarray,
    luts: np.ndarray,
    out_h: int | None = None,
    out_w: int | None = None,
) -> dict[str, np.ndarray]:
    """Rasterize a panel batch sharded over the mesh's ``data`` axis.

    The leading (panel) dimension of every argument must be a multiple of
    the ``data`` axis size -- pad with dummy panels (``t_counts=0`` renders
    background) and slice the results.  Returns host numpy arrays.
    """
    n = cubes.shape[0]
    data_size = mesh.shape["data"]
    if n % data_size != 0:
        raise ValueError(f"panel batch ({n}) must be a multiple of the data axis ({data_size})")
    fn = _sharded_render_fn(
        (spec.height, spec.width, spec.y_scale, spec.z_scale, spec.low_percentile, spec.high_percentile,
         spec.bg_rgba),
        (mesh,),
    )
    ohs = np.full((n,), spec.height if out_h is None else out_h, np.int32)
    ows = np.full((n,), spec.width if out_w is None else out_w, np.int32)
    out = fn(
        jnp.asarray(cubes, jnp.float32),
        jnp.asarray(pitch_masks),
        jnp.asarray(t_valids, jnp.int32),
        jnp.asarray(energies, jnp.float32),
        jnp.asarray(e_valids),
        jnp.asarray(t_starts, jnp.int32),
        jnp.asarray(t_counts, jnp.int32),
        jnp.asarray(x_maps, jnp.float32),
        jnp.asarray(z_bounds, jnp.float32),
        jnp.asarray(luts),
        jnp.asarray(ohs),
        jnp.asarray(ows),
    )
    return {k: np.asarray(v) for k, v in out.items()}

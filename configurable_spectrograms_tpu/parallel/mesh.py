"""Device-mesh construction helpers."""

from __future__ import annotations

import functools
import os

import jax
import numpy as np
from jax.sharding import Mesh


def data_parallel_mesh() -> Mesh | None:
    """The process-wide 1-axis ``('data',)`` mesh over every local device.

    This is what the production render and extrema paths shard over --
    the replacement for the reference's 4-process plot pool
    (reference fast/batch_directory.py:337).  Returns ``None`` on a single
    device (the unsharded programs are then compiled without partitioning)
    or when ``CST_DATA_MESH=0`` (the test/debug escape hatch for comparing
    sharded vs single-device output).
    """
    if os.environ.get("CST_DATA_MESH", "1") == "0":
        return None
    # A host backend (explicit, or demoted by the opt-in ``auto`` link
    # policy) never needs the mesh, so it must not enumerate devices; the
    # preflight is a no-op outside ``auto`` mode.
    from configurable_spectrograms_tpu.render import link

    link.probe_device_link()
    if link._host_backend_active():
        return None
    return _cached_data_mesh()


@functools.lru_cache(maxsize=1)
def _cached_data_mesh() -> Mesh | None:
    # LOCAL devices: under jax.distributed, jax.devices() spans every host,
    # but the render/extrema dispatches feed process-local numpy arrays --
    # a mesh over remote devices would make device_put unaddressable.  Each
    # host shards its own batches over its own chips (the per-host process
    # pool the reference ran, reference fast/batch_directory.py:337); the
    # cross-host reductions go through parallel/extrema's global meshes.
    devices = jax.local_devices()
    if len(devices) < 2:
        return None
    return Mesh(np.asarray(devices), ("data",))


def make_mesh(
    n_devices: int | None = None,
    axis_names: tuple[str, ...] = ("data",),
    axis_sizes: tuple[int, ...] | None = None,
) -> Mesh:
    """Build a mesh over the first ``n_devices`` devices.

    ``axis_sizes`` defaults to putting every device on the first axis.  On
    a single chip this degenerates to a 1-device mesh, so the same sharded
    code path runs everywhere (tests use the virtual 8-device CPU backend,
    ``XLA_FLAGS=--xla_force_host_platform_device_count=8``).
    """
    devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    if n_devices > len(devices):
        raise ValueError(f"requested {n_devices} devices but only {len(devices)} available")
    devices = devices[:n_devices]
    if axis_sizes is None:
        axis_sizes = (n_devices,) + (1,) * (len(axis_names) - 1)
    if int(np.prod(axis_sizes)) != n_devices:
        raise ValueError(f"axis sizes {axis_sizes} do not multiply to {n_devices}")
    return Mesh(np.asarray(devices).reshape(axis_sizes), axis_names)


def pad_to_multiple(n: int, m: int) -> int:
    """Smallest multiple of *m* that is >= *n* (and >= m)."""
    return max(m, ((n + m - 1) // m) * m)


def global_file_batch(
    local_cubes: np.ndarray,
    local_t_valids: np.ndarray,
    mesh: Mesh,
):
    """Assemble per-process file shards into global mesh-sharded arrays.

    Multi-host batch runs give every host its own slice of the archive
    (the DCN equivalent of the reference's single-host process pool); each
    host passes its local ``(n_local, T, A, E)`` cube stack here and gets
    back global ``jax.Array``s sharded over the mesh's ``data`` axis,
    ready for :func:`..parallel.extrema.sharded_extrema_stats`.  The
    global file count is ``n_local * process_count`` (pad the local stack
    with NaN-cube / ``t_valid=0`` lanes so every host contributes the
    same count).  On a single-process mesh this is just ``device_put``
    with the same sharding.
    """
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec

    cubes = np.ascontiguousarray(local_cubes, np.float32)
    t_valids = np.ascontiguousarray(local_t_valids, np.int32)
    cube_sh = NamedSharding(mesh, PartitionSpec("data", *([None] * (cubes.ndim - 1))))
    tv_sh = NamedSharding(mesh, PartitionSpec("data"))
    if jax.process_count() == 1:
        return jax.device_put(jnp.asarray(cubes), cube_sh), jax.device_put(jnp.asarray(t_valids), tv_sh)
    n_global = cubes.shape[0] * jax.process_count()
    return (
        jax.make_array_from_process_local_data(cube_sh, cubes, (n_global, *cubes.shape[1:])),
        jax.make_array_from_process_local_data(tv_sh, t_valids, (n_global,)),
    )


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Initialize multi-host JAX (DCN) before building meshes.

    Thin wrapper over ``jax.distributed.initialize`` so multi-host batch
    runs (every host feeding its local chips, extrema psums riding
    ICI within a slice and DCN across hosts) need one call; arguments are
    auto-detected from the cluster environment when omitted.  Single-host
    runs never need this.

    Multi-host scoping (deliberate, see docs/deployment.md): under
    ``jax.distributed`` the RENDER dispatch still shards over local
    devices only (:func:`data_parallel_mesh`); hosts partition the
    archive at the orbit level, and the extrema reduction is the single
    cross-host collective.  Both behaviors run under two real processes
    in ``tests/multihost_worker.py``.
    """
    import jax

    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    jax.distributed.initialize(**kwargs)
    _DISTRIBUTED["process_id"] = int(jax.process_index())
    _DISTRIBUTED["num_processes"] = int(jax.process_count())


#: Distributed-run identity recorded by :func:`init_distributed`.  The
#: batch drivers consult THIS (not ``jax.process_count()``) to decide
#: orbit sharding: calling into jax would initialize the backend, which
#: on a dead remote link hangs unboundedly (the exact hazard
#: ``data_parallel_mesh`` routes around), while a plain dict read is
#: always safe.  Processes that initialize ``jax.distributed`` directly
#: can set the same facts via :func:`set_process_shard`.
_DISTRIBUTED = {"process_id": 0, "num_processes": 1}


def process_shard_info() -> tuple[int, int]:
    """``(process_id, num_processes)`` of this multi-host run (0, 1 alone)."""
    return _DISTRIBUTED["process_id"], _DISTRIBUTED["num_processes"]


def set_process_shard(process_id: int, num_processes: int) -> None:
    """Record multi-host identity for callers that bypassed init_distributed."""
    _DISTRIBUTED["process_id"] = int(process_id)
    _DISTRIBUTED["num_processes"] = int(num_processes)

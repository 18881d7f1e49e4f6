"""Multi-device tests on the virtual 8-device CPU mesh."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from configurable_spectrograms_tpu.ops import RenderSpec, collapse_cube, colormap_lut, render_matrix  # noqa: E402
from configurable_spectrograms_tpu.ops.extrema_ops import batched_file_stats, hist_percentile  # noqa: E402
from configurable_spectrograms_tpu.parallel import make_mesh, sharded_batch_render, sharded_extrema_stats  # noqa: E402


def _require_devices(n):
    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} devices")


def test_make_mesh_shapes():
    _require_devices(8)
    mesh = make_mesh(8)
    assert mesh.shape == {"data": 8}
    mesh2 = make_mesh(8, axis_names=("data", "time"), axis_sizes=(4, 2))
    assert mesh2.shape == {"data": 4, "time": 2}
    with pytest.raises(ValueError):
        make_mesh(10**6)


def test_sharded_extrema_matches_single_device(rng):
    _require_devices(8)
    N, T, A, E = 8, 32, 4, 8
    cubes = (rng.random((N, T, A, E)) * 50).astype(np.float32)
    cubes[rng.random(cubes.shape) < 0.1] = np.nan
    t_valids = rng.integers(8, T, size=N).astype(np.int32)
    for i in range(N):
        cubes[i, t_valids[i]:] = np.nan

    mesh = make_mesh(8, axis_names=("data", "time"), axis_sizes=(4, 2))
    counts, hist = sharded_extrema_stats(cubes, t_valids, mesh)

    ref = batched_file_stats([cubes[i, : t_valids[i]] for i in range(N)])
    ref_counts = np.stack([r["counts"] for r in ref])
    ref_hist = np.sum([r["hist"] for r in ref], axis=0)
    np.testing.assert_array_equal(counts, ref_counts)
    np.testing.assert_array_equal(hist, ref_hist)
    # Percentile from the global hist is close to the exact pooled value.
    pooled = []
    for i in range(N):
        c = np.nansum(np.nan_to_num(cubes[i, : t_valids[i]], nan=0.0), axis=1)
        pooled.append(c[np.isfinite(c) & (c > 0)])
    exact = np.nanpercentile(np.concatenate(pooled), 95.0)
    assert hist_percentile(hist, 95.0) == pytest.approx(exact, rel=0.02)


def test_sharded_render_matches_single_device(rng):
    _require_devices(8)
    mesh = make_mesh(8)
    N, T, A, E = 8, 40, 4, 8
    H, W = 32, 64
    cubes = (rng.random((N, T, A, E)) * 100).astype(np.float32)
    energies = np.tile(np.geomspace(4000, 10, E).astype(np.float32), (N, 1))
    spec = RenderSpec(height=H, width=W, y_scale="linear", z_scale="log")
    args = dict(
        cubes=cubes,
        pitch_masks=np.ones((N, A), bool),
        t_valids=np.full(N, T, np.int32),
        energies=energies,
        e_valids=np.ones((N, E), bool),
        t_starts=np.zeros(N, np.int32),
        t_counts=np.full(N, T, np.int32),
        x_maps=np.tile(np.array([T / W, 0.5 * T / W], np.float32), (N, 1)),
        z_bounds=np.full((N, 2), np.nan, np.float32),
        luts=np.tile(colormap_lut("viridis")[None], (N, 1, 1)),
    )
    out = sharded_batch_render(mesh, spec, **args)
    assert out["rgba"].shape == (N, H, W, 4)
    # Compare panel 3 against the unsharded single-panel path.
    single = render_matrix(
        collapse_cube(jnp.asarray(cubes[3]), jnp.ones(A, bool), T),
        jnp.asarray(energies[3]),
        jnp.ones(E, bool),
        jnp.int32(T),
        jnp.int32(0),
        jnp.int32(T),
        jnp.asarray(args["x_maps"][3]),
        jnp.asarray(args["z_bounds"][3]),
        jnp.asarray(colormap_lut("viridis")),
        spec,
    )
    np.testing.assert_array_equal(out["rgba"][3], np.asarray(single["rgba"]))
    np.testing.assert_allclose(out["vmin"][3], float(single["vmin"]), rtol=1e-6)


def test_sharded_render_rejects_bad_batch(rng):
    _require_devices(8)
    mesh = make_mesh(8)
    spec = RenderSpec(height=8, width=8)
    with pytest.raises(ValueError):
        sharded_batch_render(
            mesh, spec,
            cubes=np.zeros((3, 4, 2, 2), np.float32),
            pitch_masks=np.ones((3, 2), bool),
            t_valids=np.full(3, 4, np.int32),
            energies=np.ones((3, 2), np.float32),
            e_valids=np.ones((3, 2), bool),
            t_starts=np.zeros(3, np.int32),
            t_counts=np.full(3, 4, np.int32),
            x_maps=np.zeros((3, 2), np.float32),
            z_bounds=np.zeros((3, 2), np.float32),
            luts=np.zeros((3, 256, 4), np.uint8),
        )


def test_init_distributed_forwards_arguments(monkeypatch):
    """The multi-host bootstrap forwards only the provided arguments to
    jax.distributed.initialize (auto-detection otherwise)."""
    from configurable_spectrograms_tpu.parallel import mesh as mesh_mod

    calls = []
    monkeypatch.setattr(jax.distributed, "initialize", lambda **kw: calls.append(kw))
    mesh_mod.init_distributed()
    mesh_mod.init_distributed(coordinator_address="h:1234", num_processes=4, process_id=1)
    assert calls == [
        {},
        {"coordinator_address": "h:1234", "num_processes": 4, "process_id": 1},
    ]


def test_data_parallel_mesh_never_enumerates_devices_on_host_backend(monkeypatch):
    """A forced/pre-selected host backend must get ``None`` WITHOUT touching
    ``jax.local_devices()``: a host-backend process must never initialize
    (or wait on) a device backend just to learn it needs no mesh."""
    from configurable_spectrograms_tpu.parallel import mesh as mesh_mod
    from configurable_spectrograms_tpu.render import link

    monkeypatch.setitem(link._BACKEND, "mode", "host")
    mesh_mod._cached_data_mesh.cache_clear()

    def _boom():  # the hang, made loud
        raise AssertionError("jax.local_devices() must not be called on the host backend")

    monkeypatch.setattr(mesh_mod.jax, "local_devices", _boom)
    try:
        assert mesh_mod.data_parallel_mesh() is None
    finally:
        mesh_mod._cached_data_mesh.cache_clear()

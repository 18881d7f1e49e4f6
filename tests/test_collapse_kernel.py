"""The Triton collapse kernel, run in interpret mode on the CPU."""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from configurable_spectrograms_tpu.ops import collapse_kernel
from configurable_spectrograms_tpu.ops.spectrogram import collapse_cube


def _stack(rng, U, T, A, E):
    cubes = rng.poisson(20.0, size=(U, T, A, E)).astype(np.float32)
    cubes += rng.random(cubes.shape).astype(np.float32)  # non-integer sums
    cubes[rng.random(cubes.shape) < 0.05] = np.nan
    cubes[0, 1, 0, 0] = np.inf
    return cubes


@pytest.mark.parametrize("U, T, A, E, lanes", [
    (3, 64, 8, 24, 5),    # FAST-like, one time tile pair
    (2, 40, 8, 24, 3),    # T not a multiple of the time tile
    (1, 32, 1, 200, 2),   # audio-like: one pitch bin, two energy tiles
])
def test_kernel_matches_collapse_cube(rng, U, T, A, E, lanes):
    cubes = _stack(rng, U, T, A, E)
    u = rng.integers(0, U, size=lanes).astype(np.int32)
    pm = rng.random((lanes, A)) < 0.6
    pm[0] = True
    tv = rng.integers(1, T + 1, size=lanes).astype(np.int32)
    ref = np.asarray(jax.vmap(collapse_cube)(jnp.asarray(cubes)[u], pm, tv))
    got = np.asarray(collapse_kernel.collapse_lanes(cubes, u, pm, tv, interpret=True))
    assert got.shape == (lanes, T, E)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    np.testing.assert_allclose(got, ref, rtol=1e-6, equal_nan=True)


def test_kernel_adds_pitch_bins_in_numpy_order(rng):
    """Bins are added in index order, as numpy's nansum over that axis does,
    so the kernel matches the host reference bit for bit."""
    cubes = _stack(rng, 1, 32, 16, 24)
    pm = np.ones((1, 16), bool)
    got = np.asarray(collapse_kernel.collapse_lanes(cubes, np.zeros(1, np.int32), pm,
                                                    np.array([32], np.int32), interpret=True))
    host = np.where(np.isnan(cubes[0]), np.float32(0.0), cubes[0]).sum(axis=1, dtype=np.float32)
    np.testing.assert_array_equal(got[0], host)


def test_kernel_applies_only_on_a_gpu(monkeypatch):
    assert not collapse_kernel.applies((4, 1024, 64, 96))
    monkeypatch.setattr(collapse_kernel.jax, "default_backend", lambda: "gpu")
    assert collapse_kernel.applies((4, 1024, 64, 96))
    assert not collapse_kernel.applies((64, 8192, 64, 96))  # int32 offsets overflow


@pytest.mark.parametrize("data_mesh", ["1", "0"])
def test_render_program_with_the_kernel_matches_host(rng, monkeypatch, data_mesh):
    """The render program with the kernel in place of XLA's collapse, alone
    and per device under the 8-device mesh (shard_map), matches the host
    backend exactly."""
    from configurable_spectrograms_tpu.render import dispatch, link
    from configurable_spectrograms_tpu.render.figure import PanelData
    from configurable_spectrograms_tpu.render.tile import TimeWindow

    monkeypatch.setenv("CST_DATA_MESH", data_mesh)
    monkeypatch.setenv("CST_DEVICE_RESULT_CACHE", "0")
    monkeypatch.setattr(collapse_kernel, "applies", lambda shape: True)
    monkeypatch.setattr(collapse_kernel, "collapse_lanes",
                        functools.partial(collapse_kernel.collapse_lanes, interpret=True))
    dispatch._batched_quantize_fn.cache_clear()
    panels = []
    for k in range(3):
        T, A, E = 48 + 8 * k, 8, 16
        cube = rng.poisson(30.0, size=(T, A, E)).astype(np.float32)
        cube[rng.random(cube.shape) < 0.05] = np.nan
        panels.append(PanelData(
            cube=cube, pitch_mask=rng.random(A) < 0.7,
            energy=np.geomspace(4000, 5, E).astype(np.float32),
            times=np.arange(T, dtype=np.float64),
            window=TimeWindow(0, T, (0.0, float(T - 1)), (0.0, float(T - 1))),
            y_min=0.0, y_max=4000.0,
            z_min=None if k else 1.0, z_max=None if k else 4000.0,
            y_scale="linear", z_scale="log", colormap="viridis",
            x_is_unix=False, z_label="Counts",
        ))
    try:
        monkeypatch.setitem(link._BACKEND, "mode", "device")
        dev = dispatch.device_render_panels(panels, 24, 40)
        monkeypatch.setitem(link._BACKEND, "mode", "host")
        host = dispatch.device_render_panels(panels, 24, 40)
    finally:
        dispatch._batched_quantize_fn.cache_clear()
    expected_devices = jax.device_count() if data_mesh == "1" else 1
    assert dispatch.LAST_DISPATCH["devices"] == expected_devices
    for d, h in zip(dev, host):
        np.testing.assert_array_equal(d["rgba"], h["rgba"])
        for key in ("vmin", "vmax", "y0", "y1", "n_kept", "empty"):
            assert d[key] == h[key] or (np.isnan(d[key]) and np.isnan(h[key])), key

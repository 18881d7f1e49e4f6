"""The PRODUCTION render/extrema paths shard over the device mesh.

These pin the round-2 wiring: :func:`device_render_panels` (the light-
readback quantize program every figure render flows through) and
:func:`batched_file_stats` (the extrema pre-pass reduction) must actually
span all mesh devices AND produce bit-identical results to the unsharded
single-device programs (``CST_DATA_MESH=0``).
"""

import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from configurable_spectrograms_tpu.ops.extrema_ops import batched_file_stats  # noqa: E402
from configurable_spectrograms_tpu.render import device_cache, drain  # noqa: E402
from configurable_spectrograms_tpu.render import dispatch as figure  # noqa: E402
from configurable_spectrograms_tpu.render.figure import PanelData, device_render_panels  # noqa: E402
from configurable_spectrograms_tpu.render.tile import TimeWindow  # noqa: E402


@pytest.fixture(autouse=True)
def _no_result_cache(monkeypatch):
    """These tests assert on the dispatch/sharding machinery itself; the
    resident result cache would (correctly) serve the sharded-vs-unsharded
    re-renders without any dispatch, leaving LAST_DISPATCH stale."""
    monkeypatch.setenv("CST_DEVICE_RESULT_CACHE", "0")


def _require_devices(n):
    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} devices")


def _build_panels(rng, n_panels):
    panels = []
    for k in range(n_panels):
        T, A, E = 60 + 3 * k, 6, 12
        cube = (rng.random((T, A, E)) * (50 + 10 * k)).astype(np.float32)
        cube[rng.random(cube.shape) < 0.05] = np.nan
        energy = np.geomspace(4000, 10, E).astype(np.float32)
        panels.append(
            PanelData(
                cube=cube,
                pitch_mask=np.ones(A, bool),
                energy=energy,
                times=np.arange(T, dtype=np.float64),
                window=TimeWindow(0, T, (0.0, float(T - 1)), (0.0, float(T - 1))),
                y_min=0.0,
                y_max=4000.0,
                z_min=None,
                z_max=None,
                y_scale="log",
                z_scale="log",
                colormap="inferno",
                x_is_unix=False,
                z_label="Counts",
            )
        )
    return panels


def _render_results(panels, tile_h=32, tile_w=48):
    out = device_render_panels(panels, tile_h, tile_w)
    return [
        {k: (np.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in r.items()}
        for r in out
    ]


def test_production_render_spans_mesh_and_matches_unsharded(rng, monkeypatch):
    _require_devices(8)
    panels = _build_panels(rng, 10)  # pads to 16 lanes over 8 devices

    # Pin the device backend: under heavy machine load the auto
    # calibration can measure a slow readback mid-test and fail the
    # process over to the host path, silently skipping the dispatches
    # this test asserts on (LAST_DISPATCH would go stale).
    monkeypatch.setitem(figure._BACKEND, "mode", "device")
    monkeypatch.setitem(figure._BACKEND, "forced_host", False)

    monkeypatch.setenv("CST_DATA_MESH", "1")
    sharded = _render_results(panels)
    assert figure.LAST_DISPATCH["devices"] == 8
    assert figure.LAST_DISPATCH["lanes"] % 8 == 0

    monkeypatch.setenv("CST_DATA_MESH", "0")
    single = _render_results(panels)
    assert figure.LAST_DISPATCH["devices"] == 1

    for s, u in zip(sharded, single):
        np.testing.assert_array_equal(s["rgba"], u["rgba"])
        for key in ("vmin", "vmax", "y0", "y1", "n_kept", "empty"):
            assert s[key] == pytest.approx(u[key]), key


def test_batched_file_stats_sharded_matches_unsharded(rng, monkeypatch):
    _require_devices(8)
    cubes = []
    for k in range(5):  # deliberately not a multiple of 8 (pads to 8 lanes)
        c = (rng.random((30 + k, 4, 8)) * 100).astype(np.float32)
        c[rng.random(c.shape) < 0.1] = np.nan
        cubes.append(c)

    monkeypatch.setenv("CST_DATA_MESH", "1")
    sharded = batched_file_stats(cubes)
    monkeypatch.setenv("CST_DATA_MESH", "0")
    single = batched_file_stats(cubes)

    assert len(sharded) == len(single) == 5
    for s, u in zip(sharded, single):
        np.testing.assert_array_equal(s["counts"], u["counts"])
        np.testing.assert_array_equal(s["hist"], u["hist"])


def test_extrema_scan_identical_with_and_without_mesh(synth_archive, tmp_path, monkeypatch):
    """The chunked, mesh-sharded folder scan writes the same JSON as the
    sequential single-device scan (same monotone-merge and cursor values)."""
    _require_devices(8)
    from configurable_spectrograms_tpu.fast.extrema import compute_global_extrema

    results = {}
    for flag in ("1", "0"):
        monkeypatch.setenv("CST_DATA_MESH", flag)
        path = tmp_path / f"extrema_{flag}.json"
        out = compute_global_extrema(
            synth_archive["root"],
            "linear",
            "log",
            ("ees", "eeb", "ies", "ieb"),
            extrema_json_path=str(path),
            max_percentile=95.0,
        )
        results[flag] = (out, json.loads(path.read_text()))
    assert results["1"][0] == results["0"][0]
    assert results["1"][1] == results["0"][1]


def test_host_file_stats_matches_device(rng):
    """The numpy extrema fallback is bit-identical to the device reduction."""
    from configurable_spectrograms_tpu.ops.extrema_ops import host_file_stats

    cube = (rng.random((50, 6, 10)) * 1e4).astype(np.float32)
    cube[rng.random(cube.shape) < 0.15] = np.nan
    cube[3, 2, 4] = np.inf
    device = batched_file_stats([cube])[0]
    host = host_file_stats(cube)
    np.testing.assert_array_equal(device["counts"], host["counts"])
    np.testing.assert_array_equal(device["hist"], host["hist"])


def test_repeat_render_reuses_resident_cubes(rng, monkeypatch):
    """A second render of the same panels (the raw/given figure pair, or a
    repeat batch pass) must not re-upload any cube: every padded cube is
    served from the device-resident cache."""
    _require_devices(1)
    monkeypatch.setitem(figure._BACKEND, "mode", "device")
    monkeypatch.setitem(figure._BACKEND, "forced_host", False)
    figure._DEVICE_CUBE_CACHE.clear()

    panels = _build_panels(rng, 4)
    uploads = {"n": 0}
    orig = figure._padded_device_cube

    def counting(cube, Tp, Ap, Ep):
        before = len(figure._DEVICE_CUBE_CACHE)
        out = orig(cube, Tp, Ap, Ep)
        if len(figure._DEVICE_CUBE_CACHE) > before:
            uploads["n"] += 1
        return out

    monkeypatch.setattr(device_cache, "_padded_device_cube", counting)
    first = _render_results(panels)
    first_uploads = uploads["n"]
    assert first_uploads == 4  # one per unique cube
    second = _render_results(panels)
    assert uploads["n"] == first_uploads  # zero new uploads on repeat
    for a, b in zip(first, second):
        np.testing.assert_array_equal(a["rgba"], b["rgba"])


def test_hung_dispatch_falls_back_to_host(rng, monkeypatch):
    """A link that dies between the preflight and the render transfer must
    not deadlock the process: the bounded dispatch abandons the hung
    readback, flips to the host backend, and the figures still render."""
    import time

    _require_devices(1)
    monkeypatch.setitem(figure._BACKEND, "mode", "auto")
    monkeypatch.setitem(figure._BACKEND, "forced_host", False)
    monkeypatch.setenv("CST_DEVICE_DISPATCH_TIMEOUT", "1")

    def hung_readback(out_dev):
        time.sleep(600)

    monkeypatch.setattr(drain, "_readback", hung_readback)
    panels = _build_panels(rng, 3)
    t0 = time.monotonic()
    results = _render_results(panels)
    assert time.monotonic() - t0 < 60
    assert figure._BACKEND["forced_host"] is True
    assert len(results) == 3 and all(r["rgba"].shape[2] == 4 for r in results)


def test_forced_device_hung_dispatch_raises(rng, monkeypatch):
    """With CST_RENDER_BACKEND=device an abandoned transfer surfaces as an
    error instead of a silent backend switch."""
    import time

    _require_devices(1)
    monkeypatch.setitem(figure._BACKEND, "mode", "device")
    monkeypatch.setitem(figure._BACKEND, "forced_host", False)
    monkeypatch.setenv("CST_DEVICE_DISPATCH_TIMEOUT", "1")
    monkeypatch.setattr(drain, "_readback", lambda out_dev: time.sleep(600))
    import pytest

    with pytest.raises(RuntimeError, match="CST_DEVICE_DISPATCH_TIMEOUT"):
        _render_results(_build_panels(rng, 2))


def test_inverted_log_bounds_error_scoped_to_owning_figure(rng, monkeypatch):
    """Explicit log bounds whose safe-positive floor exceeds vmax surface
    the reference's LogNorm draw-time error -- but only for the OWNING
    figure: panels pooled into the same dispatch keep rendering (a raise
    inside the pooled call would fail every coalesced figure and record
    innocent orbits as plotting errors forever)."""
    import pytest

    for mode in ("device", "host"):
        monkeypatch.setitem(figure._BACKEND, "mode", mode)
        monkeypatch.setitem(figure._BACKEND, "forced_host", False)
        panels = _build_panels(rng, 3)
        panels[1].cube = np.full_like(panels[1].cube, 500.0)  # min positive 500
        panels[1].z_min = 1.0
        panels[1].z_max = 80.0  # < safe floor -> inverted
        results = _render_results(panels)
        assert results[1].get("error") and "minvalue" in results[1]["error"]
        for j in (0, 2):  # pooled neighbors unaffected
            assert "error" not in results[j] and results[j]["rgba"].shape[2] == 4

        # The owning figure's composite raises; a clean figure sharing the
        # same render pass does not.
        from configurable_spectrograms_tpu.render.plotting import (
            generic_plot_multirow_optional_zoom,
        )

        bad_cube = np.full((64, 6, 12), 500.0, np.float32)
        ds = [{"x": np.arange(64.0), "y": np.geomspace(4000, 10, 12),
               "data": bad_cube, "label": "bad", "vmin": 1.0, "vmax": 80.0}]
        fig, _ = generic_plot_multirow_optional_zoom(ds, z_scale="log", show=False)
        with pytest.raises(ValueError, match="minvalue"):
            fig.render(dpi=40)


def test_hung_extrema_dispatch_falls_back_to_host(rng, monkeypatch):
    """The extrema pre-pass has the same mid-batch link hazard as renders:
    a hung dispatch must fall back to the numpy stats, not deadlock."""
    import time

    from configurable_spectrograms_tpu.ops import extrema_ops

    _require_devices(1)
    monkeypatch.setitem(figure._BACKEND, "mode", "auto")
    monkeypatch.setitem(figure._BACKEND, "forced_host", False)
    monkeypatch.setitem(figure._BACKEND, "probed", True)
    monkeypatch.setenv("CST_DEVICE_DISPATCH_TIMEOUT", "1")

    def hung_fn(sharded, mesh=None):
        def run(batch, t_valids):
            time.sleep(600)

        return run

    monkeypatch.setattr(extrema_ops, "_batched_stats_fn", hung_fn)
    cube = (rng.random((40, 4, 8)) * 100).astype(np.float32)
    t0 = time.monotonic()
    stats = extrema_ops.batched_file_stats([cube])
    assert time.monotonic() - t0 < 60
    assert figure._BACKEND["forced_host"] is True
    # Results came from the host fallback and match it exactly.
    host = extrema_ops.host_file_stats(cube)
    np.testing.assert_array_equal(stats[0]["counts"], host["counts"])
    np.testing.assert_array_equal(stats[0]["hist"], host["hist"])


def _quantize_cost(rng, sharded: bool, explicit: bool = False) -> dict:
    """Per-device XLA cost of the production quantize program, 16 lanes."""
    from configurable_spectrograms_tpu.parallel.mesh import data_parallel_mesh
    from configurable_spectrograms_tpu.render.figure import _bucket, _prepare_group

    panels = _build_panels(rng, 16)
    if explicit:
        for p in panels:
            p.z_min, p.z_max = 1.0, 1e4
    Tp, Ap, Ep = _bucket(60, 256, 64), _bucket(6, 8, 8), _bucket(12, 8, 8)
    mesh = data_parallel_mesh() if sharded else None
    g, inputs = _prepare_group(
        panels, list(range(16)), Tp, Ap, Ep, "log", "log", 1.0, 99.0, explicit, 48, mesh
    )
    (u_idx, masks, t_valids, energies, e_valids, t_starts, t_counts, z_bounds,
     zb_e_valids, zb_full, t_maps, unique_cubes) = inputs
    cubes_np = np.full((len(unique_cubes), Tp, Ap, Ep), np.nan, np.float32)
    for s, c in enumerate(unique_cubes):
        T, A, E = c.shape
        cubes_np[s, :T, :A, :E] = c
    rows = figure._pack_lanes(u_idx, masks, t_valids, energies, e_valids,
                              t_starts, t_counts, z_bounds, zb_e_valids,
                              zb_full, t_maps)
    fn = figure._batched_quantize_fn(
        ("log", "log", 1.0, 99.0, explicit, g.gather_w, Ap, Ep, sharded)
    )
    ca = fn.lower(rows, cubes_np).compile().cost_analysis()
    return ca[0] if isinstance(ca, list) else ca


def test_sharded_quantize_partitions_compute_not_just_outputs(rng, monkeypatch):
    """GSPMD could satisfy the output-sharding + bit-identity tests while
    silently REPLICATING the heavy collapse/quantize on every device.  The
    compiled per-device cost must instead be ~1/N of the unsharded
    program's (VERDICT round-2 item 2)."""
    _require_devices(8)
    monkeypatch.setenv("CST_DATA_MESH", "1")
    for explicit in (False, True):
        sharded = _quantize_cost(rng, sharded=True, explicit=explicit)
        unsharded = _quantize_cost(rng, sharded=False, explicit=explicit)
        assert unsharded["flops"] > 0
        ratio = unsharded["flops"] / max(sharded["flops"], 1.0)
        assert ratio > 4.0, (
            f"per-device flops only {ratio:.1f}x below unsharded "
            f"(explicit={explicit}) -- the mesh partition is replicating compute"
        )


def test_sharded_extrema_partitions_compute(rng, monkeypatch):
    """Same replication check for the extrema pre-pass reduction."""
    _require_devices(8)
    from configurable_spectrograms_tpu.ops import extrema_ops

    monkeypatch.setenv("CST_DATA_MESH", "1")
    batch = (rng.random((16, 32, 4, 8)) * 100).astype(np.float32)
    t_valids = np.full((16,), 32, np.int32)
    import jax.numpy as jnp

    args = (jnp.asarray(batch), jnp.asarray(t_valids))
    costs = {}
    for sharded in (True, False):
        ca = extrema_ops._batched_stats_fn(sharded).lower(*args).compile().cost_analysis()
        costs[sharded] = ca[0] if isinstance(ca, list) else ca
    ratio = costs[False]["flops"] / max(costs[True]["flops"], 1.0)
    assert ratio > 4.0, f"extrema per-device flops only {ratio:.1f}x below unsharded"


def test_explicit_bounds_program_shards_and_matches(rng, monkeypatch):
    """The sort-free explicit-bounds program (the given-extrema half of
    production dispatches) must span the mesh and match the unsharded
    output bit-for-bit -- round 2 only covered the percentile program."""
    _require_devices(8)
    monkeypatch.setitem(figure._BACKEND, "mode", "device")
    monkeypatch.setitem(figure._BACKEND, "forced_host", False)

    panels = _build_panels(rng, 10)
    for p in panels:
        p.z_min, p.z_max = 0.5, 5e3  # explicit bounds -> sort-free program

    monkeypatch.setenv("CST_DATA_MESH", "1")
    sharded = _render_results(panels)
    assert figure.LAST_DISPATCH["devices"] == 8
    monkeypatch.setenv("CST_DATA_MESH", "0")
    single = _render_results(panels)
    assert figure.LAST_DISPATCH["devices"] == 1
    for s, u in zip(sharded, single):
        np.testing.assert_array_equal(s["rgba"], u["rgba"])
        assert s["vmin"] == pytest.approx(u["vmin"])
        assert s["vmax"] == pytest.approx(u["vmax"])


def test_mixed_bucket_group_shards_and_matches(rng, monkeypatch):
    """One device_render_panels call mixing (T,A,E) buckets AND percentile/
    explicit programs -- the multi-dispatch shape production hits when an
    orbit's grids coalesce -- must shard every bucket and match unsharded."""
    _require_devices(8)
    monkeypatch.setitem(figure._BACKEND, "mode", "device")
    monkeypatch.setitem(figure._BACKEND, "forced_host", False)

    def build_mixed():
        short = _build_panels(rng, 3)  # T=60ish -> 64-bucket
        long = _build_panels(rng, 3)
        for k, p in enumerate(long):
            T, A, E = 300 + 5 * k, 6, 12
            p.cube = (rng.random((T, A, E)) * 80).astype(np.float32)
            p.times = np.arange(T, dtype=np.float64)
            p.window = TimeWindow(0, T, (0.0, float(T - 1)), (0.0, float(T - 1)))
        explicit = _build_panels(rng, 2)
        for p in explicit:
            p.z_min, p.z_max = 0.5, 5e3
        return short + long + explicit

    panels = build_mixed()
    monkeypatch.setenv("CST_DATA_MESH", "1")
    figure.DISPATCH_HISTORY.clear()
    sharded = _render_results(panels)
    # EVERY bucket (two T-buckets x percentile + explicit programs = 3
    # dispatches) must span the mesh -- LAST_DISPATCH alone only shows
    # the final one, and a single silently-unsharded bucket would hide.
    assert len(figure.DISPATCH_HISTORY) == 3, figure.DISPATCH_HISTORY
    assert all(d["devices"] == 8 for d in figure.DISPATCH_HISTORY), figure.DISPATCH_HISTORY
    monkeypatch.setenv("CST_DATA_MESH", "0")
    figure.DISPATCH_HISTORY.clear()
    single = _render_results(panels)
    # Same bucket count expected: an empty history would make the
    # devices==1 check vacuously true.
    assert len(figure.DISPATCH_HISTORY) == 3, figure.DISPATCH_HISTORY
    assert all(d["devices"] == 1 for d in figure.DISPATCH_HISTORY), figure.DISPATCH_HISTORY
    for s, u in zip(sharded, single):
        np.testing.assert_array_equal(s["rgba"], u["rgba"])

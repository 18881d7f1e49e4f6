"""Tests for the FAST mission layer: grids, extrema, process_orbit, batch driver."""

import json
import os

import numpy as np
import pytest

from configurable_spectrograms_tpu.data.cdf_utils import load_filtered_orbits
from configurable_spectrograms_tpu.data.synthetic import synth_fast_archive
from configurable_spectrograms_tpu.fast import (
    FAST_plot_instrument_grid,
    FAST_plot_pitch_angle_grid,
    FAST_plot_spectrograms_directory,
    FAST_process_single_orbit,
    compute_global_extrema,
    extrema_overrides,
)
from configurable_spectrograms_tpu.fast.constants import DEFAULT_INSTRUMENT_ORDER


@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    root = tmp_path_factory.mktemp("fast_archive")
    csv = root / "cusp.tsv"
    mapping = synth_fast_archive(
        str(root / "data"), [500, 501], n_time=80, n_angle=16, n_energy=24, cusp_csv_path=str(csv)
    )
    return {"root": str(root), "data": str(root / "data"), "mapping": mapping, "csv": str(csv)}


def test_extrema_overrides():
    extrema = {"ees_linear_linear_y_max": 1234, "ees_linear_linear_z_min": 0.0123}
    assert extrema_overrides(extrema, "ees", "linear", "linear") == (None, 1300.0, 0.012, None)
    assert extrema_overrides(None, "ees", "linear", "linear") == (None, None, None, None)


def test_pitch_angle_grid_rows_and_title(archive):
    df = load_filtered_orbits(archive["csv"])
    fig, _ = FAST_plot_pitch_angle_grid(
        archive["mapping"][500]["ees"],
        filtered_orbits_df=df,
        orbit_number=500,
        show=False,
        scale_function_y="log",
        scale_function_z="log",
        colormap="inferno",
    )
    assert fig is not None
    assert fig.suptitle_text == "Orbit 500 - Pitch Angle ees ESA Spectrograms"
    assert fig.nrows == 4  # all/downgoing/upgoing/perpendicular
    assert fig.ncols == 2  # cusp marks exist and data is non-NaN -> zoom column
    col0 = [ax for ax in fig.axes if ax.col == 0]
    assert [ax.ylabel for ax in col0][0].startswith("All")
    # Every panel carries the cusp markers.
    assert all(len(ax.panel.vertical_lines) == 2 for ax in fig.axes if ax.panel)


def test_instrument_grid_rows_and_extrema(archive):
    extrema = {
        "ees_linear_linear_y_max": 2000,
        "ees_linear_linear_z_max": 500.0,
        "ees_linear_linear_y_min": 0,
        "ees_linear_linear_z_min": 0,
    }
    fig, _ = FAST_plot_instrument_grid(
        archive["mapping"][500],
        orbit_number=500,
        show=False,
        global_extrema=extrema,
    )
    assert fig is not None
    assert fig.suptitle_text == "Orbit 500 -  ESA Spectrograms"
    labels = [ax.ylabel for ax in fig.axes if ax.col == 0]
    assert labels == ["EES", "EEB", "IES", "IEB"]
    ees_panel = fig.axes[0].panel
    # ees got explicit z bounds from extrema; others percentile (None).
    assert ees_panel.z_min == 0.0 and ees_panel.z_max == 500.0
    assert ees_panel.bounds_energy_range == (0.0, 2000.0)


def test_instrument_grid_missing_and_broken_files(archive, tmp_path):
    paths = dict(archive["mapping"][500])
    del paths["eeb"]
    bad = tmp_path / "fa_esa_l2_ies_20000101_500_v02.cdf"
    bad.write_bytes(b"garbage not cdf")
    paths["ies"] = str(bad)
    fig, _ = FAST_plot_instrument_grid(paths, orbit_number=500, show=False)
    labels = [ax.ylabel for ax in fig.axes if ax.col == 0]
    assert labels == ["EES", "IEB"]  # missing + broken skipped
    assert FAST_plot_instrument_grid({}, orbit_number=1, show=False) == (None, None)


def test_compute_global_extrema_cache_and_reuse(archive, tmp_path):
    cache = str(tmp_path / "extrema.json")
    out = compute_global_extrema(archive["data"], "linear", "linear", DEFAULT_INSTRUMENT_ORDER,
                                 extrema_json_path=cache, flush_batch_size=1)
    assert out["linear_linear_last_orbit"] == 501
    for inst in DEFAULT_INSTRUMENT_ORDER:
        assert out[f"{inst}_linear_linear_y_min"] == 0
        assert 0 < out[f"{inst}_linear_linear_y_max"] <= 4000
        assert out[f"{inst}_linear_linear_z_max"] > 0
        assert out[f"{inst}_linear_linear_extrema_progress"]["complete"]
    # log/log reuses linear_linear without rescanning: y_max = log10(linear y_max)
    out2 = compute_global_extrema(archive["data"], "log", "log", DEFAULT_INSTRUMENT_ORDER,
                                  extrema_json_path=cache, flush_batch_size=1)
    for inst in DEFAULT_INSTRUMENT_ORDER:
        lin = out2[f"{inst}_linear_linear_y_max"]
        assert out2[f"{inst}_log_log_y_max"] == pytest.approx(np.log10(lin))
        assert out2[f"{inst}_log_log_y_min"] == -1.0
    # idempotent rerun (complete progress short-circuits)
    out3 = compute_global_extrema(archive["data"], "linear", "linear", DEFAULT_INSTRUMENT_ORDER,
                                  extrema_json_path=cache, flush_batch_size=1)
    assert out3[f"ees_linear_linear_y_max"] == out[f"ees_linear_linear_y_max"]
    # cursor key ordered first on disk
    on_disk = json.load(open(cache))
    assert list(on_disk)[0].endswith("_last_orbit")


def test_extrema_z_within_tolerance_of_exact(archive, tmp_path):
    """Histogram z_max must be within 1.4% (pre-ceil) of the exact pooled percentile."""
    from configurable_spectrograms_tpu.data.cdf_utils import load_fast_cdf_dataset

    pooled = []
    for inst_files in archive["mapping"].values():
        ds = load_fast_cdf_dataset(inst_files["ees"])
        coll = np.nansum(ds["data"], axis=1)
        pooled.append(coll[np.isfinite(coll) & (coll > 0)])
    exact = float(np.nanpercentile(np.concatenate(pooled), 95.0))
    cache = str(tmp_path / "ex2.json")
    out = compute_global_extrema(archive["data"], "linear", "linear", ("ees",),
                                 extrema_json_path=cache)
    got = out["ees_linear_linear_z_max"]
    assert got == pytest.approx(np.ceil(exact), rel=0.03), (got, exact)


def test_process_single_orbit_outputs(archive, tmp_path):
    df = load_filtered_orbits(archive["csv"])
    out_base = str(tmp_path / "plots")
    result = FAST_process_single_orbit(
        500,
        archive["mapping"][500],
        df,
        zoom_duration_minutes=6.0,
        y_axis_scale="linear",
        z_axis_scale="log",
        instrument_order=DEFAULT_INSTRUMENT_ORDER,
        colormap="cividis",
        output_base_directory=out_base,
        orbit_timeout_seconds=600,
        instrument_timeout_seconds=300,
    )
    assert result["status"] == "ok", result
    files = []
    for root, _dirs, fs in os.walk(out_base):
        files += fs
    # 4 instruments x 2 variants pitch grids + 2 instrument grids
    assert len(files) == 10
    assert any(f.startswith("500_cusp_pitch-angle_ESA_ees_y-linear_z-log_given_extrema-cividis") for f in files)
    assert any(f == "500_instrument-grid_ESA_y-linear_z-log_raw-cividis.png" for f in files)
    # Year/month layout from the CDF path
    from configurable_spectrograms_tpu.data.orbit_discovery import parse_year_month

    year, month = parse_year_month(archive["mapping"][500]["ees"])
    assert os.path.isdir(os.path.join(out_base, year, month, "500"))


def test_process_single_orbit_skip_existing(archive, tmp_path):
    out_base = str(tmp_path / "plots2")
    common = dict(
        filtered_orbits_dataframe=None,
        zoom_duration_minutes=6.0,
        y_axis_scale="linear",
        z_axis_scale="linear",
        instrument_order=("ees",),
        colormap="viridis",
        output_base_directory=out_base,
        orbit_timeout_seconds=600,
        instrument_timeout_seconds=300,
    )
    paths = {"ees": archive["mapping"][500]["ees"]}
    first = FAST_process_single_orbit(500, paths, **common)
    assert first["status"] == "ok", first
    mtimes = {}
    for root, _d, fs in os.walk(out_base):
        for f in fs:
            p = os.path.join(root, f)
            mtimes[p] = os.path.getmtime(p)
    assert mtimes, "first run produced no files; the skip loop would be vacuous"
    second = FAST_process_single_orbit(500, paths, override_plots=False, **common)
    assert second["status"] == "ok", second
    for p, m in mtimes.items():
        assert os.path.getmtime(p) == m  # untouched


def test_process_single_orbit_timeout(archive, tmp_path):
    result = FAST_process_single_orbit(
        500,
        archive["mapping"][500],
        None,
        zoom_duration_minutes=6.0,
        y_axis_scale="linear",
        z_axis_scale="linear",
        instrument_order=DEFAULT_INSTRUMENT_ORDER,
        colormap="viridis",
        output_base_directory=str(tmp_path / "plots3"),
        orbit_timeout_seconds=600,
        instrument_timeout_seconds=0.0,  # trips immediately after first instrument
    )
    assert result["status"] == "timeout"
    assert result["timeout_type"] == "instrument"


def test_batch_directory_run_and_resume(archive, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # default cusp CSV path is cwd-relative
    progress = str(tmp_path / "progress.json")
    out = str(tmp_path / "out")
    kwargs = dict(
        directory_path=archive["data"],
        output_base=out,
        y_scale="linear",
        z_scale="linear",
        progress_json_path=progress,
        colormap="viridis",
        # One worker keeps completion order deterministic: the progress
        # cursor records the most recently completed orbit (as in the
        # reference), so out-of-order completion would set it to 500.
        max_workers=1,
        orbit_timeout_seconds=600,
        instrument_timeout_seconds=300,
        flush_batch_size=1,
        retry_timeouts=False,
    )
    results = FAST_plot_spectrograms_directory(**kwargs)
    assert sorted(r["orbit"] for r in results) == [500, 501]
    assert all(r["status"] == "ok" for r in results)
    pdisk = json.load(open(progress))
    assert pdisk["linear_linear_last_orbit"] == 501
    # Resume: everything done -> no new work
    results2 = FAST_plot_spectrograms_directory(**kwargs)
    assert results2 == []


def test_batch_directory_error_taxonomy(archive, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    # Corrupt one orbit's ees file inside a copied archive.
    import shutil

    data2 = str(tmp_path / "data2")
    shutil.copytree(archive["data"], data2)
    bad_path = None
    for root, _d, fs in os.walk(data2):
        for f in fs:
            if "_ees_" in f and "_500_" in f:
                bad_path = os.path.join(root, f)
    raw = open(bad_path, "rb").read()
    open(bad_path, "wb").write(raw[:100])
    progress = str(tmp_path / "p2.json")
    results = FAST_plot_spectrograms_directory(
        directory_path=data2,
        output_base=str(tmp_path / "out2"),
        y_scale="linear",
        z_scale="linear",
        progress_json_path=progress,
        max_workers=1,
        orbit_timeout_seconds=600,
        instrument_timeout_seconds=300,
        flush_batch_size=1,
        retry_timeouts=False,
    )
    by_orbit = {r["orbit"]: r for r in results}
    # Broken ees file: instrument grid skips it (logged), pitch grid errors.
    assert by_orbit[500]["status"] == "error"
    pdisk = json.load(open(progress))
    assert 500 in pdisk["linear_linear_error_plotting"]
    assert any(k.startswith("ees_linear_linear_error-") for k in pdisk)


def test_compute_global_extrema_with_mins(archive, tmp_path):
    """compute_mins=True stores the 1st-percentile positive value as z_min."""
    cache = str(tmp_path / "mins.json")
    out = compute_global_extrema(archive["data"], "linear", "linear", ("ees",),
                                 extrema_json_path=cache, compute_mins=True)
    assert out["ees_linear_linear_z_min"] > 0
    assert out["ees_linear_linear_z_min"] < out["ees_linear_linear_z_max"]
    assert out["ees_linear_linear_y_min"] == 0  # energy min stays 0 regardless


def test_get_cdf_var_shapes(archive):
    from configurable_spectrograms_tpu.data.cdf_utils import get_cdf_var_shapes

    shapes = get_cdf_var_shapes(archive["data"], ["data", "energy"])
    assert len(shapes["data"]) == 8  # 2 orbits x 4 instruments
    assert all(s == (80, 16, 24) for s in shapes["data"])
    assert all(s == (80, 16, 24) for s in shapes["energy"])


def test_esv_instrument_opt_in(tmp_path):
    """``esv`` files (noted but never recognized by the reference,
    download.py:22) are discovered and rendered when the caller includes
    the tag in ``instrument_order``; the default order still excludes them."""
    from configurable_spectrograms_tpu.data.orbit_discovery import discover_orbit_files

    order = ("ees", "eeb", "ies", "ieb", "esv")
    mapping = synth_fast_archive(
        str(tmp_path / "data"), [600], instruments=order, n_time=60, n_angle=8, n_energy=16
    )
    assert "esv" in mapping[600]

    by_default = discover_orbit_files(str(tmp_path / "data"))
    assert "esv" not in by_default[600]
    with_esv = discover_orbit_files(str(tmp_path / "data"), instrument_order=order)
    assert set(with_esv[600]) == set(order)

    fig, _ = FAST_plot_instrument_grid(
        with_esv[600], orbit_number=600, show=False, instrument_order=order
    )
    assert fig is not None
    assert fig.nrows == 5


def test_paced_gc_limits_full_collections(monkeypatch):
    """Per-orbit gc is a young-gen pass; full passes respect the interval.

    The reference collects fully after every orbit (reference
    fast/process_orbit.py:298) inside short-lived worker processes; this
    engine paces the expensive gen-2 pass (~200 ms in-process) to one per
    ``CST_GC_FULL_INTERVAL_S`` and runs ``gc.collect(1)`` otherwise.
    ``CST_GC_FULL_INTERVAL_S=0`` restores the reference cadence.
    """
    import gc as gc_mod

    from configurable_spectrograms_tpu.fast import process_orbit as po

    calls = []
    monkeypatch.setattr(gc_mod, "collect", lambda *a: calls.append(a))

    fake_now = [1000.0]
    monkeypatch.setattr(po.time, "monotonic", lambda: fake_now[0])

    monkeypatch.setattr(po, "_GC_FULL_INTERVAL_S", 20.0)
    monkeypatch.setattr(po, "_GC_LAST_FULL", [0.0])
    po._paced_gc()          # stale last_full: full pass
    po._paced_gc()          # within the interval: young-gen only
    fake_now[0] += 25.0
    po._paced_gc()          # interval elapsed: full pass again
    assert calls == [(), (1,), ()]

    calls.clear()
    monkeypatch.setattr(po, "_GC_FULL_INTERVAL_S", 0.0)
    po._paced_gc()
    po._paced_gc()
    assert calls == [(), ()]  # reference cadence: every call is full


def test_gc_interval_env_malformed_falls_back():
    """A malformed CST_GC_FULL_INTERVAL_S must not crash the import
    (every sibling env parser falls back to its default)."""
    import subprocess
    import sys

    out = subprocess.run(
        [sys.executable, "-c",
         "from configurable_spectrograms_tpu.fast import process_orbit as m; "
         "print(m._GC_FULL_INTERVAL_S)"],
        env={**os.environ, "CST_GC_FULL_INTERVAL_S": "20s", "JAX_PLATFORMS": "cpu"},
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert float(out.stdout.strip()) == 20.0


def test_driver_sweeps_stale_tmp_files(tmp_path):
    """Stranded *.tmp-* siblings from a SIGKILLed save are removed at
    driver entry (atomic saves never publish them as .png, but the
    unique pid/thread names mean no later process overwrites them)."""
    import subprocess
    import sys

    from configurable_spectrograms_tpu.fast.batch_directory import _sweep_stale_tmp

    # The pid of a process that has exited: a hard-coded pid may be alive
    # on the test host, and a live owner's tmp is kept by design.
    child = subprocess.Popen([sys.executable, "-c", "pass"])
    child.wait()
    out = tmp_path / "plots" / "2001" / "01" / "3000"
    out.mkdir(parents=True)
    stale = out / f"3000_x.png.tmp-{child.pid}-456"
    stale.write_bytes(b"partial")
    keep = out / "3000_x.png"
    keep.write_bytes(b"\x89PNG done")
    _sweep_stale_tmp(str(tmp_path / "plots"))
    assert not stale.exists()
    assert keep.exists()
    _sweep_stale_tmp(str(tmp_path / "missing"))  # no-op, no raise


def test_sweep_keeps_live_concurrent_tmp(tmp_path):
    """A tmp whose embedded pid is ALIVE and recent survives the sweep: it
    belongs to a concurrently running driver sharing the output tree, and
    unlinking it would make the victim's os.replace fail (ADVICE r4)."""
    import os as _os

    from configurable_spectrograms_tpu.fast import batch_directory as bd

    out = tmp_path / "plots" / "2001" / "01" / "3000"
    out.mkdir(parents=True)
    live = out / f"3000_x.png.tmp-{_os.getpid()}-789"
    live.write_bytes(b"in flight")
    bd._sweep_stale_tmp(str(tmp_path / "plots"))
    assert live.exists(), "live concurrent writer's tmp must survive"
    # ... but an ANCIENT tmp with a live pid is still swept (no healthy
    # save holds a tmp for an hour; the pid may have been recycled).
    old = _os.stat(live).st_mtime - bd._STALE_TMP_AGE_SEC - 10
    _os.utime(live, (old, old))
    bd._sweep_stale_tmp(str(tmp_path / "plots"))
    assert not live.exists()
    # Unparseable suffixes fall back to the age rule alone.
    odd = out / "3000_y.png.tmp-notapid"
    odd.write_bytes(b"foreign")
    bd._sweep_stale_tmp(str(tmp_path / "plots"))
    assert not odd.exists()

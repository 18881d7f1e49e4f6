"""The device backend is the default, and on it nothing moves work to the host."""

import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_default_backend_is_device():
    env = {k: v for k, v in os.environ.items() if k != "CST_RENDER_BACKEND"}
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run(
        [sys.executable, "-c",
         "from configurable_spectrograms_tpu.render import link; print(link._BACKEND['mode'])"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "device"


def _panels(rng, n=3):
    from configurable_spectrograms_tpu.render.figure import PanelData
    from configurable_spectrograms_tpu.render.tile import TimeWindow

    out = []
    for _ in range(n):
        T, A, E = 40, 8, 16
        out.append(PanelData(
            cube=(rng.random((T, A, E)) * 100).astype(np.float32),
            pitch_mask=np.ones(A, bool),
            energy=np.geomspace(4000, 5, E).astype(np.float32),
            times=np.arange(T, dtype=np.float64),
            window=TimeWindow(0, T, (0.0, float(T - 1)), (0.0, float(T - 1))),
            y_min=0.0, y_max=4000.0, z_min=None, z_max=None,
            y_scale="linear", z_scale="log", colormap="viridis",
            x_is_unix=False, z_label="Counts",
        ))
    return out


def test_device_backend_never_probes_or_routes_to_the_host(rng, monkeypatch):
    """With link measurements that would send a lone figure to the host in
    ``auto`` mode, the ``device`` backend still dispatches on the device
    and never runs the link probe."""
    from configurable_spectrograms_tpu.render import dispatch, link

    monkeypatch.setitem(link._BACKEND, "mode", "device")
    monkeypatch.setitem(link._BACKEND, "forced_host", False)
    monkeypatch.setitem(link._BACKEND, "probed", False)
    monkeypatch.setitem(link._BACKEND, "link_steady_dt", 60.0)  # a very slow link
    monkeypatch.setitem(link._BACKEND, "link_mbps", 0.01)
    monkeypatch.setenv("CST_DEVICE_RESULT_CACHE", "0")
    monkeypatch.setattr(link, "_link_roundtrip_probe", lambda: pytest.fail("probed the link"))

    def _no_host(*a, **k):
        raise AssertionError("rendered on the host backend")

    monkeypatch.setattr(dispatch._panel_mod, "_render_group_host", _no_host)
    before = dispatch.upload_telemetry()["dispatches"]
    pending = dispatch.enqueue_render_panels(_panels(rng), 24, 48, prefer_latency=True)
    results = pending.wait()
    assert dispatch.upload_telemetry()["dispatches"] > before
    assert all(r["rgba"].shape == (24, 48, 4) for r in results)
    assert link.recommended_workers(4) == 4


def test_device_backend_dispatch_timeout_raises(rng, monkeypatch):
    """A hung dispatch under ``device`` raises instead of finishing on the host."""
    import time

    from configurable_spectrograms_tpu.render import dispatch, link

    monkeypatch.setitem(link._BACKEND, "mode", "device")
    monkeypatch.setenv("CST_DEVICE_DISPATCH_TIMEOUT", "1")
    monkeypatch.setenv("CST_DEVICE_RESULT_CACHE", "0")
    monkeypatch.setattr(dispatch, "_stack_cubes", lambda *a, **k: time.sleep(600))
    with pytest.raises(RuntimeError, match="CST_RENDER_BACKEND=device"):
        dispatch.device_render_panels(_panels(rng, 1), 24, 48)


@pytest.mark.chip
def test_device_render_matches_host_on_the_card(rng):
    """On a GPU, the device program meets chip_smoke's parity contract."""
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from configurable_spectrograms_tpu.ops._colormap_data import colormap_lut

    panels = _panels(rng, 6)
    dev, host = cs.render_both(panels, 24, 48)
    lut = colormap_lut("viridis")
    for d, h in zip(dev, host):
        r = cs.compare_panel(d, h, lut)
        assert r["ok"], r


def _fresh_python(code: str) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)


def test_gui_parent_never_initializes_a_jax_backend():
    """The GUI runs batches in child processes; its own process must not
    hold the card, so importing what it imports creates no JAX backend."""
    out = _fresh_python(
        "import sys; sys.argv = ['gui'];"
        "import GUI_batch_download_plot_FAST;"
        "from configurable_spectrograms_tpu.fast.constants import FAST_PLOTTING_PROGRESS_JSON;"
        "import jax._src.xla_bridge as xb; print('BACKENDS', len(xb._backends))"
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert "BACKENDS 0" in out.stdout


def test_bench_baseline_workers_stay_on_the_cpu():
    """bench.py's matplotlib worker processes pin JAX to the CPU before
    anything can initialize it, so they never open the card."""
    pytest.importorskip("matplotlib")
    out = _fresh_python(
        "import bench; bench._mpl_worker_init();"
        "import jax; print('PLATFORM', jax.devices()[0].platform)"
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert "PLATFORM cpu" in out.stdout

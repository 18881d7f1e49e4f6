"""The driver entry points must compile and run on the virtual mesh."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")


def test_entry_forward_jits():
    import __graft_entry__ as g

    fn, args = g.entry()
    rgba, vmin, vmax = jax.jit(fn)(*args)
    assert rgba.shape == (128, 256, 4) and rgba.dtype == np.uint8
    assert float(vmax) > float(vmin)


def test_dryrun_multichip_eight():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    import __graft_entry__ as g

    g.dryrun_multichip(8)


def test_ensure_devices_provisions_virtual_cpus(tmp_path):
    """dryrun_multichip must self-provision virtual CPU devices when the
    active backend is short (the driver may call it in a process whose
    backend already initialized with one real chip).  Run in a fresh
    subprocess with only this repo on PYTHONPATH so the check is CPU-only
    and starts from a 1-device backend."""
    import os
    import pathlib
    import subprocess
    import sys

    repo = str(pathlib.Path(__file__).resolve().parents[1])
    env = dict(os.environ, PYTHONPATH=repo, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    code = (
        "import jax; assert jax.device_count() == 1, jax.devices();"
        "import __graft_entry__ as g; g.dryrun_multichip(4);"
        "assert jax.device_count() == 4, jax.devices(); print('ENSURE_OK')"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=repo, env=env,
        capture_output=True, text=True, timeout=600,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert "ENSURE_OK" in out.stdout


@pytest.mark.parametrize("n_gpus", [1, 3])
def test_ensure_devices_raises_on_short_gpu_platform(monkeypatch, n_gpus):
    """On an accelerator with too few devices the dry run raises; it never
    moves itself to virtual CPU devices behind the caller's back."""
    import jax.extend.backend

    import __graft_entry__ as g

    cleared = []
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(jax, "device_count", lambda: n_gpus)
    monkeypatch.setattr(jax.extend.backend, "clear_backends", lambda: cleared.append(1))
    with pytest.raises(RuntimeError, match="gpu platform has"):
        g._ensure_devices(4)
    assert not cleared


def test_ensure_devices_accepts_enough_gpus(monkeypatch):
    import jax.extend.backend

    import __graft_entry__ as g

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(jax, "device_count", lambda: 4)
    monkeypatch.setattr(jax.extend.backend, "clear_backends", lambda: pytest.fail("cleared"))
    g._ensure_devices(4)

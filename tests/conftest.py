"""Test configuration: an 8-device virtual CPU mesh, and the ``chip`` marker.

Multi-device sharding paths are validated on a virtual CPU mesh
(``xla_force_host_platform_device_count=8``), the strategy the reference's
SURVEY.md section 4 prescribes for this rebuild.  Tests marked ``chip``
need an NVIDIA GPU: they skip on the CPU, and run on the card with
``python -m pytest tests -m chip`` (which leaves JAX's platform alone).
"""

import os

import numpy as np
import pytest


def pytest_configure(config):
    """Pin JAX to the virtual CPU mesh unless only card tests were selected.

    Runs before any test imports JAX's backends, so the platform and the
    virtual device count still take effect.
    """
    if (config.option.markexpr or "").strip() == "chip":
        return
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
    import jax

    jax.config.update("jax_platforms", "cpu")


@pytest.fixture(autouse=True)
def _chip_only(request):
    """Skip ``chip``-marked tests unless JAX's first device is a GPU.

    Decided per test, at run time: deciding at import or collection would
    let xdist workers collect different test sets.
    """
    if request.node.get_closest_marker("chip") is None:
        return
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (run with -m chip on the card)")


@pytest.fixture(autouse=True)
def _reset_link_rate_meter():
    """The slow-dispatch detector, host-rate meter, and backend-selection
    state are process-global (render/link.py); leaked probation/streak or
    forced-host state from one test must not route another test's renders
    (a leaked ``forced_host=True`` makes ``data_parallel_mesh()`` return
    None and the sharding tests crash building a NamedSharding)."""
    from configurable_spectrograms_tpu.render import link

    with link._BACKEND_LOCK:
        backend_before = dict(link._BACKEND)
    yield
    with link._BACKEND_LOCK:
        link._BACKEND.clear()
        link._BACKEND.update(backend_before)
    link.reset_rate_state()
    with link._RATE_LOCK:
        link._RATE["host_panels"] = 0.0
        link._RATE["host_sec"] = 0.0


@pytest.fixture
def rng():
    """Function-scoped so every test draws the SAME deterministic stream
    regardless of which other tests ran first -- a session-scoped
    generator made test inputs depend on selection/ordering, so failures
    could vanish when a test was run in isolation."""
    return np.random.default_rng(1234)


@pytest.fixture(scope="session")
def synth_archive(tmp_path_factory):
    """A small synthetic FAST archive shared across tests (3 orbits x 4 inst)."""
    from configurable_spectrograms_tpu.data.synthetic import synth_fast_archive

    root = tmp_path_factory.mktemp("fast_data")
    csv = root / "cusp.tsv"
    orbits = [100, 101, 102]
    mapping = synth_fast_archive(str(root), orbits, n_time=96, n_angle=16, n_energy=24, cusp_csv_path=str(csv))
    return {"root": str(root), "orbits": orbits, "mapping": mapping, "cusp_csv": str(csv)}

"""Subprocess worker for the real two-process multi-host test.

Each process owns 4 virtual CPU devices; together they form an 8-device
"cluster" (Gloo collectives), the CPU stand-in for a multi-host
accelerator run prescribed by SURVEY.md section 4.  Run by tests/test_multihost.py as::

    python multihost_worker.py <process_id> <num_processes> <port>
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "").replace("--xla_force_host_platform_device_count=8", "")
    + " --xla_force_host_platform_device_count=4"
).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402


def main() -> int:
    pid, nprocs, port = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
    from configurable_spectrograms_tpu.parallel.mesh import global_file_batch, init_distributed

    init_distributed(
        coordinator_address=f"127.0.0.1:{port}", num_processes=nprocs, process_id=pid
    )
    assert jax.process_count() == nprocs
    assert len(jax.local_devices()) == 4
    assert len(jax.devices()) == 4 * nprocs

    from jax.sharding import Mesh

    from configurable_spectrograms_tpu.parallel.extrema import sharded_extrema_stats

    # Deterministic archive known to every process; each host holds a slice.
    rng = np.random.default_rng(99)
    n_files, T, A, E = 8 * nprocs, 32, 8, 16
    cubes = (rng.random((n_files, T, A, E)) * 1e4).astype(np.float32)
    cubes[rng.random(cubes.shape) < 0.1] = np.nan
    t_valids = np.asarray([T - (i % 3) for i in range(n_files)], np.int32)
    for i, tv in enumerate(t_valids):
        cubes[i, tv:] = np.nan

    per = n_files // nprocs
    local_cubes = cubes[pid * per : (pid + 1) * per]
    local_tv = t_valids[pid * per : (pid + 1) * per]

    global_mesh = Mesh(np.asarray(jax.devices()), ("data",))
    g_cubes, g_tv = global_file_batch(local_cubes, local_tv, global_mesh)
    counts, hist = sharded_extrema_stats(g_cubes, g_tv, global_mesh)

    # Expected: the same reduction on this process's local 4-device mesh
    # over the full archive (single-host semantics).
    local_mesh = Mesh(np.asarray(jax.local_devices()), ("data",))
    exp_counts, exp_hist = sharded_extrema_stats(cubes, t_valids, local_mesh)

    np.testing.assert_array_equal(counts, exp_counts)
    np.testing.assert_array_equal(hist, exp_hist)

    # The production RENDER path under jax.distributed: each host shards
    # its panel batches over its LOCAL devices (data_parallel_mesh must
    # not span remote hosts, or device_put of host-local numpy would hit
    # unaddressable devices).  Output must be bit-identical to the host
    # backend's numpy render.
    from configurable_spectrograms_tpu.parallel.mesh import data_parallel_mesh
    from configurable_spectrograms_tpu.render import figure, link
    from configurable_spectrograms_tpu.render.figure import PanelData, device_render_panels
    from configurable_spectrograms_tpu.render.tile import TimeWindow

    mesh = data_parallel_mesh()
    assert mesh is not None and int(mesh.devices.size) == len(jax.local_devices())

    prng = np.random.default_rng(7)
    panels = []
    for k in range(6):
        Tp, Ap, Ep = 40 + k, 6, 12
        cube = (prng.random((Tp, Ap, Ep)) * 100).astype(np.float32)
        panels.append(PanelData(
            cube=cube, pitch_mask=np.ones(Ap, bool),
            energy=np.geomspace(4000, 10, Ep).astype(np.float32),
            times=np.arange(Tp, dtype=np.float64),
            window=TimeWindow(0, Tp, (0.0, float(Tp - 1)), (0.0, float(Tp - 1))),
            y_min=0.0, y_max=4000.0, z_min=None, z_max=None,
            y_scale="log", z_scale="log", colormap="inferno",
            x_is_unix=False, z_label="Counts",
        ))
    link._BACKEND["mode"] = "device"
    link._BACKEND["forced_host"] = False
    dev = device_render_panels(panels, 24, 32)
    assert figure.LAST_DISPATCH["devices"] == len(jax.local_devices()), figure.LAST_DISPATCH
    link._BACKEND["mode"] = "host"
    host = device_render_panels(panels, 24, 32)
    for d, h in zip(dev, host):
        np.testing.assert_array_equal(d["rgba"], h["rgba"])

    print(f"MULTIHOST_OK pid={pid} files={counts.shape[0]} hist_total={int(hist.sum())}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

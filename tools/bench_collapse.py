#!/usr/bin/env python
"""Time the render collapse on the GPU: the Triton kernel against XLA's.

Two measurements, each in the order XLA, kernel, kernel, XLA:

* the collapse alone -- ``ops.collapse_kernel.collapse_lanes`` against
  ``vmap(collapse_cube)`` over the gathered stack -- for 128 lanes of a
  16-cube stack at the padded bucket (1024, 64, 96) of T = 903 records,
  each lane masked to one of the four FAST pitch-angle categories;
* ``device_render_panels`` on the pitch-angle panels of a synthetic
  archive at that bucket, with the kernel on and off (cubes resident,
  result cache off), so the whole collapse+quantize program is timed.

Times are medians of warm calls ended by ``block_until_ready`` (or by the
readback ``device_render_panels`` waits on).  Prints one JSON line per
measurement with the device it ran on.

    python tools/bench_collapse.py
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import tempfile
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)


def _median_ms(fn, reps: int) -> float:
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e3


def _category_masks(n_angle: int) -> list:
    import numpy as np

    from configurable_spectrograms_tpu.fast.constants import DEFAULT_PITCH_ANGLE_CATEGORIES

    pitch = np.linspace(0.0, 360.0, n_angle, endpoint=False)
    masks = []
    for ranges in DEFAULT_PITCH_ANGLE_CATEGORIES.values():
        m = np.zeros(n_angle, bool)
        for lo, hi in ranges:
            m |= (pitch >= lo) & (pitch <= hi)
        masks.append(m)
    return masks


def bench_kernel(device: dict) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from configurable_spectrograms_tpu.ops import collapse_kernel
    from configurable_spectrograms_tpu.ops.spectrogram import collapse_cube

    U, Tp, Ap, Ep, lanes = 16, 1024, 64, 96, 128
    rng = np.random.default_rng(0)
    cubes = rng.poisson(20.0, size=(U, Tp, Ap, Ep)).astype(np.float32)
    u = np.repeat(np.arange(U, dtype=np.int32), lanes // U)
    masks = _category_masks(Ap)
    pm = np.stack([masks[j % len(masks)] for j in range(lanes)])
    tv = np.full(lanes, 903, np.int32)
    args = [jax.device_put(a) for a in (cubes, u, pm, tv)]
    xla = jax.jit(lambda c, u, pm, tv: jax.vmap(collapse_cube)(c[u], pm, tv))
    kern = jax.jit(collapse_kernel.collapse_lanes)
    same = bool(jnp.array_equal(xla(*args), kern(*args), equal_nan=True))
    out = {"xla_ms": [], "kernel_ms": []}
    for name in ("xla", "kernel", "kernel", "xla"):
        fn = xla if name == "xla" else kern
        out[f"{name}_ms"].append(_median_ms(lambda: fn(*args).block_until_ready(), 20))
    kept = float(pm.mean())
    print(json.dumps({"bench": "collapse", **device, "shape": [U, Tp, Ap, Ep], "lanes": lanes,
                      "kept_pitch_share": kept, "equal": same,
                      "bytes_all_bins": lanes * Tp * Ap * Ep * 4,
                      "bytes_kept_bins": int(lanes * Tp * Ap * Ep * 4 * kept), **out}), flush=True)


def bench_render(device: dict) -> None:
    import chip_smoke as cs
    from configurable_spectrograms_tpu.constants import FAST_SAVE_DPI
    from configurable_spectrograms_tpu.fast.plotting import FAST_plot_pitch_angle_grid
    from configurable_spectrograms_tpu.ops import collapse_kernel
    from configurable_spectrograms_tpu.render import dispatch

    os.environ["CST_DEVICE_RESULT_CACHE"] = "0"
    applies = collapse_kernel.applies
    with tempfile.TemporaryDirectory() as root:
        mapping = cs.build_archive(root, cs.Archive({903: (4100, 4101, 4102, 4103)}))
        groups: dict = {}
        for files in mapping.values():
            for path in files.values():
                for z_scale in ("log", "linear"):
                    fig, _ = FAST_plot_pitch_angle_grid(path, scale_function_z=z_scale, show=False)
                    tile_h, tile_w, panels = cs.figure_panels(fig, FAST_SAVE_DPI)
                    groups.setdefault((z_scale, tile_h, tile_w), []).extend(panels)
        out: dict = {}
        try:
            for name in ("xla", "kernel", "kernel", "xla"):
                collapse_kernel.applies = applies if name == "kernel" else (lambda shape: False)
                dispatch._batched_quantize_fn.cache_clear()
                for (z_scale, tile_h, tile_w), panels in groups.items():
                    ms = _median_ms(lambda: dispatch.device_render_panels(panels, tile_h, tile_w), 9)
                    out.setdefault(f"{name}_{z_scale}_ms", []).append(ms)
                    out[f"panels_{z_scale}"] = len(panels)
        finally:
            collapse_kernel.applies = applies
            dispatch._batched_quantize_fn.cache_clear()
    print(json.dumps({"bench": "device_render_panels", **device, "bucket": [1024, 64, 96], **out}),
          flush=True)


def main() -> int:
    import subprocess

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print("needs a GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    device = {"device_kind": dev.device_kind, "nvidia_smi": smi}
    bench_kernel(device)
    bench_render(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())

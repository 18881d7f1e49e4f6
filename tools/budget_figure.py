#!/usr/bin/env python
"""Per-stage time budget for one production figure render.

Renders pitch-angle grid figures (8 panels each, the flagship workload) on
the requested backend with the process-wide stage timer active, and prints
one JSON line with ms-per-figure for every instrumented stage plus the
end-to-end figure total.  Residual = total minus instrumented stages
(panel prep, layout math, metadata bookkeeping).

Usage::

    python tools/budget_figure.py [--backend host|device|auto] [--figures N]

The warmup figure is excluded (compiles the device programs / builds font
caches), so numbers are steady-state.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
import sys

# Allow `python tools/<name>.py` without a manual PYTHONPATH: the repo
# root (the package's parent) precedes any site installs.
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--backend", choices=("host", "device", "auto"), default="device")
    parser.add_argument("--figures", type=int, default=6)
    parser.add_argument("--n-time", type=int, default=2048)
    args = parser.parse_args()

    from configurable_spectrograms_tpu.data.cdf_utils import load_filtered_orbits
    from configurable_spectrograms_tpu.data.synthetic import synth_fast_archive
    from configurable_spectrograms_tpu.fast.plotting import FAST_plot_pitch_angle_grid
    from configurable_spectrograms_tpu.render import figure as figure_mod
    from configurable_spectrograms_tpu.utils import timing

    if args.backend != "auto":
        figure_mod._BACKEND["mode"] = args.backend
    else:
        figure_mod.probe_device_link()

    with tempfile.TemporaryDirectory() as root:
        csv = os.path.join(root, "cusp.tsv")
        n_orbits = max(2, (args.figures + 3) // 4)
        mapping = synth_fast_archive(
            os.path.join(root, "data"),
            list(range(700, 700 + n_orbits)),
            n_time=args.n_time,
            n_angle=32,
            n_energy=48,
            cusp_csv_path=csv,
        )
        df = load_filtered_orbits(csv)
        jobs = [
            (orbit, inst, paths[inst])
            for orbit, paths in sorted(mapping.items())
            for inst in ("ees", "eeb", "ies", "ieb")
        ][: args.figures + 1]

        def render_one(orbit, path, out_path):
            fig, _ = FAST_plot_pitch_angle_grid(
                path,
                filtered_orbits_df=df,
                orbit_number=orbit,
                scale_function_y="log",
                scale_function_z="log",
                show=False,
                colormap="inferno",
            )
            fig.savefig(out_path, dpi=200)

        # Warmup: compile device programs / charge one-time costs.
        render_one(jobs[0][0], jobs[0][2], os.path.join(root, "warm.png"))

        timer = timing.StageTimer("budget")
        timing.ACTIVE = timer
        t0 = time.perf_counter()
        for k, (orbit, inst, path) in enumerate(jobs[1:]):
            render_one(orbit, path, os.path.join(root, f"fig_{k}.png"))
        total = time.perf_counter() - t0
        timing.ACTIVE = None

    n = len(jobs) - 1
    stages_ms = {k: 1e3 * v / n for k, v in sorted(timer.totals.items())}
    budget = {
        "workload": f"pitch-angle grid, 8 panels, n_time={args.n_time}, 200 DPI",
        "backend": (
            "host" if figure_mod._host_backend_active() else figure_mod._BACKEND["mode"]
        ),
        "figures": n,
        "figure_total_ms": 1e3 * total / n,
        "stages_ms_per_figure": stages_ms,
        "residual_ms": 1e3 * total / n - sum(stages_ms.values()),
        "figures_per_sec": n / total,
    }
    print(json.dumps(budget))
    return 0


if __name__ == "__main__":
    from configurable_spectrograms_tpu.cli.common import clean_exit

    clean_exit(main())

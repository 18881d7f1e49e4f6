#!/usr/bin/env python
"""Full-archive-scale validation with fault injection (VERDICT r3 item 2).

Scales the round-3 validation from 40 to the real 2000-2001 cusp-era
archive size (~325 orbits, the span of FAST_Cusp_Indices.csv; reference
README.md:81-82) across all four scale combos, and injects the faults a
production archive actually has:

* a TRUNCATED instrument CDF (download cut mid-transfer),
* a GARBAGE-header CDF (corrupt storage),
* a ZERO-LENGTH CDF (failed write),
* one mid-run ``SIGKILL`` of the driver process (crash), after which a
  second invocation must resume from the progress ledger without redoing
  completed work.

The run uses the host backend explicitly: it validates fault handling and
resume, not device speed, and a SIGKILLed process should not hold an
accelerator.

Phases (default ``all``):
  build   synth archive + fault injection
  run     driver run #1, SIGKILLed after --kill-after seconds
  resume  driver run #2 to completion, then run #3 (must be a no-op)
  verify  count PNGs, check the error taxonomy, write <root>/scale_result.json

Usage:
  python tools/scale_run.py --root /tmp/scale --orbits 325 --kill-after 180
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import signal
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent.parent

FIGS_PER_ORBIT_PER_COMBO = 10  # 4 pitch grids x2 (raw/given) + instrument grid x2
N_COMBOS = 4
FIRST_ORBIT = 3000

#: Faults: (orbit offset within the archive, instrument, kind)
FAULTS = [
    (7, "ees", "truncate"),
    (101, "ies", "garbage"),
    (203, "eeb", "empty"),
]


def _progress(msg: str) -> None:
    print(f"[scale] {time.strftime('%H:%M:%S')} {msg}", flush=True)


def build(root: pathlib.Path, n_orbits: int) -> dict:
    sys.path.insert(0, str(REPO))
    from configurable_spectrograms_tpu.data.synthetic import synth_fast_archive

    data = root / "FAST_data"
    csv = root / "FAST_Cusp_Indices.csv"
    orbits = list(range(FIRST_ORBIT, FIRST_ORBIT + n_orbits))
    t0 = time.time()
    mapping = synth_fast_archive(
        str(data), orbits, n_time=2048, n_angle=32, n_energy=48, cusp_csv_path=str(csv)
    )
    _progress(f"archive built: {n_orbits} orbits in {time.time() - t0:.0f}s")

    injected = []
    for off, inst, kind in FAULTS:
        orbit = FIRST_ORBIT + off
        path = pathlib.Path(mapping[orbit][inst])
        size = path.stat().st_size
        if kind == "truncate":
            path.write_bytes(path.read_bytes()[: int(size * 0.6)])
        elif kind == "garbage":
            blob = bytearray(path.read_bytes())
            blob[:256] = os.urandom(256)
            path.write_bytes(bytes(blob))
        elif kind == "empty":
            path.write_bytes(b"")
        injected.append({"orbit": orbit, "instrument": inst, "kind": kind})
        _progress(f"fault injected: orbit {orbit} {inst} {kind}")
    (root / "faults.json").write_text(json.dumps(injected, indent=2))
    return {"orbits": orbits, "faults": injected}


def _driver_env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = f"{REPO}:{env.get('PYTHONPATH', '')}"
    env["CST_RENDER_BACKEND"] = "host"  # see module docstring
    env.setdefault("CST_BATCH_SCHEDULE", "orbit-major")
    return env


def run_driver(root: pathlib.Path, kill_after: float | None) -> dict:
    """One driver invocation from the archive cwd; optionally SIGKILLed."""
    cmd = [sys.executable, str(REPO / "batch_multi_plot_FAST_spectrograms.py")]
    t0 = time.time()
    logf = open(root / f"driver_{int(t0)}.log", "w")
    proc = subprocess.Popen(cmd, cwd=root, env=_driver_env(), stdout=logf, stderr=logf)
    killed = False
    if kill_after is not None:
        try:
            proc.wait(timeout=kill_after)
        except subprocess.TimeoutExpired:
            _progress(f"SIGKILL after {kill_after:.0f}s (fault injection: crash)")
            proc.send_signal(signal.SIGKILL)
            proc.wait()
            killed = True
    else:
        proc.wait()
    logf.close()
    wall = time.time() - t0
    _progress(f"driver exited rc={proc.returncode} after {wall:.0f}s (killed={killed})")
    return {"wall_s": round(wall, 1), "returncode": proc.returncode, "killed": killed}


def count_pngs(root: pathlib.Path) -> int:
    out = root / "FAST_plots"
    return sum(1 for _ in out.rglob("*.png")) if out.exists() else 0


def verify(root: pathlib.Path, n_orbits: int, runs: list[dict]) -> dict:
    faults = json.loads((root / "faults.json").read_text())
    fault_orbits = {f["orbit"] for f in faults}
    progress = json.loads((root / "batch_multi_plot_FAST_progress.json").read_text())

    error_keys: dict[str, list[int]] = {
        k: v for k, v in progress.items()
        if isinstance(v, list) and ("error" in k or "timed_out" in k) and v
    }
    taxonomized = {o for v in error_keys.values() for o in v}
    missing_from_taxonomy = sorted(fault_orbits - taxonomized)

    pngs = count_pngs(root)
    good_orbits = n_orbits - len(fault_orbits)
    # A fault orbit still renders its 3 healthy instruments' pitch grids
    # (6 figures/combo) and the instrument grid skips the bad loader, so
    # the floor is all-good-orbit figures; the exact fault-orbit count
    # depends on which loads fail.
    floor = good_orbits * FIGS_PER_ORBIT_PER_COMBO * N_COMBOS
    active_wall = sum(r["wall_s"] for r in runs[:2])
    figs_per_sec = pngs / active_wall if active_wall else 0.0

    result = {
        "orbits": n_orbits,
        "combos": N_COMBOS,
        "pngs": pngs,
        "expected_floor": floor,
        "figs_per_sec_end_to_end": round(figs_per_sec, 2),
        "runs": runs,
        "faults": faults,
        "fault_orbits_in_error_taxonomy": sorted(fault_orbits & taxonomized),
        "fault_orbits_missing_from_taxonomy": missing_from_taxonomy,
        "error_taxonomy_keys": {k: v for k, v in sorted(error_keys.items())},
        "resume_noop_wall_s": runs[-1]["wall_s"] if len(runs) >= 3 else None,
        "ok": (
            pngs >= floor
            and not missing_from_taxonomy
            and (len(runs) < 3 or runs[-1]["wall_s"] < 120)
        ),
    }
    (root / "scale_result.json").write_text(json.dumps(result, indent=2))
    _progress(f"verify: pngs={pngs} floor={floor} figs/s={figs_per_sec:.2f} "
              f"taxonomy_ok={not missing_from_taxonomy} -> {root / 'scale_result.json'}")
    return result


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default="/tmp/scale_run")
    ap.add_argument("--orbits", type=int, default=325)
    ap.add_argument("--kill-after", type=float, default=180.0)
    ap.add_argument("--phase", default="all",
                    choices=["all", "build", "run", "resume", "verify"])
    args = ap.parse_args()
    root = pathlib.Path(args.root)
    root.mkdir(parents=True, exist_ok=True)

    runs_path = root / "runs.json"
    runs = json.loads(runs_path.read_text()) if runs_path.exists() else []

    if args.phase in ("all", "build"):
        build(root, args.orbits)
    if args.phase in ("all", "run"):
        runs.append(run_driver(root, kill_after=args.kill_after))
        runs_path.write_text(json.dumps(runs))
    if args.phase in ("all", "resume"):
        runs.append(run_driver(root, kill_after=None))  # completes the archive
        runs_path.write_text(json.dumps(runs))
        runs.append(run_driver(root, kill_after=None))  # must be a no-op resume
        runs_path.write_text(json.dumps(runs))
    if args.phase in ("all", "verify"):
        result = verify(root, args.orbits, runs)
        return 0 if result["ok"] else 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

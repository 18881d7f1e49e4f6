#!/usr/bin/env python
"""Drive the main paths once on an NVIDIA GPU and check them against the host reference.

    python chip_smoke.py          # one card: phases 1-5
    python chip_smoke.py --four   # four cards: the multi-device phase only

Phases, in order; any failure exits non-zero before the last line:

1. Device: JAX's first device must be a GPU (no CPU fallback).  Prints the
   card's name and power limit, the JAX version, and which optional
   packages import.
2. Flagship batch: the four-combo FAST batch (``FastBatchConfig.run``, as
   ``batch_multi_plot_FAST_spectrograms.py`` runs it) over a synthetic
   archive at the CDF schema widths (64 pitch bins x 96 energies), 8 orbits
   x 4 instruments at T = 903 and T = 1806, 200 DPI, 4 worker threads.
   Checks every PNG name and that the device, not a cache, did the work.
3. Parity: the archive's pitch-angle panels through ``device_render_panels``
   on the device backend and on the host backend (the plain numpy
   reference), held to :data:`PARITY`; then the extrema statistics.
4. Single figure: one instrument grid through
   ``single_plot_FAST_spectrograms.py``; prints its wall time.
5. Audio: the STFT and mel programs against numpy at n_fft 2048, hop 512,
   then one figure through ``single_plot_audio_spectrogram.py`` on 60 s of
   synthesized 22,050 Hz audio.

``--four`` runs only the multi-device phase: the flagship batch over four
cards and over one (``CST_DATA_MESH=0``), the collective extrema
reduction on a ``('data', 'time')`` mesh against single-device sums, and
the placement of replicated cubes on every card.

The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import glob
import importlib
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

#: Device-vs-host contract for every rendered panel.  The device's float32
#: log10 and division may differ from numpy's in the last ulp, which can
#: move a value across a colormap-bin edge, never further: every differing
#: pixel must decode to colormap indices at most ``max_bin_delta`` apart,
#: and at most ``max_diff_share`` of a panel's pixels may differ.  Scalar
#: metadata: ``n_kept``/``empty`` exact; ``y0``/``y1`` (energies picked
#: from the data) exact; ``vmin``/``vmax`` within ``bounds_rtol``, since a
#: percentile interpolates between float32 pitch sums that the card may
#: add in another order (at most 64 terms, about 4e-6 relative).
PARITY = {"max_bin_delta": 1, "max_diff_share": 0.02, "bounds_rtol": 1e-5}

#: Extrema statistics, device vs numpy: per-energy counts exact; the log10
#: histogram may move a sample whose log10 lies within float32 rounding of
#: a bin edge into the neighbouring bin, so cumulative counts must agree
#: within this share of the sample count.
EXTREMA_CUM_TOL = 1e-4

#: STFT/mel, device vs numpy's rFFT: max |device - numpy| over the
#: spectrum's peak, float32 at ``Precision.HIGHEST`` (a TF32 matmul would
#: miss it by two orders of magnitude).
STFT_REL_TOL = 1e-5


@dataclasses.dataclass(frozen=True)
class Archive:
    """A synthetic FAST archive: orbits per record length, schema widths."""

    orbits_by_t: dict
    n_angle: int = 64
    n_energy: int = 96

    @property
    def orbits(self) -> list[int]:
        return sorted(o for group in self.orbits_by_t.values() for o in group)


#: The flagship deployment at the CDF schema widths (FAST CDF variables.txt):
#: 8 orbits x 4 instruments, two record lengths so two padding buckets compile.
FLAGSHIP = Archive({903: (4100, 4101, 4102, 4103), 1806: (4104, 4105, 4106, 4107)})

#: Colour bounds the parity phase renders with: both z bounds given (the
#: sort-free program), the batch's global z_max with a percentile z_min (the
#: given-extrema figures), and both from percentiles (the raw figures).
BOUND_KINDS = ("explicit", "given_extrema", "percentile")

#: Audio at librosa's documented defaults.
AUDIO = {"sample_rate": 22050, "seconds": 60, "n_fft": 2048, "hop": 512, "n_mels": 128}


class SmokeFailure(RuntimeError):
    """A phase's check failed."""


def require(cond: bool, message: str) -> None:
    if not cond:
        raise SmokeFailure(message)


def say(**fields) -> None:
    print(json.dumps(fields, default=float), flush=True)


# --------------------------------------------------------------------- phase 1


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def device_phase(expected_count: int | None = None) -> dict:
    import jax

    devices = jax.devices()
    dev = devices[0]
    require(dev.platform == "gpu", f"JAX's first device is {dev.platform!r}, not a GPU")
    if expected_count is not None:
        require(len(devices) == expected_count,
                f"{len(devices)} GPUs visible, {expected_count} required")
    print(nvidia_smi_line(), flush=True)
    packages = {}
    for name in ("PIL", "pandas", "tqdm", "psutil", "matplotlib"):
        try:
            importlib.import_module(name)
            packages[name] = True
        except ImportError:
            packages[name] = False
    say(phase="device", jax=jax.__version__, device_kind=dev.device_kind,
        count=len(devices), packages=packages)
    return {"platform": dev.platform, "kind": dev.device_kind, "count": len(devices)}


def last_line(device: dict) -> str:
    """The result line: exactly the keys the contract names."""
    return json.dumps({"ok": True, "device": {
        "platform": device["platform"], "kind": device["kind"], "count": int(device["count"])}})


# --------------------------------------------------------------------- phase 2


def build_archive(root: str, archive: Archive) -> dict[int, dict[str, str]]:
    """Write ``root/FAST_data`` and ``root/FAST_Cusp_Indices.csv``."""
    from configurable_spectrograms_tpu.data.synthetic import synth_fast_archive

    data_dir = os.path.join(root, "FAST_data")
    mapping: dict[int, dict[str, str]] = {}
    tsv_lines: list[str] = []
    for n_time, orbits in sorted(archive.orbits_by_t.items()):
        tsv = os.path.join(root, f"cusp_{n_time}.tsv")
        # Uncompressed CDFs: writing gzip'd variables at these widths costs
        # minutes of host time and exercises nothing on the device.
        mapping.update(synth_fast_archive(
            data_dir, list(orbits), n_time=n_time, n_angle=archive.n_angle,
            n_energy=archive.n_energy, cusp_csv_path=tsv, compress="none",
        ))
        with open(tsv) as f:
            lines = f.read().splitlines()
        tsv_lines += lines if not tsv_lines else lines[1:]
        os.remove(tsv)
    with open(os.path.join(root, "FAST_Cusp_Indices.csv"), "w") as f:
        f.write("\n".join(tsv_lines) + "\n")
    return mapping


def expected_pngs(mapping: dict[int, dict[str, str]], combos) -> set[str]:
    """The batch driver's deterministic output names, relative to FAST_plots/.

    Per orbit and combo: a given-extrema and a raw pitch-angle grid per
    instrument (``_cusp`` tagged, since every synthetic orbit has a cusp
    interval) and a given-extrema and a raw instrument grid.
    """
    from configurable_spectrograms_tpu.data.orbit_discovery import parse_year_month

    names = set()
    for orbit, files in mapping.items():
        base = os.path.join(*parse_year_month(next(iter(files.values()))), str(orbit))
        for c in combos:
            for variant in ("given_extrema", "raw"):
                tail = f"_y-{c.y_scale}_z-{c.z_scale}_{variant}-{c.colormap}.png"
                names.add(os.path.join(base, f"{orbit}_instrument-grid_ESA{tail}"))
                for inst in files:
                    names.add(os.path.join(base, f"{orbit}_cusp_pitch-angle_ESA_{inst}{tail}"))
    return names


@contextlib.contextmanager
def working_dir(path: str):
    prev = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(prev)


def run_flagship(workdir: str, data_dir: str) -> list[dict]:
    """The flagship batch as the CLI runs it, with its outputs in *workdir*."""
    from configurable_spectrograms_tpu.utils.config import FastBatchConfig

    os.makedirs(workdir, exist_ok=True)
    with working_dir(workdir):
        # Generous soft timeouts: a cold process compiles each padding
        # bucket's programs inside its first orbits.
        return FastBatchConfig(
            directory_path=data_dir, use_tqdm=False,
            orbit_timeout_seconds=900, instrument_timeout_seconds=900,
        ).run()


def check_flagship_outputs(workdir: str, mapping, results: list[dict]) -> int:
    from configurable_spectrograms_tpu.utils.config import DEFAULT_SCALE_COMBOS

    bad = [r for r in results if r.get("status") != "ok"]
    require(results and not bad, f"batch jobs not ok: {bad[:3]}")
    out = os.path.join(workdir, "FAST_plots")
    got = {os.path.relpath(p, out) for p in glob.glob(os.path.join(out, "**", "*.png"), recursive=True)}
    want = expected_pngs(mapping, DEFAULT_SCALE_COMBOS)
    require(got == want, f"PNG names differ: missing {sorted(want - got)[:3]}, extra {sorted(got - want)[:3]}")
    return len(got)


def flagship_phase(root: str, mapping) -> str:
    from configurable_spectrograms_tpu.ops import extrema_ops
    from configurable_spectrograms_tpu.render import device_results, dispatch

    before = dispatch.upload_telemetry()
    hits_before = device_results.result_cache_stats()["hits"]
    extrema_ops.LAST_DISPATCH.update(lanes=0, devices=0)
    workdir = os.path.join(root, "flagship")
    t0 = time.perf_counter()
    results = run_flagship(workdir, os.path.join(root, "FAST_data"))
    wall = time.perf_counter() - t0
    n_png = check_flagship_outputs(workdir, mapping, results)
    after = dispatch.upload_telemetry()
    delta = {k: after[k] - before[k] for k in after}
    require(delta["dispatches"] > 0 and delta["upload_bytes"] > 0,
            f"the batch dispatched nothing to the device: {delta}")
    require(extrema_ops.LAST_DISPATCH["lanes"] > 0, "the extrema pre-pass never dispatched on the device")
    say(phase="flagship", pngs=n_png, jobs=len(results), wall_s=wall, device_telemetry=delta,
        result_cache_hits=device_results.result_cache_stats()["hits"] - hits_before,
        extrema_dispatch=dict(extrema_ops.LAST_DISPATCH))
    return workdir


# --------------------------------------------------------------------- phase 3


def _lut_keys(lut: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    keys = (lut[:, 0].astype(np.int64) << 16) | (lut[:, 1].astype(np.int64) << 8) | lut[:, 2]
    order = np.argsort(keys, kind="stable")
    return keys[order], order


def _bin_index(rgb: np.ndarray, sorted_keys: np.ndarray, order: np.ndarray) -> np.ndarray:
    """Colormap index of each RGB pixel, or -1 where the colour is not in the LUT."""
    keys = (rgb[..., 0].astype(np.int64) << 16) | (rgb[..., 1].astype(np.int64) << 8) | rgb[..., 2]
    pos = np.clip(np.searchsorted(sorted_keys, keys), 0, len(sorted_keys) - 1)
    return np.where(sorted_keys[pos] == keys, order[pos], -1)


def compare_panel(dev: dict, host: dict, lut: np.ndarray) -> dict:
    """Device vs host result for one panel, against :data:`PARITY`."""
    if "error" in dev or "error" in host:
        ok = dev.get("error") == host.get("error")
        return {"ok": ok, "diff_share": 0.0, "max_bin_delta": 0, "why": None if ok else "error differs"}
    why = []
    for key in ("n_kept", "empty", "y0", "y1"):
        if not np.array_equal(np.float64(dev[key]), np.float64(host[key]), equal_nan=True):
            why.append(f"{key} {dev[key]} vs {host[key]}")
    for key in ("vmin", "vmax"):
        if not np.isclose(float(dev[key]), float(host[key]), rtol=PARITY["bounds_rtol"], atol=0, equal_nan=True):
            why.append(f"{key} {dev[key]} vs {host[key]}")
    a, b = np.asarray(dev["rgba"]), np.asarray(host["rgba"])
    if a.shape != b.shape:
        return {"ok": False, "diff_share": 1.0, "max_bin_delta": None, "why": f"shape {a.shape} vs {b.shape}"}
    diff = (a != b).any(axis=-1)
    share = float(diff.mean())
    max_delta = 0
    if diff.any():
        sorted_keys, order = _lut_keys(np.asarray(lut))
        di = _bin_index(a[diff], sorted_keys, order)
        hi = _bin_index(b[diff], sorted_keys, order)
        if (di < 0).any() or (hi < 0).any():
            why.append("a differing pixel is not a colormap colour on one side")
            max_delta = None
        else:
            max_delta = int(np.abs(di - hi).max())
            if max_delta > PARITY["max_bin_delta"]:
                why.append(f"colormap bins {max_delta} apart")
    if share > PARITY["max_diff_share"]:
        why.append(f"{share:.4%} of pixels differ")
    return {"ok": not why, "diff_share": share, "max_bin_delta": max_delta, "why": "; ".join(why) or None}


def figure_panels(fig, dpi: float) -> tuple[int, int, list]:
    """A figure's panels and the tile size it renders them at."""
    from configurable_spectrograms_tpu.render.figure import _Layout

    layout = _Layout(fig, float(dpi))
    return layout.tile_h, layout.tile_w, [ax.panel for ax in fig.axes if ax.panel is not None]


def render_both(panels, tile_h: int, tile_w: int) -> tuple[list, list]:
    """Render *panels* on the device backend, then on the host backend."""
    from configurable_spectrograms_tpu.render import link
    from configurable_spectrograms_tpu.render.dispatch import device_render_panels

    mode = link._BACKEND["mode"]
    try:
        link._BACKEND["mode"] = "device"
        dev = device_render_panels(panels, tile_h, tile_w)
        link._BACKEND["mode"] = "host"
        host = device_render_panels(panels, tile_h, tile_w)
    finally:
        link._BACKEND["mode"] = mode
    return dev, host


def parity_phase(mapping, extrema: dict | None) -> None:
    from configurable_spectrograms_tpu.constants import FAST_SAVE_DPI
    from configurable_spectrograms_tpu.data.cdf_utils import load_filtered_orbits
    from configurable_spectrograms_tpu.fast.extrema import extrema_overrides
    from configurable_spectrograms_tpu.fast.plotting import FAST_plot_pitch_angle_grid
    from configurable_spectrograms_tpu.ops._colormap_data import colormap_lut
    from configurable_spectrograms_tpu.render import dispatch
    from configurable_spectrograms_tpu.utils.config import DEFAULT_SCALE_COMBOS

    cusp = load_filtered_orbits()
    summary = {kind: {"panels": 0, "max_diff_share": 0.0, "max_bin_delta": 0} for kind in BOUND_KINDS}
    failures = []
    skipped = 0
    before = dispatch.upload_telemetry()["dispatches"]
    for orbit, files in sorted(mapping.items()):
        for inst, path in files.items():
            for c in DEFAULT_SCALE_COMBOS:
                for bounds in BOUND_KINDS:
                    ymn, ymx, zmn, zmx = (None,) * 4
                    if bounds == "explicit":
                        zmn = 1.0 if c.z_scale == "log" else 0.0
                        zmx = float(extrema[f"{inst}_linear_linear_z_max"])
                    elif bounds == "given_extrema":
                        ymn, ymx, zmn, zmx = extrema_overrides(extrema, inst, c.y_scale, c.z_scale)
                    fig, _ = FAST_plot_pitch_angle_grid(
                        path, filtered_orbits_df=cusp, orbit_number=orbit,
                        scale_function_y=c.y_scale, scale_function_z=c.z_scale, show=False,
                        colormap=c.colormap, y_min=ymn, y_max=ymx, z_min=zmn, z_max=zmx,
                    )
                    if fig is None:
                        # The batch's log-axis extrema are log10 values
                        # (reference quirk): a log-y range like (-1, 3.7)
                        # keeps no energy bin, and the driver draws nothing.
                        require(bounds == "given_extrema", f"no {bounds} figure for {path}")
                        skipped += 1
                        continue
                    lut = colormap_lut(c.colormap)
                    tile_h, tile_w, panels = figure_panels(fig, FAST_SAVE_DPI)
                    dev, host = render_both(panels, tile_h, tile_w)
                    s = summary[bounds]
                    for d, h in zip(dev, host):
                        r = compare_panel(d, h, lut)
                        s["panels"] += 1
                        s["max_diff_share"] = max(s["max_diff_share"], r["diff_share"])
                        if r["max_bin_delta"] is not None:
                            s["max_bin_delta"] = max(s["max_bin_delta"], r["max_bin_delta"])
                        if not r["ok"]:
                            failures.append((os.path.basename(path), c.y_scale, c.z_scale, bounds, r["why"]))
    dispatched = dispatch.upload_telemetry()["dispatches"] - before
    say(phase="parity", contract=PARITY, dispatches=dispatched, summary=summary, empty_figures=skipped,
        failures=len(failures), first_failures=failures[:5])
    require(dispatched > 0, "parity renders never dispatched on the device")
    require(not failures, f"{len(failures)} panels break the parity contract")


def compare_stats(dev: dict, host: dict) -> str | None:
    """Device vs host extrema statistics for one file, against :data:`EXTREMA_CUM_TOL`."""
    if not np.array_equal(dev["counts"], host["counts"]):
        return "per-energy counts differ"
    n = int(host["hist"].sum())
    if int(dev["hist"].sum()) != n:
        return f"histogram totals differ: {int(dev['hist'].sum())} vs {n}"
    drift = int(np.abs(np.cumsum(dev["hist"]) - np.cumsum(host["hist"])).max())
    if drift > EXTREMA_CUM_TOL * max(n, 1):
        return f"cumulative histograms differ by {drift} of {n} samples"
    return None


def extrema_stats_phase(mapping) -> None:
    from configurable_spectrograms_tpu.data.cdf_utils import load_fast_cdf_dataset
    from configurable_spectrograms_tpu.ops.extrema_ops import batched_file_stats, host_file_stats

    by_t: dict[int, list[np.ndarray]] = {}
    for files in mapping.values():
        for path in files.values():
            cube = load_fast_cdf_dataset(path)["data"]
            by_t.setdefault(cube.shape[0], []).append(cube)
    problems = []
    n_files = 0
    for cubes in by_t.values():
        for cube, dev in zip(cubes, batched_file_stats(cubes)):
            why = compare_stats(dev, host_file_stats(np.asarray(cube, np.float32)))
            n_files += 1
            if why:
                problems.append(why)
    say(phase="extrema_stats", files=n_files, cum_tol=EXTREMA_CUM_TOL, mismatches=problems[:5])
    require(not problems, f"extrema statistics differ on {len(problems)} files")


# --------------------------------------------------------------------- phases 4-5


def run_entry(script: str, argv: list[str]) -> int:
    """Call a repo CLI's ``main()`` in this process (one process per card)."""
    module = importlib.import_module(script)
    saved = sys.argv
    sys.argv = [f"{script}.py", *argv]
    try:
        return module.main()
    finally:
        sys.argv = saved


def _png_ok(path: str) -> tuple[int, int]:
    from PIL import Image

    require(os.path.isfile(path), f"{path} was not written")
    with Image.open(path) as im:
        im.verify()
    with Image.open(path) as im:
        return im.size


def single_figure_phase(root: str, orbit: int) -> None:
    out = os.path.join(root, "single.png")
    with working_dir(root):
        t0 = time.perf_counter()
        rc = run_entry("single_plot_FAST_spectrograms",
                       ["--data-folder", "FAST_data", "--orbit", str(orbit), "--output", out])
        wall = time.perf_counter() - t0
    require(rc == 0, f"single_plot_FAST_spectrograms exited {rc}")
    say(phase="single_figure", orbit=orbit, size=_png_ok(out), wall_s=wall)


def synth_audio(seconds: int, sample_rate: int) -> np.ndarray:
    """A chirp with harmonics and noise, made from a fixed seed."""
    t = np.arange(seconds * sample_rate) / sample_rate
    f = 200.0 + 1800.0 * t / seconds
    phase = 2 * np.pi * np.cumsum(f) / sample_rate
    rng = np.random.default_rng(0)
    x = 0.5 * np.sin(phase) + 0.2 * np.sin(3 * phase) + 0.05 * rng.standard_normal(t.size)
    return x.astype(np.float32)


def rel_err(got: np.ndarray, ref: np.ndarray) -> float:
    return float(np.max(np.abs(np.asarray(got, np.float64) - ref)) / max(float(np.max(np.abs(ref))), 1e-30))


def audio_phase(root: str) -> None:
    import wave

    from configurable_spectrograms_tpu.ops.stft import (
        host_stft_magnitude,
        mel_filterbank,
        mel_spectrogram,
        stft_magnitude,
    )

    sr, n_fft, hop, n_mels = AUDIO["sample_rate"], AUDIO["n_fft"], AUDIO["hop"], AUDIO["n_mels"]
    x = synth_audio(AUDIO["seconds"], sr)
    ref = host_stft_magnitude(x, n_fft, hop, 2.0)
    weights, _ = mel_filterbank(n_mels, n_fft, float(sr))
    ref_mel = ref.astype(np.float64) @ weights
    errs = {}
    for method in ("fft", "matmul"):
        errs[f"stft_{method}"] = rel_err(stft_magnitude(x, n_fft, hop, 2.0, method), ref)
        errs[f"mel_{method}"] = rel_err(mel_spectrogram(x, sr, n_fft, hop, n_mels, 2.0, method), ref_mel)
    say(phase="audio_parity", precision="HIGHEST", rel_tol=STFT_REL_TOL, frames=ref.shape[0],
        n_fft=n_fft, hop=hop, rel_err=errs)
    require(all(e <= STFT_REL_TOL for e in errs.values()), f"STFT/mel beyond {STFT_REL_TOL}: {errs}")

    wav = os.path.join(root, "tone.wav")
    pcm = np.clip(x * 32767.0, -32768, 32767).astype("<i2")
    with wave.open(wav, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())
    out = os.path.join(root, "audio.png")
    t0 = time.perf_counter()
    rc = run_entry("single_plot_audio_spectrogram",
                   ["--wav-file", wav, "--output", out, "--frame-length", str(n_fft),
                    "--hop-length", str(hop)])
    wall = time.perf_counter() - t0
    require(rc == 0, f"single_plot_audio_spectrogram exited {rc}")
    say(phase="audio_figure", size=_png_ok(out), wall_s=wall)


# --------------------------------------------------------------------- --four


def _reset_device_caches() -> None:
    from configurable_spectrograms_tpu.parallel.mesh import _cached_data_mesh
    from configurable_spectrograms_tpu.render.device_cache import _DEVICE_CUBE_CACHE

    _DEVICE_CUBE_CACHE.clear()
    _cached_data_mesh.cache_clear()


def replicated_stacks_per_device() -> list[int]:
    """For every cached mesh-replicated cube stack, how many distinct devices hold a copy."""
    from configurable_spectrograms_tpu.render.device_cache import _DEVICE_CUBE_CACHE

    out = []
    for key, arr in zip(_DEVICE_CUBE_CACHE.keys(), _DEVICE_CUBE_CACHE.values()):
        if isinstance(key, tuple) and key and key[0] == "stack" and key[-1] is not None:
            out.append(len({s.device for s in arr.addressable_shards}))
    return out


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _pixel_diff_share(a: str, b: str) -> float:
    from PIL import Image

    with Image.open(a) as ia, Image.open(b) as ib:
        pa, pb = np.asarray(ia.convert("RGB")), np.asarray(ib.convert("RGB"))
    return 1.0 if pa.shape != pb.shape else float((pa != pb).any(axis=-1).mean())


def compare_png_trees(a_dir: str, b_dir: str) -> dict:
    """Compare two runs' output trees figure by figure.

    A ``given_extrema`` name is written by both of an orbit's jobs, the
    given-extrema one and the raw one, whichever finishes last
    (docs/parity.md): a run whose file equals its own ``raw`` twin was won
    by the raw job.  Where the two runs' winners differ the pair is a race,
    counted apart; every other pair must be byte-identical or within the
    parity contract's pixel share.
    """
    names = sorted(os.path.relpath(p, a_dir) for p in glob.glob(os.path.join(a_dir, "**", "*.png"), recursive=True))
    other = sorted(os.path.relpath(p, b_dir) for p in glob.glob(os.path.join(b_dir, "**", "*.png"), recursive=True))
    require(names == other and names, "the two runs wrote different PNG sets")
    differing, races = {}, []
    for name in names:
        a, b = _read(os.path.join(a_dir, name)), _read(os.path.join(b_dir, name))
        if a == b:
            continue
        if "_given_extrema-" in name:
            twin = name.replace("_given_extrema-", "_raw-")
            a_raw = a == _read(os.path.join(a_dir, twin))
            b_raw = b == _read(os.path.join(b_dir, twin))
            if a_raw != b_raw:
                races.append(name)
                continue
        differing[name] = _pixel_diff_share(os.path.join(a_dir, name), os.path.join(b_dir, name))
    return {"pngs": len(names), "identical": len(names) - len(differing) - len(races),
            "differing": differing, "races": races}


def four_phase(root: str, mapping) -> None:
    import jax

    from configurable_spectrograms_tpu.ops import extrema_ops
    from configurable_spectrograms_tpu.ops.extrema_ops import batched_file_stats
    from configurable_spectrograms_tpu.parallel import make_mesh, sharded_extrema_stats
    from configurable_spectrograms_tpu.render import dispatch

    n_dev = len(jax.devices())
    data_dir = os.path.join(root, "FAST_data")
    # Every run renders afresh: a result-cache hit would skip the dispatch.
    os.environ["CST_DEVICE_RESULT_CACHE"] = "0"
    runs = {}
    for label, mesh_env in (("mesh", "1"), ("single", "0")):
        os.environ["CST_DATA_MESH"] = mesh_env
        _reset_device_caches()
        dispatch.DISPATCH_HISTORY.clear()
        extrema_ops.LAST_DISPATCH.update(lanes=0, devices=0)
        workdir = os.path.join(root, label)
        t0 = time.perf_counter()
        results = run_flagship(workdir, data_dir)
        wall = time.perf_counter() - t0
        n_png = check_flagship_outputs(workdir, mapping, results)
        render_devices = sorted({h["devices"] for h in dispatch.DISPATCH_HISTORY})
        runs[label] = {"pngs": n_png, "wall_s": wall, "render_dispatch_devices": render_devices,
                       "extrema_dispatch_devices": extrema_ops.LAST_DISPATCH["devices"]}
        if label == "mesh":
            copies = replicated_stacks_per_device()
            runs[label]["replicated_stacks"] = len(copies)
            require(render_devices == [n_dev], f"render dispatches spanned {render_devices} devices, not {n_dev}")
            require(extrema_ops.LAST_DISPATCH["devices"] == n_dev,
                    f"extrema dispatch spanned {extrema_ops.LAST_DISPATCH['devices']} devices, not {n_dev}")
            require(copies and all(c == n_dev for c in copies),
                    f"replicated cube stacks are on {sorted(set(copies))} devices, not all {n_dev}")
    os.environ["CST_DATA_MESH"] = "1"
    trees = compare_png_trees(os.path.join(root, "mesh", "FAST_plots"), os.path.join(root, "single", "FAST_plots"))
    too_far = {k: v for k, v in trees["differing"].items() if v > PARITY["max_diff_share"]}
    say(phase="four_flagship", devices=n_dev, runs=runs, pngs=trees["pngs"], identical=trees["identical"],
        differing=len(trees["differing"]), max_diff_share=max(trees["differing"].values(), default=0.0),
        given_extrema_races=len(trees["races"]), contract=PARITY["max_diff_share"])
    require(not too_far, f"{len(too_far)} figures differ beyond the parity contract")

    # Collective extrema on a 2x2 ('data', 'time') mesh vs single-device sums.
    from configurable_spectrograms_tpu.data.cdf_utils import load_fast_cdf_dataset

    cubes = [load_fast_cdf_dataset(p)["data"] for files in mapping.values() for p in files.values()]
    t_max = max(c.shape[0] for c in cubes)
    t_pad = t_max + (-t_max) % 2
    batch = np.full((len(cubes) + len(cubes) % 2, t_pad, cubes[0].shape[1], cubes[0].shape[2]), np.nan, np.float32)
    t_valids = np.zeros((batch.shape[0],), np.int32)
    for i, c in enumerate(cubes):
        batch[i, : c.shape[0]] = c
        t_valids[i] = c.shape[0]
    mesh = make_mesh(n_dev, axis_names=("data", "time"), axis_sizes=(n_dev // 2, 2))
    counts, hist = sharded_extrema_stats(batch, t_valids, mesh)
    os.environ["CST_DATA_MESH"] = "0"
    try:
        single = batched_file_stats(cubes)
    finally:
        os.environ["CST_DATA_MESH"] = "1"
    counts_ok = all(np.array_equal(counts[i], s["counts"]) for i, s in enumerate(single))
    hist_ok = np.array_equal(hist, np.sum([s["hist"] for s in single], axis=0))
    say(phase="four_extrema", mesh={"data": n_dev // 2, "time": 2}, files=len(cubes),
        counts_equal=counts_ok, hist_equal=bool(hist_ok))
    require(counts_ok and hist_ok, "sharded extrema differ from the single-device sums")


# --------------------------------------------------------------------- main


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--four", action="store_true", help="run only the four-card phase")
    args = parser.parse_args(argv)
    device = device_phase(expected_count=4 if args.four else None)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        t0 = time.perf_counter()
        mapping = build_archive(root, FLAGSHIP)
        os.environ["CST_CUSP_CSV"] = os.path.join(root, "FAST_Cusp_Indices.csv")
        say(phase="archive", orbits=len(mapping), files=sum(len(f) for f in mapping.values()),
            lengths=sorted(FLAGSHIP.orbits_by_t), widths=[FLAGSHIP.n_angle, FLAGSHIP.n_energy],
            wall_s=time.perf_counter() - t0)
        with working_dir(root):
            if args.four:
                four_phase(root, mapping)
            else:
                workdir = flagship_phase(root, mapping)
                with open(os.path.join(workdir, "FAST_calculated_extrema.json")) as f:
                    extrema = json.load(f)
                # Later phases re-render panels the batch already rendered:
                # without this the result cache would answer them.
                os.environ["CST_DEVICE_RESULT_CACHE"] = "0"
                parity_phase(mapping, extrema)
                extrema_stats_phase(mapping)
                single_figure_phase(root, FLAGSHIP.orbits[0])
                audio_phase(root)
    print(last_line(device), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    try:
        code = main()
    except Exception:  # any phase's failure: report it and exit non-zero
        traceback.print_exc()
        code = 1
    try:
        from configurable_spectrograms_tpu.cli.common import clean_exit
    except ImportError:  # run outside the repository: nothing to tear down
        sys.exit(code)
    clean_exit(code)

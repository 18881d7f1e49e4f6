"""``chip_smoke.py``'s checks, exercised on the CPU.

The script itself runs on a GPU; here its comparators, its result line and
its refusal to run without a GPU are tested, and the name contract it
checks the flagship batch against is held to the real driver at a tiny
size.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402

LUT = np.stack([np.arange(256), 255 - np.arange(256), np.full(256, 7)], axis=1).astype(np.uint8)


def _rgba(idx: np.ndarray) -> np.ndarray:
    rgb = LUT[idx]
    return np.concatenate([rgb, np.full(idx.shape + (1,), 255, np.uint8)], axis=-1)


def _result(idx, **meta):
    base = {"vmin": 1.0, "vmax": 100.0, "y0": 4.0, "y1": 4000.0, "n_kept": 96, "empty": False}
    base.update(meta)
    return {"rgba": _rgba(idx), **base}


@pytest.fixture
def idx(rng):
    return rng.integers(1, 255, size=(40, 50))


def test_last_line_is_exactly_the_contract():
    line = cs.last_line({"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1, "extra": 3})
    assert line == '{"ok": true, "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}'
    assert json.loads(line)["device"]["count"] == 1


def test_device_phase_refuses_the_cpu():
    with pytest.raises(cs.SmokeFailure, match="not a GPU"):
        cs.device_phase()


def test_compare_panel_identical(idx):
    r = cs.compare_panel(_result(idx), _result(idx), LUT)
    assert r == {"ok": True, "diff_share": 0.0, "max_bin_delta": 0, "why": None}


def test_compare_panel_one_bin_flips_within_contract(idx):
    other = idx.copy()
    other[0, :10] += 1  # 10 of 2000 pixels, one bin apart
    r = cs.compare_panel(_result(idx), _result(other), LUT)
    assert r["ok"] and r["max_bin_delta"] == 1 and r["diff_share"] == pytest.approx(10 / 2000)


@pytest.mark.parametrize("shift, n_pixels, why", [
    (2, 1, "bins 2 apart"),
    (1, 100, "of pixels differ"),
])
def test_compare_panel_breaches(idx, shift, n_pixels, why):
    other = idx.copy()
    other.reshape(-1)[:n_pixels] += shift
    r = cs.compare_panel(_result(idx), _result(other), LUT)
    assert not r["ok"] and why in r["why"]


def test_compare_panel_rejects_a_non_colormap_pixel(idx):
    dev = _result(idx)
    dev["rgba"][3, 3, :3] = (1, 2, 3)  # no LUT entry has this colour
    r = cs.compare_panel(dev, _result(idx), LUT)
    assert not r["ok"] and "not a colormap colour" in r["why"]


@pytest.mark.parametrize("meta, ok", [
    ({"vmax": 100.0 * (1 + 5e-6)}, True),
    ({"vmax": 100.0 * (1 + 5e-5)}, False),
    ({"n_kept": 95}, False),
    ({"empty": True}, False),
    ({"y0": 4.0001}, False),
])
def test_compare_panel_metadata(idx, meta, ok):
    assert cs.compare_panel(_result(idx, **meta), _result(idx), LUT)["ok"] is ok


def test_compare_panel_errors_must_match(idx):
    err = {"error": "minvalue must be less than or equal to maxvalue"}
    assert cs.compare_panel(err, dict(err), LUT)["ok"]
    assert not cs.compare_panel(err, _result(idx), LUT)["ok"]


def test_compare_stats():
    hist = np.zeros(4096, np.int64)
    hist[[100, 2000]] = [50_000, 30_000]
    host = {"counts": np.array([3, 4]), "hist": hist}
    assert cs.compare_stats({"counts": np.array([3, 4]), "hist": hist.copy()}, host) is None
    moved = hist.copy()
    moved[100] -= 1
    moved[101] += 1  # one sample across one bin edge
    assert cs.compare_stats({"counts": np.array([3, 4]), "hist": moved}, host) is None
    far = hist.copy()
    far[100] -= 500
    far[3000] += 500
    assert "cumulative" in cs.compare_stats({"counts": np.array([3, 4]), "hist": far}, host)
    assert "counts" in cs.compare_stats({"counts": np.array([3, 5]), "hist": hist}, host)


def test_compare_png_trees_separates_the_given_raw_race(tmp_path):
    from PIL import Image

    def write(root, name, value):
        path = root / name
        path.parent.mkdir(parents=True, exist_ok=True)
        Image.fromarray(np.full((4, 4, 3), value, np.uint8)).save(path)

    a, b = tmp_path / "a", tmp_path / "b"
    for root, given in ((a, 10), (b, 20)):  # run b: the raw job won the race
        write(root, "o/1_x_raw-viridis.png", 20)
        write(root, "o/1_x_given_extrema-viridis.png", given)
        write(root, "o/1_y_raw-viridis.png", 30)
    write(b, "o/1_y_raw-viridis.png", 31)
    trees = cs.compare_png_trees(str(a), str(b))
    assert trees["races"] == ["o/1_x_given_extrema-viridis.png"]
    assert trees["differing"] == {"o/1_y_raw-viridis.png": 1.0}
    assert trees["identical"] == 1


def test_expected_pngs_match_the_driver(tmp_path, monkeypatch):
    """The name contract the flagship phase checks is the driver's own."""
    from configurable_spectrograms_tpu.fast import process_orbit

    archive = cs.Archive({24: (4100,), 40: (4101,)}, n_angle=8, n_energy=16)
    monkeypatch.setattr(process_orbit, "FAST_SAVE_DPI", 20)  # small figures
    mapping = cs.build_archive(str(tmp_path), archive)
    monkeypatch.setenv("CST_CUSP_CSV", str(tmp_path / "FAST_Cusp_Indices.csv"))
    workdir = str(tmp_path / "flagship")
    results = cs.run_flagship(workdir, str(tmp_path / "FAST_data"))
    assert cs.check_flagship_outputs(workdir, mapping, results) == 2 * 4 * 10


def _run_script(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_script_exits_nonzero_without_a_gpu():
    out = _run_script(REPO, "chip_smoke.py")
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "not a GPU" in out.stderr


def test_script_exits_nonzero_outside_the_repository(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path / "chip_smoke.py")
    out = _run_script(str(tmp_path), "chip_smoke.py")
    assert out.returncode != 0
    assert '"ok"' not in out.stdout

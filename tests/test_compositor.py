"""Pixel-level checks on the PIL compositor (ticks, markers, colorbars)."""

import numpy as np
import pytest

from configurable_spectrograms_tpu.render.figure import SpectroFigure
from configurable_spectrograms_tpu.render.plotting import make_spectrogram


@pytest.fixture(scope="module")
def panel_inputs():
    rng = np.random.default_rng(1234)  # own stream: module scope outlives the rng fixture
    T, A, E = 80, 8, 16
    cube = (rng.random((T, A, E)) * 100).astype(np.float32)
    energy = np.linspace(50, 3000, E).astype(np.float32)
    t = 9.468e8 + np.arange(T) * 10.0
    return t, energy, cube


def _render(fig, dpi=100):
    return np.asarray(fig.render(dpi=dpi).convert("RGB"))


def test_cusp_line_marker_pixels(panel_inputs):
    t, energy, cube = panel_inputs
    mark = float(t[40])
    fig = SpectroFigure(figsize=(8, 3))
    ax = fig.add_subplot(1, 1, 1)
    make_spectrogram(t, energy, cube, axis_object=ax, vertical_lines_unix=[mark],
                     cusp_marker_style="line", colormap="viridis")
    img = _render(fig)
    # A red column (the 2pt overlay) must exist inside the axes area.
    red = (img[:, :, 0] > 200) & (img[:, :, 1] < 80) & (img[:, :, 2] < 80)
    assert red.sum() > 20


def test_cusp_bracket_below_axis(panel_inputs):
    t, energy, cube = panel_inputs
    fig = SpectroFigure(figsize=(8, 3))
    ax = fig.add_subplot(1, 1, 1)
    make_spectrogram(t, energy, cube, axis_object=ax,
                     vertical_lines_unix=[float(t[30]), float(t[60])],
                     cusp_marker_style="bracket", colormap="viridis")
    base = SpectroFigure(figsize=(8, 3))
    bax = base.add_subplot(1, 1, 1)
    make_spectrogram(t, energy, cube, axis_object=bax, colormap="viridis")
    with_bracket = _render(fig)
    without = _render(base)
    # The bracket adds dark pixels; the tile itself is unchanged.
    dark_delta = int((with_bracket.sum(axis=-1) < 200).sum()) - int((without.sum(axis=-1) < 200).sum())
    assert dark_delta > 10


def test_nonunix_x_axis_ticks(panel_inputs):
    _, energy, cube = panel_inputs
    x = np.linspace(0.0, 10.0, cube.shape[0])
    fig = SpectroFigure(figsize=(8, 3))
    ax = fig.add_subplot(1, 1, 1)
    result = make_spectrogram(x, energy, cube, axis_object=ax, x_axis_is_unix=False,
                              x_axis_label="Seconds")
    assert result[0] is ax
    np.testing.assert_array_equal(result[1], x)  # no date conversion
    assert ax.xlabel == "Seconds"
    img = _render(fig)
    assert img.std() > 0


def test_colorbar_gradient_present(panel_inputs):
    t, energy, cube = panel_inputs
    fig = SpectroFigure(figsize=(8, 3))
    ax = fig.add_subplot(1, 1, 1)
    # Uniform mid-range data: the data TILE renders as one color (index
    # ~128), so the LUT endpoint colors below can only come from the
    # colorbar strip -- deleting the colorbar must fail this test.
    make_spectrogram(t, energy, np.full_like(cube, 50.0), axis_object=ax,
                     colormap="viridis", z_axis_min=0.0, z_axis_max=100.0)
    img = _render(fig)
    from configurable_spectrograms_tpu.ops import colormap_lut

    lut = colormap_lut("viridis")
    # Both colormap endpoints should appear (top and bottom of the strip).
    lo = np.all(np.abs(img.astype(int) - lut[4, :3].astype(int)) <= 2, axis=-1)
    hi = np.all(np.abs(img.astype(int) - lut[250, :3].astype(int)) <= 2, axis=-1)
    assert lo.any() and hi.any()
    mid = np.all(np.abs(img.astype(int) - lut[128, :3].astype(int)) <= 2, axis=-1)
    assert mid.any()  # the tile itself rendered


def test_single_sample_window(panel_inputs):
    """A one-sample time window renders without dividing by zero."""
    t, energy, cube = panel_inputs
    ax, x_plot = make_spectrogram(t[:1], energy, cube[:1])
    assert ax is not None and len(x_plot) == 1
    img = np.asarray(ax.figure.render(dpi=60) if hasattr(ax, "figure") else _render_axfig(ax))
    assert img.size > 0


def _render_axfig(ax):
    fig = SpectroFigure()
    fig.axes = [ax]
    return fig.render(dpi=60)


def test_stft_empty_signal():
    from configurable_spectrograms_tpu.ops.stft import stft_magnitude

    out = np.asarray(stft_magnitude(np.zeros(16, np.float32), frame_length=32, hop_length=8))
    assert out.shape[0] == 0  # shorter than one frame -> zero frames


def test_fastpng_roundtrip(tmp_path, rng):
    from PIL import Image as PILImage

    from configurable_spectrograms_tpu.render.fastpng import native_available, write_png_rgb

    if not native_available():
        pytest.skip("native fastpng unavailable (no g++?)")
    arr = (rng.random((64, 96, 3)) * 255).astype(np.uint8)
    path = str(tmp_path / "x.png")
    assert write_png_rgb(arr, path, 3)
    np.testing.assert_array_equal(np.asarray(PILImage.open(path)), arr)
    # Bad inputs fall back cleanly.
    assert not write_png_rgb(arr[:, :, :2], str(tmp_path / "bad.png"))


def test_canvas_pool_never_aliases_live_images(rng):
    """Two figures rendered back-to-back while BOTH images stay alive must
    not share the pooled canvas buffer (the finalizer recycles only after
    the first image dies)."""
    from configurable_spectrograms_tpu.data.synthetic import synth_instrument_arrays
    from configurable_spectrograms_tpu.render.plotting import generic_plot_spectrogram_set

    a = synth_instrument_arrays(rng, n_time=40, n_angle=6, n_energy=12)
    ds = [{"x": a["time_unix"], "y": a["energy"][0, 0, :], "data": a["data"], "label": "R"}]
    fig1, _ = generic_plot_spectrogram_set(ds, colormap="viridis")
    img1 = fig1.render(dpi=40)
    first = np.asarray(img1._np_canvas).copy()
    fig2, _ = generic_plot_spectrogram_set(ds, colormap="viridis")
    img2 = fig2.render(dpi=40)
    assert img1._np_canvas is not img2._np_canvas
    np.testing.assert_array_equal(np.asarray(img1._np_canvas), first)  # img1 untouched


def test_canvas_pool_recycles_after_collection(rng):
    """Once an image is garbage-collected its canvas returns to the pool
    and the next same-size render reuses the buffer (reset to white)."""
    import gc

    from configurable_spectrograms_tpu.data.synthetic import synth_instrument_arrays
    from configurable_spectrograms_tpu.render import compositor as figure_mod
    from configurable_spectrograms_tpu.render.plotting import generic_plot_spectrogram_set

    # The pool is process-global and size-capped; earlier tests may have
    # filled it with other canvas sizes, so start from a clean slate.
    gc.collect()
    with figure_mod._CANVAS_POOL_LOCK:
        figure_mod._CANVAS_POOL.clear()

    a = synth_instrument_arrays(rng, n_time=40, n_angle=6, n_energy=12)
    ds = [{"x": a["time_unix"], "y": a["energy"][0, 0, :], "data": a["data"], "label": "R"}]
    fig1, _ = generic_plot_spectrogram_set(ds, colormap="viridis")
    img1 = fig1.render(dpi=40)
    ref_pixels = np.asarray(img1._np_canvas).copy()
    key = img1._np_canvas.shape[:2]
    buf_id = id(img1._np_canvas)
    del img1
    gc.collect()
    assert any(id(c) == buf_id for c in figure_mod._CANVAS_POOL.get(key, []))
    fig2, _ = generic_plot_spectrogram_set(ds, colormap="viridis")
    img2 = fig2.render(dpi=40)
    assert id(img2._np_canvas) == buf_id  # reused...
    np.testing.assert_array_equal(np.asarray(img2._np_canvas), ref_pixels)  # ...bit-identically


def test_fill_outside_whitens_exactly_the_complement(rng):
    """_fill_outside must whiten every pixel outside the rect union and
    touch nothing inside it (the blits own those pixels)."""
    from configurable_spectrograms_tpu.render import compositor as F

    H, W = 40, 50
    poison = rng.integers(0, 255, (H, W, 4)).astype(np.uint8)
    canvas = poison.copy()
    # Overlapping rects, one clipping off-canvas, one degenerate.
    rects = [(5, 3, 20, 17), (18, 10, 35, 30), (-4, 35, 10, 60), (7, 7, 7, 20)]
    F._fill_outside(canvas, rects)
    covered = np.zeros((H, W), bool)
    for x0, y0, x1, y1 in rects:
        covered[max(y0, 0) : min(y1, H), max(x0, 0) : min(x1, W)] = True
    assert (canvas[~covered] == 255).all()
    np.testing.assert_array_equal(canvas[covered], poison[covered])
    # With no rects the whole canvas whitens.
    canvas2 = poison.copy()
    F._fill_outside(canvas2, [])
    assert (canvas2 == 255).all()


def test_poisoned_recycled_canvas_renders_identically(rng):
    """A recycled canvas arrives with arbitrary stale pixels; the complement
    fill plus the full-coverage blits must erase every one of them.  Unlike
    test_canvas_pool_recycles_after_collection (whose recycled canvas holds
    the SAME figure's pixels), this seeds the pool with a garbage canvas so
    any under-filled region shows through."""
    import gc

    from configurable_spectrograms_tpu.data.synthetic import synth_instrument_arrays
    from configurable_spectrograms_tpu.render import compositor as F
    from configurable_spectrograms_tpu.render.plotting import generic_plot_spectrogram_set

    gc.collect()
    with F._CANVAS_POOL_LOCK:
        saved = dict(F._CANVAS_POOL)
        F._CANVAS_POOL.clear()
    try:
        a = synth_instrument_arrays(rng, n_time=40, n_angle=6, n_energy=12)
        ds = [{"x": a["time_unix"], "y": a["energy"][0, 0, :], "data": a["data"], "label": "R"}]
        fig1, _ = generic_plot_spectrogram_set(ds, colormap="viridis")
        img1 = fig1.render(dpi=40)
        ref_pixels = np.asarray(img1._np_canvas).copy()
        h, w = img1._np_canvas.shape[:2]
        del img1, fig1
        gc.collect()
        with F._CANVAS_POOL_LOCK:
            F._CANVAS_POOL.clear()
        poison = np.empty((h, w, 4), np.uint8)
        poison[...] = 13
        F._release_canvas(poison)
        poison_id = id(poison)
        del poison
        fig2, _ = generic_plot_spectrogram_set(ds, colormap="viridis")
        img2 = fig2.render(dpi=40)
        assert id(img2._np_canvas) == poison_id  # the poisoned canvas was reused
        np.testing.assert_array_equal(np.asarray(img2._np_canvas), ref_pixels)
    finally:
        with F._CANVAS_POOL_LOCK:
            F._CANVAS_POOL.clear()
            F._CANVAS_POOL.update(saved)


def test_fastpng_rle_encoder_roundtrip(tmp_path, rng, monkeypatch):
    """The specialized run/LZ fixed-Huffman deflate path (taken automatically
    for mostly-white canvases) is byte-exact for every canvas shape it can
    see, including RGBA input and degenerate sizes."""
    from PIL import Image as PILImage

    from configurable_spectrograms_tpu.render.fastpng import native_available, write_png_rgb

    if not native_available():
        pytest.skip("native fastpng unavailable (no g++?)")
    monkeypatch.setenv("FASTPNG_ENCODER", "rle")
    white = np.full((300, 500, 3), 255, np.uint8)
    tiles = white.copy()
    tiles[40:200, 60:400] = (rng.random((160, 340, 3)) * 255).astype(np.uint8)
    cases = {
        "white": white,
        "tiles": tiles,
        "noise": (rng.random((257, 333, 3)) * 255).astype(np.uint8),
        "tiny": (rng.random((1, 1, 3)) * 255).astype(np.uint8),
        "stripes": np.tile((rng.random((1, 64, 3)) * 255).astype(np.uint8), (64, 3, 1)),
    }
    cases["rgba"] = np.dstack([tiles, np.full(tiles.shape[:2], 77, np.uint8)])
    for name, arr in cases.items():
        path = str(tmp_path / f"{name}.png")
        assert write_png_rgb(arr, path), name
        np.testing.assert_array_equal(np.asarray(PILImage.open(path)), arr[:, :, :3])
    # Auto mode routes a mostly-white canvas to the RLE encoder and noise to
    # libdeflate; both must still round-trip.
    monkeypatch.delenv("FASTPNG_ENCODER")
    for name in ("tiles", "noise"):
        path = str(tmp_path / f"auto_{name}.png")
        assert write_png_rgb(cases[name], path)
        np.testing.assert_array_equal(np.asarray(PILImage.open(path)), cases[name][:, :, :3])


def test_recommended_workers_host_vs_device(monkeypatch):
    """Host backend clamps feeder threads to visible cores (threads beyond
    cores measured 3.5x slower); device backend keeps the requested count
    (threads overlap link/device time)."""
    import os

    from configurable_spectrograms_tpu.render import figure as figure_mod

    cores = len(os.sched_getaffinity(0))
    monkeypatch.setitem(figure_mod._BACKEND, "mode", "host")
    assert figure_mod.recommended_workers(4) == min(4, cores)
    assert figure_mod.recommended_workers(0) == 1
    monkeypatch.setitem(figure_mod._BACKEND, "mode", "device")
    assert figure_mod.recommended_workers(4) == 4
    monkeypatch.setitem(figure_mod._BACKEND, "mode", "auto")
    monkeypatch.setitem(figure_mod._BACKEND, "forced_host", True)
    assert figure_mod.recommended_workers(7) == min(7, cores)


def test_fastpng_concurrent_encodes(tmp_path, rng):
    """Batch feeder threads encode concurrently (the binding releases the
    GIL; scratch buffers are thread_local): every output must round-trip
    exactly under contention."""
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image as PILImage

    from configurable_spectrograms_tpu.render.fastpng import native_available, write_png_rgb

    if not native_available():
        pytest.skip("native fastpng unavailable (no g++?)")
    white = np.full((240, 400, 3), 255, np.uint8)
    imgs = []
    for k in range(12):
        a = white.copy()
        a[20:200, 30 + k : 350] = (rng.random((180, 320 - k, 3)) * 255).astype(np.uint8)
        imgs.append(a)

    def enc(k):
        path = str(tmp_path / f"c{k}.png")
        assert write_png_rgb(imgs[k], path)
        return k, path

    with ThreadPoolExecutor(max_workers=4) as pool:
        for k, path in pool.map(enc, range(len(imgs))):
            np.testing.assert_array_equal(np.asarray(PILImage.open(path)), imgs[k])


def test_canvas_pool_depth_follows_worker_demand(monkeypatch):
    """A batch pool announcing more workers than the default depth must
    deepen the canvas pool (review finding: a constant depth re-created
    the undersized-pool fault for larger pools); an explicit
    CST_CANVAS_POOL_PER_SIZE pins the depth instead."""
    from configurable_spectrograms_tpu.render import compositor

    monkeypatch.delenv("CST_CANVAS_POOL_PER_SIZE", raising=False)
    before = compositor._CANVAS_POOL_MAX_PER_SIZE
    try:
        compositor.ensure_canvas_pool_depth(before + 3)
        assert compositor._CANVAS_POOL_MAX_PER_SIZE == before + 3
        compositor.ensure_canvas_pool_depth(1)  # never shrinks
        assert compositor._CANVAS_POOL_MAX_PER_SIZE == before + 3

        monkeypatch.setenv("CST_CANVAS_POOL_PER_SIZE", "2")
        compositor.ensure_canvas_pool_depth(64)  # env pins: no growth
        assert compositor._CANVAS_POOL_MAX_PER_SIZE == before + 3

        # The WIRING is the point (the review finding was about batch
        # pools, not the helper): sizing a pool through
        # recommended_workers must announce its demand.
        monkeypatch.delenv("CST_CANVAS_POOL_PER_SIZE", raising=False)
        from configurable_spectrograms_tpu.render import link as link_mod

        monkeypatch.setitem(link_mod._BACKEND, "mode", "device")
        monkeypatch.setitem(link_mod._BACKEND, "forced_host", False)
        # recommended_workers may run the one-shot probe, which flips
        # "probed" for the process; register its current value so
        # monkeypatch restores it for later auto-mode tests.
        monkeypatch.setitem(link_mod._BACKEND, "probed", link_mod._BACKEND["probed"])
        link_mod.recommended_workers(before + 7)
        assert compositor._CANVAS_POOL_MAX_PER_SIZE == before + 7
    finally:
        compositor._CANVAS_POOL_MAX_PER_SIZE = before


def test_save_image_png_write_is_atomic(tmp_path, monkeypatch):
    """PNG saves go through a unique tmp sibling + os.replace: a crash
    mid-encode must never leave a truncated file under the final name
    (the batch resume protocol skips existing files, so a partial PNG
    would survive every subsequent resume)."""
    from PIL import Image

    from configurable_spectrograms_tpu.render import figure as figure_mod

    img = Image.new("RGB", (16, 12), (200, 30, 30))
    out = tmp_path / "fig.png"
    figure_mod.save_image(img, str(out))
    assert out.exists() and Image.open(out).size == (16, 12)
    assert not list(tmp_path.glob("*.tmp-*"))  # no tmp leftovers

    # Simulated crash mid-encode: the encoder writes a partial tmp file
    # then dies.  The final name must not appear, and the tmp is removed.
    def _partial_then_die(arr, path, level):
        with open(path, "wb") as fh:
            fh.write(b"\x89PNG_truncated")
        raise RuntimeError("killed mid-encode")

    import configurable_spectrograms_tpu.render.fastpng as fastpng_mod

    monkeypatch.setattr(fastpng_mod, "write_png_rgb", _partial_then_die)
    out2 = tmp_path / "fig2.png"
    try:
        figure_mod.save_image(img, str(out2))
    except RuntimeError:
        pass
    assert not out2.exists()
    assert not list(tmp_path.glob("*.tmp-*"))


def test_copy_saved_png_is_atomic(tmp_path):
    from configurable_spectrograms_tpu.fast.process_orbit import _copy_saved_png

    src = tmp_path / "a.png"
    src.write_bytes(b"\x89PNG fake payload")
    dst = tmp_path / "b.png"
    _copy_saved_png(str(src), str(dst))
    assert dst.read_bytes() == src.read_bytes()
    assert not list(tmp_path.glob("*.tmp-*"))


def test_font_loads_from_the_package():
    """Figure text uses the DejaVu Sans shipped in the package, so it does
    not depend on matplotlib or on the fonts an installation happens to have."""
    import os

    import configurable_spectrograms_tpu
    from configurable_spectrograms_tpu.render import text

    pkg = os.path.dirname(os.path.abspath(configurable_spectrograms_tpu.__file__))
    assert text.FONT_PATH == os.path.join(pkg, "render", "fonts", "DejaVuSans.ttf")
    assert os.path.isfile(text.FONT_PATH)
    assert os.path.isfile(os.path.join(pkg, "render", "fonts", "LICENSE_DEJAVU"))
    font = text.get_font(14)
    assert font.path == text.FONT_PATH
    assert font.getname() == ("DejaVu Sans", "Book")

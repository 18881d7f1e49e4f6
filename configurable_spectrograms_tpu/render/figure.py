"""Figure/axes model with deferred, batched device rasterization.

A :class:`SpectroFigure` mirrors the slice of the matplotlib
``Figure``/``Axes`` API the reference's pipelines touch (``add_subplot``,
``suptitle``, ``text``, ``savefig``, per-axes ``set_title``/``set_ylabel``),
but nothing rasterizes until :meth:`SpectroFigure.savefig`/:meth:`render`:
the figure only accumulates :class:`PanelData` descriptions.  At render
time every panel in the figure (and, via
:func:`~configurable_spectrograms_tpu.render.dispatch.device_render_panels`,
every panel across a *batch* of figures) is padded into shape buckets and
rasterized in a handful of vmapped device dispatches; the PIL compositor then
draws frames, ticks, labels, colorbars, cusp markers, and titles around the
device-produced tiles.

This replaces the reference's per-panel matplotlib Agg pipeline
(reference plotting.py:229-235,392-502,505-698).  The dispatch pipeline
itself (shape buckets, packed lanes, the jitted program, PendingRender,
link fallbacks) lives in :mod:`configurable_spectrograms_tpu.render.dispatch`;
this module keeps the figure model and re-exports the historical names.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np
from PIL import Image

from configurable_spectrograms_tpu.render.compositor import (  # noqa: F401 (re-export)
    AXIS_LABEL_PT,
    TICK_LABEL_PT,
    _Layout,
)

# The dispatch pipeline lives in render/dispatch.py (grouping/enqueue),
# render/drain.py (PendingRender readbacks), render/panel.py (PanelData +
# host group render), and render/device_cache.py (resident cubes); the
# link state machine in render/link.py.  The names are re-exported here
# because this module is their historical home and callers (batch
# drivers, bench, ops modules, tools) import them from ``figure``.
# NOTE: tests/tools that monkeypatch pipeline internals must patch the
# OWNING module, where the pipeline resolves them: ``drain._readback``,
# ``device_cache._padded_device_cube``, ``panel._render_group_host``.
# Patching the re-exports here or on ``dispatch`` is a silent no-op.
from configurable_spectrograms_tpu.render.dispatch import (  # noqa: F401 (re-export)
    DISPATCH_HISTORY,
    LAST_DISPATCH,
    PanelData,
    PendingRender,
    _ACTIVE_DRAINS,
    _batched_quantize_fn,
    _bucket,
    _DEVICE_CUBE_CACHE,
    _enqueue_group,
    _finish_group,
    _GroupDispatch,
    _pack_lanes,
    _padded_device_cube,
    _prepare_group,
    _readback,
    _render_group_host,
    _render_mesh,
    _stack_cubes,
    device_render_panels,
    enqueue_render_panels,
)
from configurable_spectrograms_tpu.render.link import (  # noqa: F401 (re-export)
    _BACKEND,
    _BACKEND_LOCK,
    _CALIBRATE_XFER_SEC_PER_PANEL,
    _MIN_LINK_MBPS,
    _bounded_call,
    _dispatch_timeout,
    _host_backend_active,
    force_host_after_dispatch_failure,
    maybe_reprobe_device_link,
    probe_device_link,
    recommended_workers,
)

class Axes:
    """One grid cell of a :class:`SpectroFigure` (a matplotlib-Axes stand-in)."""

    def __init__(self, figure: "SpectroFigure", row: int, col: int):
        self.figure = figure
        self.row = row
        self.col = col
        self.panel: PanelData | None = None
        self.title: str | None = None
        self.title_fontsize_pt: float = AXIS_LABEL_PT
        self.xlabel: str | None = None
        self.ylabel: str | None = None
        self.ylabel_rotation: float = 90.0
        self.result: dict[str, Any] | None = None  # device outputs after render

    # -- matplotlib-parity setters -----------------------------------------

    def set_title(self, title: str, fontsize: float | None = None) -> None:
        self.title = title
        if fontsize is not None:
            self.title_fontsize_pt = float(fontsize)

    def set_xlabel(self, label: str) -> None:
        self.xlabel = label

    def set_ylabel(self, label: str, fontsize: float | None = None, rotation: float = 90, **kwargs) -> None:
        self.ylabel = label
        self.ylabel_rotation = rotation


class SpectroFigure:
    """A deferred-render figure; the matplotlib-Figure stand-in."""

    def __init__(self, figsize: tuple[float, float] = (6.25, 2.0), dpi: float = 100.0):
        self.figsize = figsize
        self.dpi = dpi
        self.nrows = 1
        self.ncols = 1
        self.axes: list[Axes] = []
        self._grid: dict[tuple[int, int], Axes] = {}
        self.suptitle_text: str | None = None
        self.suptitle_pt: float = AXIS_LABEL_PT + 2
        self.fig_texts: list[dict] = []
        self.bottom_reserve: float = 0.0  # figure-fraction bottom space
        self.number = None  # Gcf-compat attribute

    # -- construction --------------------------------------------------------

    def add_subplot(self, nrows: int, ncols: int, index: int) -> Axes:
        self.nrows, self.ncols = nrows, ncols
        row, col = divmod(index - 1, ncols)
        ax = Axes(self, row, col)
        self.axes.append(ax)
        self._grid[(row, col)] = ax
        return ax

    def suptitle(self, text: str, fontsize: float | None = None) -> None:
        self.suptitle_text = text
        if fontsize is not None:
            self.suptitle_pt = float(fontsize)

    def text(self, x: float, y: float, s: str, ha: str = "center", va: str = "bottom",
             fontsize: float = 13.0, color: str = "black", **kwargs) -> None:
        self.fig_texts.append({"x": x, "y": y, "s": s, "ha": ha, "va": va, "pt": fontsize, "color": color})

    def subplots_adjust(self, bottom: float | None = None, **kwargs) -> None:
        if bottom is not None:
            self.bottom_reserve = max(self.bottom_reserve, bottom)

    def tight_layout(self, rect: tuple | None = None) -> None:
        if rect is not None:
            self.bottom_reserve = max(self.bottom_reserve, rect[1])

    # -- rendering -----------------------------------------------------------

    def savefig(self, path: str, dpi: float | None = None, compress_level: int = 3) -> None:
        """Render and write a PNG.

        ``compress_level`` trades PNG size for encode speed.  PNG output
        goes through the native encoder when available (2.5x faster than
        PIL at equal size on these figures) with a PIL fallback.

        One compute-gate slot spans render AND encode (the inner gates
        are re-entrant): releasing between the two would let a sibling
        feeder thread start its composite mid-figure and steal GIL slices
        from this one's encode (utils/compute_gate).
        """
        from configurable_spectrograms_tpu.utils.compute_gate import host_compute_gate

        with host_compute_gate():
            save_image(self.render(dpi=dpi), path, compress_level=compress_level)

    def render(self, dpi: float | None = None) -> Image.Image:
        return render_figures([self], dpi=dpi)[0]

    def clear(self) -> None:
        self.axes.clear()
        self._grid.clear()

    # matplotlib-compat aliases used by close_all_axes_and_clear
    def clf(self) -> None:
        self.clear()

    def delaxes(self, ax: Axes) -> None:
        if ax in self.axes:
            self.axes.remove(ax)


def save_image(image: Image.Image, path: str, compress_level: int = 3) -> None:
    """Write a rendered figure image; native fast-PNG when possible.

    The native path (render/fastpng.py) releases the GIL for the whole
    encode, so batch worker threads overlap PNG writing with device work.

    PNG writes are atomic (encode to a unique ``.tmp-*`` sibling, then
    ``os.replace``): the batch resume protocol skips existing files
    (``override_plots=False``), so a SIGKILL landing mid-write must never
    leave a truncated PNG under its final name -- it would survive every
    subsequent resume.
    """
    import threading

    from configurable_spectrograms_tpu.utils.timing import active_stage

    from configurable_spectrograms_tpu.utils.compute_gate import host_compute_gate

    is_png = path.lower().endswith(".png") or "." not in os.path.basename(path)
    if is_png:
        with host_compute_gate(), active_stage("png_encode"):
            from configurable_spectrograms_tpu.render.fastpng import write_png_rgb
            from configurable_spectrograms_tpu.utils.writeback import note_written

            # Compositor-rendered figures carry their numpy canvas: encode it
            # directly (zero copies -- the native encoder drops RGBA's alpha).
            arr = getattr(image, "_np_canvas", None)
            if arr is None:
                rgb = image if image.mode == "RGB" else image.convert("RGB")
                arr = np.asarray(rgb)
            # Unique per writer: concurrent raw/given jobs may target the
            # same final name (the reference's documented write race).
            tmp = f"{path}.tmp-{os.getpid()}-{threading.get_ident()}"
            try:
                if not write_png_rgb(arr, tmp, compress_level):
                    img = image if image.mode == "RGB" else image.convert("RGB")
                    img.save(tmp, format="PNG", compress_level=compress_level)
                os.replace(tmp, path)
            except BaseException:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise
            note_written(path)
    else:
        # Formats without alpha (JPEG, BMP) reject RGBA; flatten first.
        fmt_needs_rgb = os.path.splitext(path)[1].lower() in (".jpg", ".jpeg", ".bmp")
        (image.convert("RGB") if fmt_needs_rgb and image.mode != "RGB" else image).save(path)


def render_figures(figures: list["SpectroFigure"], dpi: float | None = None) -> list[Image.Image]:
    """Render many figures with their panels pooled into shared dispatches.

    Panels from every figure group by tile geometry, so e.g. an orbit's
    eight pitch-angle grids plus two instrument grids rasterize in a couple
    of device calls instead of ten -- the device fan-out the reference got
    from its process pool (reference fast/batch_directory.py:337), obtained
    here by widening the batch instead.
    """
    from configurable_spectrograms_tpu.render.service import coalesced_render
    from configurable_spectrograms_tpu.utils.compute_gate import (
        gate_released,
        host_compute_gate,
    )
    from configurable_spectrograms_tpu.utils.timing import active_stage

    def _composite_one(layout):
        # Re-entrant under the outer gate; still gates direct callers that
        # reach composite outside render_figures' scope.
        with host_compute_gate(), active_stage("composite"):
            return layout.composite()

    # One gate slot spans the WHOLE render: with only composite/encode
    # gated, sibling feeder threads' ungated Python steals GIL slices from
    # the gate holder on warm multi-thread batches.  The slot is yielded around the coalesced render --
    # the one section that legitimately blocks on the device -- so wide
    # pools still overlap device waits exactly as before.
    with host_compute_gate():
        layouts = [_Layout(fig, float(dpi or fig.dpi)) for fig in figures]
        by_tile: dict[tuple[int, int], list[tuple[int, int]]] = {}
        for f_i, (fig, layout) in enumerate(zip(figures, layouts)):
            for a_i, ax in enumerate(fig.axes):
                ax.result = None
                if ax.panel is not None:
                    by_tile.setdefault((layout.tile_h, layout.tile_w), []).append((f_i, a_i))
        for (tile_h, tile_w), slots in by_tile.items():
            panels = [figures[f_i].axes[a_i].panel for f_i, a_i in slots]
            with gate_released():
                results = coalesced_render(panels, tile_h, tile_w)
            for (f_i, a_i), res in zip(slots, results):
                figures[f_i].axes[a_i].result = res
        return [_composite_one(layout) for layout in layouts]


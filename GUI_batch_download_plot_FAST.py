#!/usr/bin/env python
"""Download / batch-plot / single-day front-end for the FAST pipelines.

Capability parity with the reference's PySide6 application
(reference GUI_batch_download_plot_FAST.py:3-18,2032-2146): three pages --
**Download** (instruments + years to a folder), **Plot** (batch directory
runs over scale combos), and **Single Day** (pitch-angle or instrument-grid
mode from a folder/orbit or a downloaded date).  Each action runs in a
separate ``multiprocessing.Process`` with a monitoring thread, the same
isolation pattern the reference uses so a stuck run can be stopped without
killing the UI.

Two front-ends over the same worker functions:

* a PySide6 window when Qt is installed (the reference's stack), or
* a terminal menu (``--tui``, also the automatic fallback) -- this
  environment ships no Qt, and every workflow remains fully usable.

Both call the identical module-level process targets below, which are also
directly importable for scripting/tests.
"""

from __future__ import annotations

import argparse
import multiprocessing
import sys
import threading
from dataclasses import dataclass, field

DEFAULT_SCALE_COMBOS = [
    ("linear", "linear", "viridis"),
    ("linear", "log", "cividis"),
    ("log", "linear", "plasma"),
    ("log", "log", "inferno"),
]

_COMBO_COLORMAPS = {(y, z): cmap for y, z, cmap in DEFAULT_SCALE_COMBOS}


def parse_scale_combos(spec: str) -> list[tuple[str, str, str]]:
    """Parse a user-facing scale-combo spec into ``(y, z, colormap)`` triples.

    The reference Plot page exposes axis scales and colormap as widgets
    (reference GUI_batch_download_plot_FAST.py:10-11,646-652); both
    front-ends here take the textual equivalent: ``all`` (the four default
    combos) or whitespace-separated ``y-z`` / ``y-z-colormap`` entries,
    where an omitted colormap falls back to the combo's default.

    >>> parse_scale_combos("all") == DEFAULT_SCALE_COMBOS
    True
    >>> parse_scale_combos("log-linear linear-log-turbo")
    [('log', 'linear', 'plasma'), ('linear', 'log', 'turbo')]
    """
    spec = spec.strip()
    if not spec or spec.lower() == "all":
        return list(DEFAULT_SCALE_COMBOS)
    combos = []
    for token in spec.split():
        parts = token.split("-")
        if len(parts) not in (2, 3) or not all(parts):
            raise ValueError(f"bad scale combo {token!r}: expected y-z or y-z-colormap")
        y, z = parts[0], parts[1]
        if y not in ("linear", "log") or z not in ("linear", "log"):
            raise ValueError(f"bad scale combo {token!r}: scales must be linear|log")
        combos.append((y, z, parts[2] if len(parts) == 3 else _COMBO_COLORMAPS[y, z]))
    return combos


# ---------------------------------------------------------------------------
# Module-level process targets (spawn-picklable, as in the reference).
# ---------------------------------------------------------------------------


def download_in_process(years: list[int], instruments: list[str], data_folder: str) -> None:
    """Process target: download *years* of FAST CDFs for *instruments*."""
    from configurable_spectrograms_tpu.data.download import download_cdf_files_threaded

    download_cdf_files_threaded(years=years, instruments=set(instruments), data_folder=data_folder)


def plot_in_process(
    data_folder: str,
    output_base: str,
    combos: list[tuple[str, str, str]],
    max_processing_percentile: float | None,
    cusp_marker_style: str,
    override_plots: bool,
) -> None:
    """Process target: run the batch driver for each scale combo."""
    from configurable_spectrograms_tpu.fast.batch_directory import FAST_plot_spectrograms_directory

    for y_scale, z_scale, colormap in combos:
        FAST_plot_spectrograms_directory(
            data_folder,
            output_base=output_base,
            y_scale=y_scale,
            z_scale=z_scale,
            colormap=colormap,
            use_tqdm=True,
            max_processing_percentile=max_processing_percentile,
            cusp_marker_style=cusp_marker_style,
            override_plots=override_plots,
        )


def single_in_process(
    mode: str,
    output_path: str,
    data_folder: str | None = None,
    orbit: int | None = None,
    cdf_file: str | None = None,
    y_scale: str = "linear",
    z_scale: str = "linear",
    colormap: str = "viridis",
    cusp_marker_style: str = "both",
    instrument_files: dict[str, str] | None = None,
    date: str | None = None,
) -> None:
    """Process target: render one single-day figure.

    All four sources of the reference GUI's single-day page
    (reference GUI_batch_download_plot_FAST.py:1449-2031): ``pitch-angle``
    (one CDF file), ``instrument-grid`` (folder + orbit), ``files``
    (explicit per-instrument file map), and ``date`` (download that day's
    CDFs first).
    """
    import single_plot_FAST_spectrograms as single

    style = (y_scale, z_scale, colormap, cusp_marker_style)
    if mode == "pitch-angle":
        ok = single.render_single_pitch_angle_grid(cdf_file, output_path, *style)
    elif mode == "files":
        ok = single.render_single_instrument_grid_from_files(instrument_files or {}, output_path, *style)
    elif mode == "date":
        ok = single.render_single_day_downloaded(
            date, output_path, data_folder=data_folder or "./FAST_data/",
            y_scale=y_scale, z_scale=z_scale, colormap=colormap,
            cusp_marker_style=cusp_marker_style,
        )
    else:
        ok = single.render_single_instrument_grid(data_folder, orbit, output_path, *style)
    if not ok:
        raise SystemExit(1)


class ProgressTail:
    """Stream batch progress into a front-end by tailing the progress JSON.

    The drivers persist their state to disk every ``flush_batch_size``
    completions (the reference's cadence); polling that file gives both
    front-ends live progress without any new IPC -- the replacement for
    the reference's Qt progress signals
    (reference GUI_batch_download_plot_FAST.py:736-743).
    """

    def __init__(self, path: str, on_progress, interval: float = 1.0):
        self.path = path
        self.on_progress = on_progress
        self.interval = interval
        self._stop = threading.Event()
        self._last = None

    def start(self) -> "ProgressTail":
        threading.Thread(target=self._run, daemon=True, name="progress-tail").start()
        return self

    def stop(self) -> None:
        self._stop.set()

    def _poll_once(self) -> None:
        import json
        import os

        if not os.path.exists(self.path):
            return
        try:
            with open(self.path) as f:
                state = json.load(f)
        except Exception:
            return  # mid-write or malformed; next poll wins
        summary = self._summarize(state)
        if summary and summary != self._last:
            self._last = summary
            self.on_progress(summary)

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            self._poll_once()
        self._poll_once()  # final read so the last flush is never missed

    @staticmethod
    def _summarize(state: dict) -> str:
        parts = []
        for key, value in state.items():
            if key.endswith("_last_orbit"):
                parts.append(f"{key.removesuffix('_last_orbit')} @ orbit {value}")
            elif key == "completed_items" and isinstance(value, list):
                parts.append(f"{len(value)} completed")
            elif key == "errors" and isinstance(value, list) and value:
                parts.append(f"{len(value)} errors")
        return "; ".join(parts)


@dataclass
class ActionRunner:
    """Run a process target in a child process with stop support.

    The QThread+Process pattern from the reference
    (reference GUI_batch_download_plot_FAST.py:733-998) distilled: start a
    ``multiprocessing.Process``, join it from a monitor thread, surface
    finished/stopped/error via callbacks, and ``stop()`` kills the child.
    """

    target: callable
    args: tuple = ()
    kwargs: dict = field(default_factory=dict)
    on_finished: callable = lambda: None
    on_error: callable = lambda code: None
    _proc: multiprocessing.Process | None = field(default=None, init=False)
    _watcher: threading.Thread | None = field(default=None, init=False)
    _stopped: bool = field(default=False, init=False)

    def start(self) -> None:
        self._proc = multiprocessing.Process(target=self.target, args=self.args, kwargs=self.kwargs)
        self._proc.start()
        self._watcher = threading.Thread(target=self._watch, daemon=True)
        self._watcher.start()

    def _watch(self) -> None:
        assert self._proc is not None
        self._proc.join()
        if self._stopped:
            return
        if self._proc.exitcode == 0:
            self.on_finished()
        else:
            self.on_error(self._proc.exitcode)

    def stop(self) -> None:
        self._stopped = True
        if self._proc is not None and self._proc.is_alive():
            self._proc.kill()
            self._proc.join()

    def wait(self) -> int | None:
        if self._proc is not None:
            # Join the watcher, not the process: two threads joining one
            # child race on reaping it, and the loser reads exit code None.
            self._watcher.join()
            return self._proc.exitcode
        return None


# ---------------------------------------------------------------------------
# Terminal front-end
# ---------------------------------------------------------------------------


def _prompt(text: str, default: str) -> str:
    raw = input(f"{text} [{default}]: ").strip()
    return raw or default


def run_tui() -> int:
    print("FAST spectrograms — download / plot / single day")
    while True:
        print("\n1) Download CDFs   2) Batch plot   3) Single day   q) Quit")
        choice = input("> ").strip().lower()
        if choice == "q":
            return 0
        if choice == "1":
            years = [int(y) for y in _prompt("Years (space-separated)", "2000").split()]
            instruments = _prompt("Instruments", "ees eeb ies ieb").split()
            folder = _prompt("Data folder", "./FAST_data/")
            runner = ActionRunner(download_in_process, (years, instruments, folder))
            runner.start()
            print("Downloading... Ctrl-C to stop.")
            _wait_interruptible(runner)
        elif choice == "2":
            folder = _prompt("Data folder", "./FAST_data/")
            out = _prompt("Output folder", "./FAST_plots/")
            pct = _prompt("Max processing percentile (blank = raw only)", "99")
            try:
                combos = parse_scale_combos(_prompt("Scale combos (all | y-z[-cmap] ...)", "all"))
            except ValueError as exc:
                print(f"  {exc}")
                continue
            cusp = _prompt("Cusp marker style (line | bracket | both)", "both")
            runner = ActionRunner(
                plot_in_process,
                (folder, out, combos, float(pct) if pct else None, cusp, False),
            )
            runner.start()
            print("Plotting... Ctrl-C to stop.")
            from configurable_spectrograms_tpu.fast.constants import FAST_PLOTTING_PROGRESS_JSON

            tail = ProgressTail(FAST_PLOTTING_PROGRESS_JSON,
                                lambda s: print(f"  [progress] {s}")).start()
            try:
                _wait_interruptible(runner)
            finally:
                tail.stop()
        elif choice == "3":
            mode = _prompt("Mode (pitch-angle | instrument-grid | files | date)", "instrument-grid")
            out = _prompt("Output PNG", "./single.png")
            try:
                (y_scale, z_scale, cmap), = parse_scale_combos(
                    _prompt("Style y-z[-cmap]", "linear-linear")
                )
            except ValueError as exc:
                print(f"  {exc}")
                continue
            cusp = _prompt("Cusp marker style (line | bracket | both)", "both")
            style = dict(y_scale=y_scale, z_scale=z_scale, colormap=cmap, cusp_marker_style=cusp)
            if mode == "pitch-angle":
                cdf = _prompt("CDF file", "")
                runner = ActionRunner(single_in_process, (mode, out), dict(cdf_file=cdf, **style))
            elif mode == "files":
                print("Per-instrument CDF files (blank path to skip an instrument):")
                files = {}
                for inst in ("ees", "eeb", "ies", "ieb"):
                    path = _prompt(f"  {inst} file", "")
                    if path:
                        files[inst] = path
                runner = ActionRunner(
                    single_in_process, (mode, out), dict(instrument_files=files, **style)
                )
            elif mode == "date":
                date = _prompt("Date (YYYY-MM-DD)", "2001-01-01")
                folder = _prompt("Download folder", "./FAST_data/")
                runner = ActionRunner(
                    single_in_process, (mode, out), dict(data_folder=folder, date=date, **style)
                )
            else:
                folder = _prompt("Data folder", "./FAST_data/")
                orbit = int(_prompt("Orbit", "0"))
                runner = ActionRunner(
                    single_in_process, (mode, out), dict(data_folder=folder, orbit=orbit, **style)
                )
            runner.start()
            _wait_interruptible(runner)
        else:
            print("Unknown choice.")


def _wait_interruptible(runner: ActionRunner) -> None:
    try:
        code = runner.wait()
        print("Done." if code == 0 else f"Exited with code {code}.")
    except KeyboardInterrupt:
        runner.stop()
        print("\nStopped.")


# ---------------------------------------------------------------------------
# Qt front-end (only when PySide6 is installed)
# ---------------------------------------------------------------------------


#: Token-substituted stylesheet applied per OS color scheme (the
#: reference's dark/light theming pattern, reference
#: GUI_batch_download_plot_FAST.py:337-397).  CST_GUI_THEME=dark|light|none
#: overrides detection.
_THEME_CSS = """
QWidget {{ background: {bg}; color: {fg}; }}
QLineEdit {{ background: {field}; color: {fg}; border: 1px solid {border};
             border-radius: 3px; padding: 3px; }}
QPushButton {{ background: {accent}; color: {accent_fg}; border: none;
               border-radius: 4px; padding: 6px 14px; }}
QPushButton:hover {{ background: {accent_hover}; }}
QTabBar::tab {{ background: {field}; color: {fg}; padding: 6px 12px; }}
QTabBar::tab:selected {{ background: {accent}; color: {accent_fg}; }}
QPushButton#navBtn {{ background: transparent; color: {fg}; border: none;
                      border-radius: 8px; }}
QPushButton#navBtn[selected="true"] {{ background: {accent};
                                       color: {accent_fg}; }}
QPushButton#chip {{ background: {field}; color: {fg};
                    border: 1px solid {border}; border-radius: 12px;
                    padding: 4px 12px; }}
QPushButton#chip[selected="true"] {{ background: {accent};
                                     color: {accent_fg};
                                     border-color: {accent}; }}
"""

_THEMES = {
    "dark": dict(bg="#1e1f22", fg="#e8e8e8", field="#2b2d31", border="#3c3f44",
                 accent="#3574f0", accent_fg="#ffffff", accent_hover="#4a83f2"),
    "light": dict(bg="#f7f7f7", fg="#1f1f1f", field="#ffffff", border="#c8c8c8",
                  accent="#2f6fde", accent_fg="#ffffff", accent_hover="#4681e4"),
}


def _apply_os_theme(app) -> None:
    """Style the app after the OS color scheme (override: CST_GUI_THEME)."""
    import os

    choice = os.environ.get("CST_GUI_THEME", "").lower()
    if choice == "none":
        return
    if choice not in _THEMES:
        try:
            from PySide6.QtCore import Qt
            from PySide6.QtGui import QGuiApplication

            scheme = QGuiApplication.styleHints().colorScheme()
            choice = "dark" if scheme == Qt.ColorScheme.Dark else "light"
        except Exception:
            choice = "light"
    app.setStyleSheet(_THEME_CSS.format(**_THEMES[choice]))


def run_qt() -> int:
    from PySide6.QtCore import QObject, Qt, Signal
    from PySide6.QtGui import QFont
    from PySide6.QtWidgets import (
        QApplication,
        QFileDialog,
        QHBoxLayout,
        QLabel,
        QLineEdit,
        QPushButton,
        QSizePolicy,
        QSlider,
        QStackedWidget,
        QVBoxLayout,
        QWidget,
    )

    class NavButton(QPushButton):
        """Sidebar navigation tile: a glyph above a short label, with a
        ``selected`` Qt property driving stylesheet highlighting (the
        reference's NavButton, reference
        GUI_batch_download_plot_FAST.py:1001-1065; the reference tints a
        Material-icon pixmap -- here a text glyph stands in, since this
        environment ships no icon fonts)."""

        def __init__(self, glyph: str, label: str, parent=None):
            super().__init__(parent)
            self.setObjectName("navBtn")
            self.setCheckable(False)
            self.setSizePolicy(QSizePolicy.Expanding, QSizePolicy.Fixed)
            self.setFixedHeight(64)
            lay = QVBoxLayout(self)
            lay.setContentsMargins(0, 6, 0, 6)
            lay.setSpacing(2)
            lay.setAlignment(Qt.AlignCenter)
            self._icon_label = QLabel(glyph)
            self._icon_label.setAlignment(Qt.AlignCenter)
            self._icon_label.setAttribute(Qt.WA_TransparentForMouseEvents)
            self._text_label = QLabel(label)
            self._text_label.setAlignment(Qt.AlignCenter)
            self._text_label.setFont(QFont("Inter", 10, QFont.Medium))
            self._text_label.setAttribute(Qt.WA_TransparentForMouseEvents)
            lay.addWidget(self._icon_label)
            lay.addWidget(self._text_label)

        def set_selected(self, selected: bool) -> None:
            self.setProperty("selected", str(selected).lower())
            self.style().unpolish(self)
            self.style().polish(self)

    class ToggleChip(QPushButton):
        """Checkable pill chip whose ``selected`` property mirrors its
        toggle state (the reference's ToggleChip, reference
        GUI_batch_download_plot_FAST.py:1068-1092)."""

        def __init__(self, text: str, parent=None):
            super().__init__(text, parent)
            self.setObjectName("chip")
            self.setCheckable(True)
            self.toggled.connect(self._on_toggle)

        def _on_toggle(self, checked: bool) -> None:
            self.setProperty("selected", "true" if checked else "false")
            self.style().unpolish(self)
            self.style().polish(self)

    class _Bridge(QObject):
        """Marshal worker-thread updates onto the GUI thread.

        ActionRunner fires callbacks from its monitor thread and
        ProgressTail from its polling thread; QWidget methods must only
        run on the GUI thread, so both route through queued signals (the
        reference's worker-signal pattern, reference
        GUI_batch_download_plot_FAST.py:736-743).
        """

        status = Signal(str)
        progress = Signal(str)

    app = QApplication(sys.argv)
    _apply_os_theme(app)
    # Shell: NavButton sidebar driving a page stack (the reference
    # MainWindow's navigation structure, reference
    # GUI_batch_download_plot_FAST.py:2032-2146).
    win = QWidget()
    win.setWindowTitle("FAST spectrograms")
    root = QHBoxLayout(win)
    nav_col = QVBoxLayout()
    stack = QStackedWidget()
    root.addLayout(nav_col)
    root.addWidget(stack)
    nav_buttons: list[NavButton] = []

    def _add_page(glyph: str, label: str, page: QWidget) -> None:
        idx = stack.addWidget(page)
        btn = NavButton(glyph, label)

        def select(_=False, i=idx, b=btn):
            stack.setCurrentIndex(i)
            for nb in nav_buttons:
                nb.set_selected(nb is b)

        btn.clicked.connect(select)
        nav_col.addWidget(btn)
        nav_buttons.append(btn)
        if idx == 0:
            btn.set_selected(True)

    state: dict[str, ActionRunner | None] = {"runner": None}

    def _percentile_slider_section(layout, entry: QLineEdit) -> None:
        """Linked noise-cutoff percentile slider + entry + hint note (the
        reference's _percentile_slider_section, reference
        GUI_batch_download_plot_FAST.py:655-698): the 0-100 slider and the
        numeric entry stay in sync both ways, and the note explains what
        the cutoff does to the shared color bounds."""
        row = QHBoxLayout()
        slider = QSlider(Qt.Horizontal)
        slider.setObjectName("percentileSlider")
        slider.setRange(0, 100)
        slider.setFixedHeight(32)
        slider.setMaximumWidth(400)
        note = QLabel()
        note.setObjectName("noteText")
        note.setWordWrap(True)

        def _note_text(value: float) -> str:
            # Reference hint wording (reference GUI:1437-1443); the value
            # always reaches the extrema pre-pass as a float -- there is no
            # disable-at-0 mode, exactly as in the reference's PlotWorker.
            return (f"Current value: {value:.1f}  — pixels above this "
                    "percentile of the data range are clipped as noise. "
                    "It is suggested to keep this above 90.")

        # The committed value survives invalid entry text (reference
        # _on_entry_changed restores self.max_processing_percentile).
        committed = {"v": 90.0}

        def _from_slider(v: int) -> None:
            committed["v"] = float(v)
            if entry.text() != str(v):
                entry.setText(str(v))
            note.setText(_note_text(float(v)))

        def _from_entry() -> None:
            # Reference semantics (reference GUI:1424-1435): keep the
            # FLOAT (99.5 stays 99.5), clamp to 0-100, restore the last
            # committed value on junk, round only the slider position, and
            # rewrite the entry as %.1f.
            try:
                v = min(100.0, max(0.0, float(entry.text().strip())))
            except ValueError:
                v = committed["v"]
            committed["v"] = v
            slider.blockSignals(True)
            slider.setValue(int(round(v)))
            slider.blockSignals(False)
            entry.setText(f"{v:.1f}")
            note.setText(_note_text(v))

        slider.valueChanged.connect(_from_slider)
        entry.editingFinished.connect(_from_entry)
        try:
            committed["v"] = min(100.0, max(0.0, float(entry.text())))
            slider.blockSignals(True)
            slider.setValue(int(round(committed["v"])))
            slider.blockSignals(False)
        except ValueError:
            pass
        note.setText(_note_text(committed["v"]))
        row.addWidget(slider)
        layout.addLayout(row)
        layout.addWidget(note)

    def _page(fields: list[tuple[str, str]], run_label: str, make_runner,
              progress_path=None, chip_fields: dict | None = None,
              percentile_field: str | None = None):
        page = QWidget()
        layout = QVBoxLayout(page)
        edits: dict[str, QLineEdit] = {}
        chip_groups: dict[str, list[ToggleChip]] = {}
        for name, options in (chip_fields or {}).items():
            # options: list (all pre-checked, the reference's instrument
            # chips) or (list, checked_set) (the year chips, reference
            # GUI:74,763-764 -- only valid 1996-2009 years are offered, so
            # the range is validated by construction).
            options, checked = (options if isinstance(options, tuple) else (options, set(options)))
            row = QHBoxLayout()
            row.addWidget(QLabel(name))
            group = []
            for opt in options:
                chip = ToggleChip(str(opt))
                chip.setChecked(str(opt) in {str(c) for c in checked})
                group.append(chip)
                row.addWidget(chip)
            chip_groups[name] = group
            layout.addLayout(row)
        for name, default in fields:
            row = QHBoxLayout()
            row.addWidget(QLabel(name))
            edit = QLineEdit(default)
            edits[name] = edit
            row.addWidget(edit)
            if "folder" in name.lower():
                btn = QPushButton("...")
                btn.clicked.connect(lambda _=None, e=edit: e.setText(QFileDialog.getExistingDirectory() or e.text()))
                row.addWidget(btn)
            elif "file" in name.lower():
                btn = QPushButton("...")
                btn.clicked.connect(
                    lambda _=None, e=edit: e.setText(QFileDialog.getOpenFileName(filter="CDF (*.cdf)")[0] or e.text())
                )
                row.addWidget(btn)
            layout.addLayout(row)
            if name == percentile_field:
                _percentile_slider_section(layout, edit)
        status = QLabel("")
        progress = QLabel("")
        bridge = _Bridge(page)  # parented: lives as long as the page
        bridge.status.connect(status.setText)
        bridge.progress.connect(progress.setText)
        run_btn = QPushButton(run_label)
        stop_btn = QPushButton("Stop")
        tail_box: dict[str, ProgressTail | None] = {"tail": None}

        def _values() -> dict[str, str]:
            values = {k: e.text() for k, e in edits.items()}
            for name, group in chip_groups.items():
                values[name] = " ".join(c.text() for c in group if c.isChecked())
            return values

        def start():
            try:
                runner = make_runner(_values())
            except (ValueError, KeyError) as exc:  # bad combo spec / number
                status.setText(f"Invalid input: {exc}")
                return
            runner.on_finished = lambda: (bridge.status.emit("Finished."), _stop_tail())
            runner.on_error = lambda code: (bridge.status.emit(f"Error (exit {code})."), _stop_tail())
            state["runner"] = runner
            runner.start()
            status.setText("Running...")
            if progress_path is not None:
                tail_box["tail"] = ProgressTail(progress_path, bridge.progress.emit).start()

        def _stop_tail():
            if tail_box["tail"] is not None:
                tail_box["tail"].stop()

        def stop():
            if state["runner"] is not None:
                state["runner"].stop()
                status.setText("Stopped.")
            _stop_tail()

        run_btn.clicked.connect(start)
        stop_btn.clicked.connect(stop)
        layout.addWidget(run_btn)
        layout.addWidget(stop_btn)
        layout.addWidget(status)
        layout.addWidget(progress)
        return page

    def _download_runner(v):
        years = [int(y) for y in v["Years"].split()]
        instruments = v["Instruments"].split()
        if not years:
            raise ValueError("select at least one year (1996-2009)")
        if not instruments:
            raise ValueError("select at least one instrument")
        return ActionRunner(download_in_process, (years, instruments, v["Data folder"]))

    _add_page(
        "\u2b07",
        "Download",
        _page(
            [("Data folder", "./FAST_data/")],
            "Download",
            _download_runner,
            chip_fields={
                "Instruments": ["ees", "eeb", "ies", "ieb"],
                # Year chips: only the FAST coverage window 1996-2009 is
                # offered (reference GUI:74 MIN_YEAR/MAX_YEAR; selectable
                # chips instead of a free-text field, reference GUI:763-764).
                "Years": ([str(y) for y in range(1996, 2010)], {"2000"}),
            },
        ),
    )
    from configurable_spectrograms_tpu.fast.constants import FAST_PLOTTING_PROGRESS_JSON

    def _style_kwargs(v):
        combos = parse_scale_combos(v.get("Style y-z[-cmap]", "linear-linear"))
        if len(combos) != 1:
            raise ValueError("single-day style takes exactly one y-z[-cmap] combo")
        y, z, cmap = combos[0]
        return dict(y_scale=y, z_scale=z, colormap=cmap,
                    cusp_marker_style=v.get("Cusp style", "both"))

    _STYLE_FIELDS = [("Style y-z[-cmap]", "linear-linear"), ("Cusp style", "both")]

    _add_page(
        "\u25a4",
        "Plot",
        _page(
            [("Data folder", "./FAST_data/"), ("Output folder", "./FAST_plots/"),
             ("Percentile", "90.0"), ("Scale combos", "all"), ("Cusp style", "both")],
            "Plot",
            lambda v: ActionRunner(
                plot_in_process,
                (v["Data folder"], v["Output folder"], parse_scale_combos(v["Scale combos"]),
                 float(v["Percentile"]) if v["Percentile"] else None, v["Cusp style"], False),
            ),
            progress_path=FAST_PLOTTING_PROGRESS_JSON,
            percentile_field="Percentile",
        ),
    )
    _add_page(
        "\u2600",
        "Single Day",
        _page(
            [("Data folder", "./FAST_data/"), ("Orbit", "0"), ("Output PNG", "./single.png"),
             *_STYLE_FIELDS],
            "Render",
            lambda v: ActionRunner(
                single_in_process,
                ("instrument-grid", v["Output PNG"]),
                dict(data_folder=v["Data folder"], orbit=int(v["Orbit"]), **_style_kwargs(v)),
            ),
        ),
    )

    def _files_runner(v):
        files = {
            inst: v[f"{inst} file"] for inst in ("ees", "eeb", "ies", "ieb") if v[f"{inst} file"]
        }
        return ActionRunner(
            single_in_process,
            ("files", v["Output PNG"]),
            dict(instrument_files=files, **_style_kwargs(v)),
        )

    _add_page(
        "\U0001f4c2",
        "From files",
        _page(
            [("ees file", ""), ("eeb file", ""), ("ies file", ""), ("ieb file", ""),
             ("Output PNG", "./single_files.png"), *_STYLE_FIELDS],
            "Render from files",
            _files_runner,
        ),
    )
    _add_page(
        "\u2220",
        "Pitch-angle",
        _page(
            [("CDF file", ""), ("Output PNG", "./single_pitch.png"), *_STYLE_FIELDS],
            "Render pitch-angle grid",
            lambda v: ActionRunner(
                single_in_process,
                ("pitch-angle", v["Output PNG"]),
                dict(cdf_file=v["CDF file"], **_style_kwargs(v)),
            ),
        ),
    )
    _add_page(
        "\U0001f4c5",
        "By date",
        _page(
            [("Date", "2001-01-01"), ("Download folder", "./FAST_data/"),
             ("Output PNG", "./single_day.png"), *_STYLE_FIELDS],
            "Download + render",
            lambda v: ActionRunner(
                single_in_process,
                ("date", v["Output PNG"]),
                dict(data_folder=v["Download folder"], date=v["Date"], **_style_kwargs(v)),
            ),
        ),
    )
    win.resize(640, 420)
    win.show()
    return app.exec()


def main() -> int:
    import os

    parser = argparse.ArgumentParser(description="FAST download/plot front-end.")
    parser.add_argument("--tui", action="store_true", help="Force the terminal front-end.")
    args = parser.parse_args()
    if not args.tui:
        if os.environ.get("CST_GUI_HEADLESS_QT") == "1":
            # Execute the Qt front-end on the structural headless stand-in
            # (environments without Qt/display; also the CI harness).
            from configurable_spectrograms_tpu.gui import headless_qt

            headless_qt.install()
            return run_qt()
        try:
            import PySide6  # noqa: F401

            return run_qt()
        except ImportError:
            print("[INFO] PySide6 not installed; using the terminal front-end.")
    return run_tui()


if __name__ == "__main__":
    try:
        sys.exit(main())
    except KeyboardInterrupt:
        print("\n[INTERRUPT] Aborted by user.")
        sys.exit(130)

"""Paced page-cache writeback for bulk PNG output (utils/writeback.py).

Archive-scale runs lose end-to-end throughput to accumulated dirty pages;
the pacer bounds the debt off the render threads.
"""

import os
import time

import numpy as np
from PIL import Image

from configurable_spectrograms_tpu.utils import writeback


def test_note_written_fsyncs_file(tmp_path):
    p = tmp_path / "a.bin"
    p.write_bytes(b"x" * 4096)
    writeback.note_written(str(p))
    # The drain thread is async; give it a moment, then the file must
    # still read back intact (fsync+fadvise must not corrupt/unlink).
    deadline = time.monotonic() + 5.0
    while writeback._state["q"] is not None and not writeback._state["q"].empty():
        assert time.monotonic() < deadline, "pacer never drained"
        time.sleep(0.01)
    assert p.read_bytes() == b"x" * 4096


def test_note_written_missing_file_is_harmless(tmp_path):
    writeback.note_written(str(tmp_path / "never-existed.png"))  # no raise


def test_disabled_by_env(tmp_path, monkeypatch):
    monkeypatch.setenv("CST_WRITEBACK_PACE", "0")
    before = writeback._state["q"]
    writeback.note_written(str(tmp_path / "x.png"))
    assert writeback._state["q"] is before  # no thread spun up


def test_save_image_routes_through_pacer(tmp_path, monkeypatch):
    from configurable_spectrograms_tpu.render.figure import save_image

    seen = []
    monkeypatch.setattr(writeback, "note_written", seen.append)
    img = Image.fromarray(np.zeros((8, 8, 3), np.uint8))
    out = str(tmp_path / "fig.png")
    save_image(img, out)
    assert seen == [out]
    assert os.path.getsize(out) > 0

"""Tests for utils: percentiles, logging, progress store."""

import json

import numpy as np
import pytest

from configurable_spectrograms_tpu.utils.logging import (
    configure_log_batch,
    flush_log_buffer,
    get_logfile_path,
    log_error,
    log_message,
    set_logfile_path,
)
from configurable_spectrograms_tpu.utils.percentiles import compute_percentile_bounds, round_extrema
from configurable_spectrograms_tpu.utils.progress import (
    ProgressStore,
    add_to_orbit_list,
    atomic_write_json,
    new_generic_progress,
)


def test_round_extrema():
    assert round_extrema(1234, "up") == 1300.0
    assert round_extrema(1234, "down") == 1200.0
    assert round_extrema(0.0123, "down") == 0.012
    assert round_extrema(0, "up") == 0.0
    assert round_extrema(-1234, "up") == -1200.0
    with pytest.raises(ValueError):
        round_extrema(5, "sideways")


def test_compute_percentile_bounds():
    m = np.array([[1.0, 2.0, 3.0, 100.0]])
    assert compute_percentile_bounds(m, 0, 100) == (1.0, 100.0)
    assert compute_percentile_bounds(m, z_min=-5.0, z_max=5.0) == (-5.0, 5.0)
    lo, hi = compute_percentile_bounds(np.array([np.nan, 1.0, 2.0, 3.0]), 0, 100)
    assert (lo, hi) == (1.0, 3.0)
    # one explicit, one percentile
    lo, hi = compute_percentile_bounds(m, 0, 100, z_min=0.5)
    assert (lo, hi) == (0.5, 100.0)


def test_buffered_logging(tmp_path):
    logfile = tmp_path / "run.log"
    set_logfile_path(str(logfile))
    configure_log_batch(100)
    try:
        log_message("hello")
        log_error("boom")
        assert not logfile.exists() or "hello" not in logfile.read_text()
        flush_log_buffer(force=True)
        text = logfile.read_text()
        assert "hello" in text
        assert "[ERROR] boom" in text
    finally:
        set_logfile_path(None)
        configure_log_batch(10)


def test_get_logfile_path_marker_reuse(tmp_path):
    marker = tmp_path / "marker.txt"
    p1 = get_logfile_path(str(tmp_path / "log"), str(marker))
    p2 = get_logfile_path(str(tmp_path / "log"), str(marker))
    assert p1 == p2
    assert marker.exists()


def test_progress_store_batched_flush(tmp_path):
    path = tmp_path / "progress.json"
    store = ProgressStore(str(path), flush_batch_size=3)
    store.load(new_generic_progress())
    store["completed_items"].append("'a'")
    store.mark_dirty()
    store.mark_dirty()
    assert not path.exists()  # below threshold
    store.mark_dirty()
    assert path.exists()  # hit threshold -> flushed
    store["last_index"] = 41
    store.mark_dirty()
    store.flush(force=True)
    on_disk = json.loads(path.read_text())
    assert on_disk["last_index"] == 41
    assert on_disk["completed_items"] == ["'a'"]
    # reload merges over defaults
    store2 = ProgressStore(str(path))
    state = store2.load(new_generic_progress())
    assert state["last_index"] == 41


def test_progress_store_none_path():
    store = ProgressStore(None)
    store.load({"x": 1})
    store["x"] = 2
    store.mark_dirty()
    store.flush(force=True)  # no-op, no crash
    assert store["x"] == 2


def test_atomic_write_json_roundtrip_and_no_litter(tmp_path):
    path = tmp_path / "state.json"
    atomic_write_json(str(path), {"a": 1, "b": [2, 3]})
    assert json.loads(path.read_text()) == {"a": 1, "b": [2, 3]}
    atomic_write_json(str(path), {"a": 2})
    assert json.loads(path.read_text()) == {"a": 2}
    # No temp files left behind on the success path.
    assert [p.name for p in tmp_path.iterdir()] == ["state.json"]


def test_atomic_write_json_failure_preserves_old_state(tmp_path, monkeypatch):
    """A crash mid-serialize must leave the previous document intact.

    The reference truncate-writes in place (reference batch_runner.py:133),
    so the same failure there corrupts the resume file; this pins the
    rebuilt store's stronger guarantee.
    """
    path = tmp_path / "state.json"
    atomic_write_json(str(path), {"orbit": 41})

    class Boom(RuntimeError):
        pass

    def exploding_dump(*a, **k):
        raise Boom("disk full mid-serialize")

    monkeypatch.setattr("configurable_spectrograms_tpu.utils.progress.json.dump", exploding_dump)
    with pytest.raises(Boom):
        atomic_write_json(str(path), {"orbit": 42})
    monkeypatch.undo()
    assert json.loads(path.read_text()) == {"orbit": 41}
    assert [p.name for p in tmp_path.iterdir()] == ["state.json"]


def test_progress_store_flush_failure_keeps_previous_file(tmp_path, monkeypatch):
    path = tmp_path / "progress.json"
    store = ProgressStore(str(path), flush_batch_size=1)
    store.load({})
    store["last_index"] = 1
    store.mark_dirty()
    assert json.loads(path.read_text())["last_index"] == 1

    real_replace = __import__("os").replace

    def failing_replace(src, dst):
        raise OSError("simulated rename failure")

    monkeypatch.setattr("configurable_spectrograms_tpu.utils.progress.os.replace", failing_replace)
    store["last_index"] = 2
    store.mark_dirty()  # flush swallows the OSError, logs, keeps going
    monkeypatch.setattr("configurable_spectrograms_tpu.utils.progress.os.replace", real_replace)
    assert json.loads(path.read_text())["last_index"] == 1
    store.flush(force=True)
    assert json.loads(path.read_text())["last_index"] == 2


def test_add_to_orbit_list():
    d = {}
    add_to_orbit_list(d, "errs", 5)
    add_to_orbit_list(d, "errs", 3)
    add_to_orbit_list(d, "errs", 5)
    assert d["errs"] == [3, 5]


def test_resident_cache_bounds_and_owner_eviction():
    """Shared cache machinery: entry/byte bounds, oversized refusal,
    owner-death eviction via the two-phase dead-owner drain."""
    import gc

    import numpy as np
    import pytest

    from configurable_spectrograms_tpu.utils.resident_cache import ResidentCache

    with pytest.raises(ValueError):
        ResidentCache()  # exactly one bound required
    with pytest.raises(ValueError):
        ResidentCache(max_entries=2, max_bytes=10)

    # Entry-count FIFO.
    c = ResidentCache(max_entries=2)
    owners = [np.zeros(4) for _ in range(3)]
    for i, o in enumerate(owners):
        assert c.insert((id(o), i), np.full(2, i), (o,)) is not None
    assert len(c) == 2 and c.get((id(owners[0]), 0)) is None  # oldest out

    # insert returns the existing winner on a racing duplicate key.
    o = owners[1]
    first = c.get((id(o), 1))
    assert c.insert((id(o), 1), np.full(2, 99), (o,)) is first

    # Byte budget: oversized entries are returned uncached.
    b = ResidentCache(max_bytes=100)
    big = np.zeros(200, np.uint8)
    assert b.insert(("big",), big, (big,)) is big
    assert len(b) == 0 and b.total_bytes == 0
    small = np.zeros(40, np.uint8)
    b.insert((id(small), "a"), small, (small,))
    b.insert((id(small), "b"), np.zeros(40, np.uint8), (small,))
    assert b.total_bytes == 80
    b.insert((id(owners[2]), "c"), np.zeros(40, np.uint8), (owners[2],))
    assert b.total_bytes <= 100 and len(b) == 2  # FIFO under the budget

    # Owner death evicts every key owned by that array.
    del small
    gc.collect()
    assert [k[1] for k in b.keys()] == ["c"]
    assert b.total_bytes == 40


def test_resident_cache_concurrent_inserts_and_owner_death():
    """Stress the two-phase owner eviction: many threads inserting while
    owners die; the ledger and key lists stay exact and nothing deadlocks."""
    import gc
    import threading

    import numpy as np

    from configurable_spectrograms_tpu.utils.resident_cache import ResidentCache

    cache = ResidentCache(max_bytes=200_000)
    errs = []

    def worker(tid):
        try:
            for i in range(60):
                owner = np.zeros(500, np.uint8)
                cache.insert((id(owner), tid, i), np.full(100, tid, np.uint8), (owner,))
                # owner dies immediately -> finalizer enqueues eviction
                del owner
                if i % 20 == 0:
                    gc.collect()
        except Exception as exc:  # noqa: BLE001
            errs.append(exc)

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(8)]
    [t.start() for t in threads]
    [t.join(timeout=60) for t in threads]
    assert not errs
    gc.collect()
    assert cache.total_bytes == sum(v.nbytes for v in cache.values())
    assert len(cache) == 0  # every owner died -> every entry evicted


def test_compile_cache_honours_jax_env_dir(tmp_path, monkeypatch):
    """With ``JAX_COMPILATION_CACHE_DIR`` set, JAX's own setting decides:
    the module sets no directory and creates none of its own."""
    import importlib

    import jax

    from configurable_spectrograms_tpu.utils import jax_setup

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "from_env"))
    monkeypatch.delenv("CST_NO_COMPILE_CACHE", raising=False)
    importlib.reload(jax_setup)
    monkeypatch.setattr(jax_setup, "DEFAULT_CACHE_DIR", str(tmp_path / "default"))
    monkeypatch.setattr(jax_setup, "_cpu_backend_selected", lambda: False)
    before = jax.config.jax_compilation_cache_dir
    try:
        jax_setup.enable_compilation_cache()
        assert jax.config.jax_compilation_cache_dir == before
        assert not (tmp_path / "default").exists()
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_default_is_fixed_repo_path(tmp_path, monkeypatch):
    """Without the JAX variable, the cache goes to one fixed path inside the
    checkout (the same path in every process, so a later one finds it)."""
    import importlib
    import os

    import jax

    from configurable_spectrograms_tpu.utils import jax_setup

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.delenv("CST_NO_COMPILE_CACHE", raising=False)
    importlib.reload(jax_setup)
    assert jax_setup.DEFAULT_CACHE_DIR == os.path.join(repo, ".jax_cache")
    monkeypatch.setattr(jax_setup, "DEFAULT_CACHE_DIR", str(tmp_path / "fixed"))
    monkeypatch.setattr(jax_setup, "_cpu_backend_selected", lambda: False)
    before = jax.config.jax_compilation_cache_dir
    try:
        jax_setup.enable_compilation_cache()
        assert jax.config.jax_compilation_cache_dir == str(tmp_path / "fixed")
        assert (tmp_path / "fixed").is_dir()
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_skipped_on_cpu_backend(tmp_path, monkeypatch):
    """XLA:CPU AOT cache loads spam mismatched-machine loader errors even
    same-machine (pseudo-features); CPU-pinned processes skip the cache."""
    import importlib

    from configurable_spectrograms_tpu.utils import jax_setup

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    importlib.reload(jax_setup)
    monkeypatch.setattr(jax_setup, "DEFAULT_CACHE_DIR", str(tmp_path / "never"))
    jax_setup.enable_compilation_cache()
    assert not (tmp_path / "never").exists()

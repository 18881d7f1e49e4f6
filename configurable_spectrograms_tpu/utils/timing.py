"""Stage timing and optional device profiling.

The reference's only observability is wall-clock ``[TIMING]`` log lines
(reference fast/process_orbit.py:198-201,261-264), which this framework
also emits.  This module adds the device-side equivalents SURVEY.md section 5
calls for: a :class:`StageTimer` for named host/device stages and a
:func:`device_trace` context manager wrapping ``jax.profiler.trace`` so a
batch run can drop an XPlane trace viewable in TensorBoard/XProf.
"""

from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass, field

from configurable_spectrograms_tpu.utils.logging import log_message


@dataclass
class StageTimer:
    """Accumulate named stage durations and log a ``[TIMING]`` summary.

    >>> t = StageTimer("demo")
    >>> with t.stage("load"):
    ...     pass
    >>> sorted(t.totals) == ["load"]
    True
    """

    name: str
    totals: dict[str, float] = field(default_factory=dict)
    counts: dict[str, int] = field(default_factory=dict)
    #: Instrumented stages run in batch worker threads; unlocked
    #: read-modify-writes would silently drop increments under contention,
    #: corrupting the very numbers the budget tool measures.
    lock: threading.Lock = field(default_factory=threading.Lock)

    @contextlib.contextmanager
    def stage(self, stage_name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.add(stage_name, dt)

    def add(self, stage_name: str, dt: float) -> None:
        with self.lock:
            self.totals[stage_name] = self.totals.get(stage_name, 0.0) + dt
            self.counts[stage_name] = self.counts.get(stage_name, 0) + 1

    def log_summary(self) -> None:
        parts = ", ".join(
            f"{k}={self.totals[k]:.3f}s/{self.counts[k]}x" for k in sorted(self.totals)
        )
        log_message(f"[TIMING] {self.name}: {parts}")


@contextlib.contextmanager
def device_trace(log_dir: str | None):
    """Wrap a block in ``jax.profiler.trace`` when *log_dir* is given.

    A ``None`` log_dir is a no-op, so call sites can thread an optional
    ``--profile-dir`` flag straight through.
    """
    if log_dir is None:
        yield
        return
    import jax

    with jax.profiler.trace(log_dir):
        yield


# ---------------------------------------------------------------------------
# process-wide stage accounting (opt-in; zero-cost when inactive)
# ---------------------------------------------------------------------------

#: When set (tools/budget_figure.py does), hot-path seams record their
#: stage durations here so an end-to-end run yields a per-stage budget
#: (VERDICT round-1 item 3).  ``None`` (the default) keeps production
#: renders free of timing overhead beyond one attribute check.
ACTIVE: StageTimer | None = None


@contextlib.contextmanager
def active_stage(stage_name: str):
    """Record into the process-wide :data:`ACTIVE` timer when one is set."""
    timer = ACTIVE
    if timer is None:
        yield
        return
    with timer.stage(stage_name):
        yield

"""Host-compute concurrency gate for feeder-thread pools.

The device backend sizes its feeder pool for OVERLAP: threads that wait
on the link/chip release the GIL, so more threads than cores pay off
while device work is in flight.  But the host-CPU-bound stages those
same threads run -- compositing, PNG encode -- degrade under
oversubscription: on a small box, several threads of pure host work run
slower than one (GIL handoffs + concurrent ~35 MB canvases thrashing the
cache).  The reference
never faced this split: its process pool ran one figure per process end
to end (reference fast/batch_directory.py:337).

This gate bounds CONCURRENT HOST COMPUTE to the visible core count
without shrinking the pool: feeder threads still overlap device waits
freely (the gate is never held across a dispatch/readback wait -- see
:func:`gate_released`), but at most ``cores`` of them run a host-compute
section at once -- excess threads park on the semaphore instead of
thrashing.

Parking must cover the WHOLE figure render, not just its biggest
stages: a gated composite still loses ~25% wall time when sibling
threads run ungated Python between their own gated sections, because
every GIL handoff steals real time from the gate holder (measured on a
1-core box: 4 warm feeder threads at 215 panels/s vs 241 single-thread
with only composite/encode gated).  So the gate is RE-ENTRANT -- an
outer ``host_compute_gate()`` spanning the full render makes the inner
per-stage gates free -- and :func:`gate_released` drops the held slot
around the one genuinely blocking section (the coalesced device render
wait), preserving the cold-path overlap the wide pool exists for.

``CST_HOST_COMPUTE_GATE`` overrides the slot count; ``0`` disables.
"""

from __future__ import annotations

import functools
import os
import threading
from contextlib import contextmanager

_LOCK = threading.Lock()
_GATE: threading.BoundedSemaphore | None = None
_GATE_SLOTS = 0
#: Per-thread re-entrancy depth: only depth 0 -> 1 acquires the slot, so
#: nested gates (render_figures wrapping the per-figure composite gate)
#: never self-deadlock on a 1-slot semaphore.
_TLS = threading.local()


def _visible_cores() -> int:
    try:
        return max(1, len(os.sched_getaffinity(0)))
    except (AttributeError, OSError):  # pragma: no cover - non-Linux
        return max(1, os.cpu_count() or 1)


def _slots() -> int:
    try:
        return int(os.environ.get("CST_HOST_COMPUTE_GATE", _visible_cores()))
    except ValueError:
        return _visible_cores()


@contextmanager
def host_compute_gate():
    """Bound this block's concurrency to the visible core count.

    Wrap CPU-bound sections only; never hold across a device wait --
    inside an already-gated scope, bracket the wait with
    :func:`gate_released` instead.  Re-entrant per thread: nested gates
    are free.  A zero/negative slot count disables gating entirely.
    """
    global _GATE, _GATE_SLOTS
    n = _slots()
    if n <= 0:
        yield
        return
    depth = getattr(_TLS, "depth", 0)
    if depth:
        # Already holding a slot (an outer gate spans this section).
        _TLS.depth = depth + 1
        try:
            yield
        finally:
            _TLS.depth = depth
        return
    with _LOCK:
        if _GATE is None or _GATE_SLOTS != n:
            _GATE = threading.BoundedSemaphore(n)
            _GATE_SLOTS = n
        gate = _GATE
    with gate:
        _TLS.depth = 1
        _TLS.gate = gate
        try:
            yield
        finally:
            _TLS.depth = 0
            _TLS.gate = None


def gated(fn):
    """Run *fn* under :func:`host_compute_gate` (re-entrant, so free when
    the caller already holds a slot).  For host-compute-only entry points
    -- figure builders, encoders -- whose ungated Python would otherwise
    steal GIL slices from a sibling thread's gated render."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with host_compute_gate():
            return fn(*args, **kwargs)

    return wrapper


@contextmanager
def gate_released():
    """Temporarily yield this thread's held compute-gate slot.

    Brackets a genuinely blocking wait (the coalesced render's device
    drain) inside a gated scope: the slot is released so sibling feeder
    threads can compute while this one blocks, and re-acquired -- on the
    SAME semaphore object, even if the slot count was retuned meanwhile
    -- before the gated work resumes.  No-op when the thread holds no
    slot.
    """
    depth = getattr(_TLS, "depth", 0)
    gate = getattr(_TLS, "gate", None)
    if not depth or gate is None:
        yield
        return
    _TLS.depth = 0
    _TLS.gate = None
    gate.release()
    try:
        yield
    finally:
        gate.acquire()
        _TLS.depth = depth
        _TLS.gate = gate

"""One-time JAX runtime configuration (persistent compilation cache).

Every fresh CLI process otherwise pays the full XLA compile for the render
programs; the persistent cache lets a later process load them instead.

* ``JAX_COMPILATION_CACHE_DIR`` set: JAX reads it itself, and this module
  sets no directory.
* Otherwise the cache lives at one fixed path inside the checkout,
  :data:`DEFAULT_CACHE_DIR` (``<repo>/.jax_cache``, git-ignored): the path
  is part of what a later process must find again, so it never moves.
* ``CST_NO_COMPILE_CACHE=1`` disables the cache entirely.
"""

from __future__ import annotations

import os

_done = False

#: Fixed cache location used when ``JAX_COMPILATION_CACHE_DIR`` is unset.
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), ".jax_cache"
)


def _cpu_backend_selected() -> bool:
    """True when this process is pinned to the XLA:CPU backend.

    XLA:CPU persists AOT machine code whose compile-time feature string
    includes tuning pseudo-features (``+prefer-no-scatter`` /
    ``+prefer-no-gather``) that the host-feature detector never reports,
    so EVERY warm cache load on CPU spams "machine type doesn't match /
    could lead to SIGILL" loader errors -- even for a cache this same
    machine wrote.  CPU compiles are local LLVM and fast, so CPU processes
    simply skip the cache.
    """
    env = os.environ.get("JAX_PLATFORMS", "").strip().lower()
    if env == "cpu":
        return True
    try:
        import jax

        cfg = getattr(jax.config, "jax_platforms", None)
        return (cfg or "").strip().lower() == "cpu"
    except Exception:  # pragma: no cover - defensive
        return False


def enable_compilation_cache() -> None:
    """Idempotently point JAX at the on-disk compilation cache."""
    global _done
    if _done or os.environ.get("CST_NO_COMPILE_CACHE") == "1":
        _done = True
        return
    _done = True
    if _cpu_backend_selected():
        return
    try:
        import jax

        if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
            os.makedirs(DEFAULT_CACHE_DIR, exist_ok=True)
            jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    except Exception:
        # Cacheless operation is always correct, just slower to start.
        pass

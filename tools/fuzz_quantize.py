"""Deep offline fuzz of host-vs-device quantize parity.

Runs the same seeded differential check as ``tests/test_fuzz_parity.py``
(bit-identical idx/metadata/RGBA between the numpy host path and the
jitted XLA program, mirroring reference plotting.make_spectrogram's
normalize pipeline, /root/reference/src/configurable_spectrograms/plotting.py)
over an arbitrary seed range -- CI keeps 32 seeds; this tool sweeps
thousands overnight/between milestones and prints one line per failure.

Usage::

    python tools/fuzz_quantize.py --start 32 --count 4000

Exit status 0 when every seed agrees, 1 otherwise.
"""

from __future__ import annotations

import argparse
import os
import sys
import traceback

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for p in (_REPO, os.path.join(_REPO, "tests")):
    if p not in sys.path:
        sys.path.insert(0, p)

# Force the CPU backend BEFORE jax initializes: the sweep must not claim an
# accelerator another process is using, and CPU is faster for these tiny
# per-seed programs anyway.
os.environ.setdefault("JAX_PLATFORMS", "cpu")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--start", type=int, default=32)
    ap.add_argument("--count", type=int, default=4000)
    ap.add_argument("--progress-every", type=int, default=250)
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")

    import test_fuzz_parity as tfp

    failures = 0
    for seed in range(args.start, args.start + args.count):
        try:
            tfp.test_fuzz_host_vs_device_quantize(seed)
        except Exception:
            failures += 1
            print(f"FAIL seed={seed}")
            traceback.print_exc(limit=4)
        done = seed - args.start + 1
        if done % 200 == 0:
            # Every seed compiles a fresh program (unique static shapes);
            # unbounded jit caches exhaust the LLVM execution engine's
            # allocator around ~800 programs (observed segfault).  The
            # host-side ResidentCaches self-evict on owner death.
            jax.clear_caches()
        if args.progress_every and done % args.progress_every == 0:
            print(f"... {done}/{args.count} seeds, {failures} failures", flush=True)
    print(f"done: {args.count} seeds, {failures} failures")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())

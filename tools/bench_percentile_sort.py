#!/usr/bin/env python
"""Measure the percentile-bounds sort's share of device figure compute.

Percentile-bounds panels (the raw half of every flagship batch) select
order statistics per panel on device (ops/spectrogram.py
masked_nanpercentile); explicit-bounds panels skip it.  This tool times,
on the accelerator with a two-point on-device fori_loop protocol (a short
and a long chain of the same program; the difference over the extra
repetitions is the per-call device time):

* the explicit-bounds collapse+quantize chain (sort-free),
* the percentile-bounds chain (sort included),
* and, when implemented, the top_k selection alternative.

The difference is the sort's cost; its share of the percentile chain
decides whether a sort-free device selection is worth building (>10%
threshold).  Prints one JSON line.
"""

from __future__ import annotations

import functools
import json
import os
import sys
import time

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)

T, A, E = 8192, 64, 128
REPS = 256


def _time_chain(make_fn, cube, mask, e_valid) -> float:
    """Two-point on-device fori_loop timing (see the module docstring)."""
    import jax
    import jax.numpy as jnp

    @functools.partial(jax.jit, static_argnames=("n",))
    def chain(c, m, ev, qs, n):
        def body(i, acc):
            out = make_fn(c, m, ev, qs[i])
            return acc + jnp.sum(out[:8].astype(jnp.float32))

        return jax.lax.fori_loop(0, n, body, jnp.float32(0.0))

    qs = jnp.asarray(np.stack([[1.0 + 1e-3 * i, 99.0 - 1e-3 * i] for i in range(REPS)],
                              dtype=np.float32))
    n_short, n_long = 8, REPS

    def run(n):
        t0 = time.perf_counter()
        float(np.asarray(chain(cube, mask, e_valid, qs, n)))
        return time.perf_counter() - t0

    run(n_short)
    run(n_long)
    short = min(run(n_short) for _ in range(3))
    long = min(run(n_long) for _ in range(3))
    return max((long - short) / (n_long - n_short), 1e-9)


def main() -> int:
    import jax
    import jax.numpy as jnp

    from configurable_spectrograms_tpu.ops.spectrogram import (
        collapse_cube,
        masked_nanpercentile,
    )

    rng = np.random.default_rng(7)
    cube = (rng.random((T, A, E)) * 1e4).astype(np.float32)
    cube[rng.random(cube.shape) < 0.05] = np.nan
    cube_d = jax.device_put(jnp.asarray(cube))
    mask = jax.device_put(jnp.ones(A, bool))
    e_valid = jax.device_put(jnp.ones(E, bool))

    def explicit_chain(c, m, ev, q):
        mat = collapse_cube(c, m, jnp.int32(T))
        norm = (mat - q[0]) / (q[1] - q[0])
        return jnp.clip(jnp.floor(norm * 256.0), 0, 255).reshape(-1)[:64]

    def percentile_chain(c, m, ev, q):
        mat = collapse_cube(c, m, jnp.int32(T))
        valid = ~jnp.isnan(mat) & ev[None, :]
        vmin = masked_nanpercentile(mat, valid, q[0])
        vmax = masked_nanpercentile(mat, valid, q[1])
        norm = (mat - vmin) / (vmax - vmin)
        return jnp.clip(jnp.floor(norm * 256.0), 0, 255).reshape(-1)[:64]

    def sort_only(c, m, ev, q):
        mat = collapse_cube(c, m, jnp.int32(T))
        valid = ~jnp.isnan(mat) & ev[None, :]
        vmin = masked_nanpercentile(mat, valid, q[0])
        return jnp.asarray([vmin] * 64)

    chains = {
        "explicit_ms": explicit_chain,
        "percentile_ms": percentile_chain,
        "one_sort_ms": sort_only,
    }
    try:
        from configurable_spectrograms_tpu.ops.spectrogram import masked_nanpercentile_topk

        def topk_chain(c, m, ev, q):
            mat = collapse_cube(c, m, jnp.int32(T))
            valid = ~jnp.isnan(mat) & ev[None, :]
            vmin = masked_nanpercentile_topk(mat, valid, float(1.0), side="low")
            vmax = masked_nanpercentile_topk(mat, valid, float(99.0), side="high")
            norm = (mat - vmin) / (vmax - vmin)
            return jnp.clip(jnp.floor(norm * 256.0), 0, 255).reshape(-1)[:64]

        chains["topk_ms"] = topk_chain
    except ImportError:
        pass

    out = {"shape": [T, A, E], "device": str(jax.devices()[0])}
    for name, fn in chains.items():
        out[name] = round(1e3 * _time_chain(fn, cube_d, mask, e_valid), 4)
    out["sort_pair_ms"] = round(out["percentile_ms"] - out["explicit_ms"], 4)
    out["sort_share_of_percentile_chain"] = round(
        out["sort_pair_ms"] / out["percentile_ms"], 4
    )
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    from configurable_spectrograms_tpu.cli.common import clean_exit

    clean_exit(main())

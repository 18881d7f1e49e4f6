#!/usr/bin/env python
"""Time the two STFT device programs (``fft`` and ``matmul``) on the accelerator.

The audio front end computes its windowed short-time transform either with
XLA's rFFT or with two window-folded DFT-basis matmuls at
``Precision.HIGHEST`` (``ops/stft.py``).  This tool times both at
representative audio sizes and prints one JSON line per shape, with the
device it ran on.  Times are the median of ``--repeats`` warm calls, each
ended by ``block_until_ready``.

    python tools/bench_stft.py [--repeats 20]
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time

# Allow `python tools/<name>.py` without a manual PYTHONPATH: the repo
# root (the package's parent) precedes any site installs.
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)


def bench_one(n_samples: int, frame_length: int, hop_length: int, repeats: int) -> dict:
    import jax
    import numpy as np

    from configurable_spectrograms_tpu.ops.stft import stft_magnitude

    rng = np.random.default_rng(0)
    x = jax.device_put(rng.standard_normal(n_samples).astype(np.float32))
    dev = jax.devices()[0]
    out = {
        "n_samples": n_samples,
        "frame_length": frame_length,
        "hop_length": hop_length,
        "platform": dev.platform,
        "device_kind": dev.device_kind,
    }
    for method in ("fft", "matmul"):
        def fn():
            return stft_magnitude(x, frame_length=frame_length, hop_length=hop_length, method=method)

        fn().block_until_ready()  # compile + warm
        times = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            fn().block_until_ready()
            times.append(time.perf_counter() - t0)
        out[f"{method}_ms_median"] = statistics.median(times) * 1e3
        out[f"{method}_ms_min"] = min(times) * 1e3
    return out


def main() -> int:
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("--repeats", type=int, default=20)
    args = parser.parse_args()
    # 60 s of 22.05 kHz audio at librosa's defaults, and 10 s / 60 s of
    # 44.1 kHz audio at a shorter frame.
    shapes = ((1_323_000, 2048, 512), (441_000, 1024, 256), (2_646_000, 1024, 256))
    for n, fl, hop in shapes:
        print(json.dumps(bench_one(n, fl, hop, args.repeats)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""GPU-accelerated configurable spectrogram engine.

A ground-up rebuild of the capabilities of ev-hansen/Configurable-Spectrograms
for an accelerator (an NVIDIA GPU; the CPU also runs it): the spectrogram
math (pitch-angle masking, nansum collapse, percentile color bounds,
log/linear normalization, extent resampling, and colormap-LUT
rasterization) runs as fused, jittable JAX device code, batches of orbits are vmapped and
sharded over a ``jax.sharding.Mesh``, and folder-wide extrema passes are
device-side collective reductions.  Host-side code handles CDF decoding,
figure composition (PIL), progress-JSON resume, and CLI entry points.

Layer map (mirrors reference SURVEY.md section 1):

* L0  ``utils``            -- logging, progress store, percentile helpers
* L1  ``data``             -- CDF reader/writer, orbit discovery, downloader
* L2  ``ops`` + ``render`` -- device rasterization kernels + host compositing
* L3  ``batch_runner`` / ``generic_batch`` / ``parallel`` -- batch engines
* L4  ``fast``             -- FAST mission layer
* L5  ``cli``              -- command-line entry points

The public API mirrors the reference's:
``make_spectrogram``, ``generic_plot_spectrogram_set``,
``generic_plot_multirow_optional_zoom``, ``generic_batch_plot``,
``run_batch``, ``FAST_plot_pitch_angle_grid``, ``FAST_plot_instrument_grid``,
``FAST_process_single_orbit``, ``FAST_plot_spectrograms_directory``,
``compute_global_extrema``, ``load_fast_cdf_dataset``, and the download
functions.
"""

import os as _os

# numpy >= 1.22 madvise(MADV_HUGEPAGE)s every >=4 MB allocation.  On hosts
# with transparent_hugepage=madvise, that routes each fresh figure canvas /
# collapse buffer through 2 MB-page allocation, whose latency under memory
# fragmentation is erratic (measured here: the quantize stage intermittently
# 77 ms -> 570 ms per figure; A/B-stable 2.2x end-to-end with it off).  The
# pipeline reuses its large buffers (canvas pool, thread-local encoder
# scratch), so huge pages buy little; default them off unless the user set
# the knob themselves.  The runtime setter covers interpreters where
# numpy was already imported (e.g. by sitecustomize) before this package.
# Embedders that do not want an import to touch process-global allocator
# state can opt out with CST_HUGEPAGE_TUNING=0 (the override also never
# runs when NUMPY_MADVISE_HUGEPAGE is already set by the user).
if (
    _os.environ.get("CST_HUGEPAGE_TUNING", "1") != "0"
    and "NUMPY_MADVISE_HUGEPAGE" not in _os.environ
):
    _os.environ["NUMPY_MADVISE_HUGEPAGE"] = "0"
    try:
        from numpy._core import multiarray as _ma  # numpy >= 2
    except ImportError:  # pragma: no cover - numpy 1.x
        try:
            from numpy.core import multiarray as _ma
        except ImportError:
            _ma = None
    if _ma is not None:
        try:
            _ma._set_madvise_hugepage(False)
        except (AttributeError, TypeError):  # pragma: no cover
            pass
    del _ma
del _os

__version__ = "0.1.0"

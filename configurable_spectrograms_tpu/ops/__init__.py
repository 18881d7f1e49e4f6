"""Device-side (JAX/XLA) spectrogram math.

Everything here is jittable with static shapes, vmappable across panels,
and runnable on a GPU or the virtual CPU mesh used in tests.  The op set
mirrors what the reference does with numpy + matplotlib per panel
(reference plotting.py:92-389): pitch-category masked nansum collapse,
NaN-column/energy-range masking, percentile color bounds, log/linear
normalization with safe floors, imshow-style extent resampling, and
colormap-LUT rasterization to RGBA.
"""

from configurable_spectrograms_tpu.utils.jax_setup import enable_compilation_cache as _enable_cache

_enable_cache()

from configurable_spectrograms_tpu.ops._colormap_data import AVAILABLE_COLORMAPS, colormap_lut
from configurable_spectrograms_tpu.ops.spectrogram import (
    RenderSpec,
    collapse_cube,
    masked_nanpercentile,
    quantize_matrix,
    render_matrix,
    render_panels,
)

__all__ = [
    "AVAILABLE_COLORMAPS",
    "colormap_lut",
    "RenderSpec",
    "collapse_cube",
    "masked_nanpercentile",
    "quantize_matrix",
    "render_matrix",
    "render_panels",
]

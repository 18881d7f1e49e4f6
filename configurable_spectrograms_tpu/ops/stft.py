"""Audio STFT / mel-spectrogram front-end feeding the spectrogram rasterizer.

New capability beyond the reference (BASELINE.json configs[4]): a windowed
FFT front-end producing (time, 1, freq) cubes that flow through the exact
same collapse/percentile/normalize/resample/LUT pipeline as FAST ESA data.
Device mapping: framing is a strided gather, the window is a fused
elementwise multiply, the FFT lowers to XLA's FFT (cuFFT on a GPU), and the
mel projection is a single (frames x n_fft/2+1) @ (n_fft/2+1 x n_mels)
matmul.  Every matmul asks for ``Precision.HIGHEST``: a float32 product may
otherwise run in TF32 on a GPU's tensor cores, which keeps about three
decimal digits.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def hann_window(length: int) -> np.ndarray:
    """Periodic Hann window (the STFT convention)."""
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(length) / length)).astype(np.float32)


def frame_signal(x: jax.Array, frame_length: int, hop_length: int) -> jax.Array:
    """Slice a 1D signal into overlapping frames: (N,) -> (F, frame_length)."""
    n = x.shape[0]
    num_frames = max(0, 1 + (n - frame_length) // hop_length)
    starts = jnp.arange(num_frames) * hop_length
    idx = starts[:, None] + jnp.arange(frame_length)[None, :]
    return x[idx]


@functools.lru_cache(maxsize=8)
def _dft_bases(frame_length: int) -> tuple[np.ndarray, np.ndarray]:
    """Windowed real-DFT basis matrices (L, L//2+1) float32.

    The Hann window is folded into the bases, so the framed signal goes
    straight into two matmuls with no separate window multiply pass.
    """
    n = np.arange(frame_length, dtype=np.float64)[:, None]
    k = np.arange(frame_length // 2 + 1, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * n * k / frame_length
    w = hann_window(frame_length).astype(np.float64)[:, None]
    return (np.cos(ang) * w).astype(np.float32), (-np.sin(ang) * w).astype(np.float32)


@functools.partial(jax.jit, static_argnames=("frame_length", "hop_length", "power", "method"))
def stft_magnitude(
    x: jax.Array,
    frame_length: int = 1024,
    hop_length: int = 256,
    power: float = 2.0,
    method: str = "fft",
) -> jax.Array:
    """Windowed-FFT magnitude spectrogram: (N,) -> (frames, n_fft//2 + 1).

    Two equivalent device programs (same math, different hardware units):

    - ``"fft"``: window multiply + XLA's rFFT.
    - ``"matmul"``: the framed signal times two window-folded DFT basis
      matrices, one (F, L) @ (L, L//2+1) pair -- O(L) more FLOPs than the
      FFT, in float32 at ``Precision.HIGHEST``.
    """
    frames = frame_signal(jnp.asarray(x, jnp.float32), frame_length, hop_length)
    if method == "matmul":
        cos_b, sin_b = _dft_bases(frame_length)
        hi = jax.lax.Precision.HIGHEST
        re = jnp.dot(frames, jnp.asarray(cos_b), precision=hi, preferred_element_type=jnp.float32)
        im = jnp.dot(frames, jnp.asarray(sin_b), precision=hi, preferred_element_type=jnp.float32)
        p2 = re * re + im * im
        if power == 2.0:
            return p2
        mag = jnp.sqrt(p2)
        return mag if power == 1.0 else jnp.power(mag, power)
    if method != "fft":
        raise ValueError(f"unknown stft method {method!r} (expected 'fft' or 'matmul')")
    windowed = frames * jnp.asarray(hann_window(frame_length))
    spec = jnp.fft.rfft(windowed, axis=-1)
    mag = jnp.abs(spec)
    return mag if power == 1.0 else jnp.power(mag, power)


def hz_to_mel(f: np.ndarray | float) -> np.ndarray:
    """HTK mel scale: ``2595 * log10(1 + f/700)``."""
    return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)


def mel_to_hz(m: np.ndarray | float) -> np.ndarray:
    return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)


def mel_filterbank(
    n_mels: int,
    n_fft: int,
    sample_rate: float,
    fmin: float = 0.0,
    fmax: float | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Triangular HTK mel filterbank.

    Returns ``(weights (n_fft//2+1, n_mels) float32, center_freqs (n_mels,))``.
    """
    if fmax is None:
        fmax = sample_rate / 2.0
    n_freq = n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, sample_rate / 2.0, n_freq)
    mel_pts = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts)
    weights = np.zeros((n_freq, n_mels), np.float32)
    for m in range(n_mels):
        lo, ctr, hi = hz_pts[m], hz_pts[m + 1], hz_pts[m + 2]
        up = (fft_freqs - lo) / max(ctr - lo, 1e-9)
        down = (hi - fft_freqs) / max(hi - ctr, 1e-9)
        weights[:, m] = np.maximum(0.0, np.minimum(up, down))
    return weights, hz_pts[1:-1].astype(np.float32)


@functools.partial(
    jax.jit, static_argnames=("frame_length", "hop_length", "power", "n_mels", "sample_rate", "method")
)
def mel_spectrogram(
    x: jax.Array,
    sample_rate: int,
    frame_length: int = 1024,
    hop_length: int = 256,
    n_mels: int = 128,
    power: float = 2.0,
    method: str = "fft",
) -> jax.Array:
    """Mel spectrogram: (N,) -> (frames, n_mels) via one matmul."""
    mag = stft_magnitude(
        x, frame_length=frame_length, hop_length=hop_length, power=power, method=method
    )
    weights, _ = mel_filterbank(n_mels, frame_length, float(sample_rate))
    return jnp.dot(
        mag, jnp.asarray(weights), precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32,
    )


def host_stft_magnitude(
    x: np.ndarray, frame_length: int = 1024, hop_length: int = 256, power: float = 2.0
) -> np.ndarray:
    """Numpy mirror of :func:`stft_magnitude` (``method="fft"`` math).

    The host backend's STFT and the device paths' parity reference -- same
    framing, periodic Hann window, and rFFT semantics.
    """
    x = np.asarray(x, np.float32)
    n = x.shape[0]
    num_frames = max(0, 1 + (n - frame_length) // hop_length)
    starts = np.arange(num_frames) * hop_length
    frames = x[starts[:, None] + np.arange(frame_length)[None, :]]
    mag = np.abs(np.fft.rfft(frames * hann_window(frame_length), axis=-1)).astype(np.float32)
    return mag if power == 1.0 else np.power(mag, np.float32(power))


def audio_spectrogram_dataset(
    signal: np.ndarray,
    sample_rate: int,
    frame_length: int = 1024,
    hop_length: int = 256,
    n_mels: int | None = None,
    power: float = 2.0,
    label: str | None = None,
    method: str = "fft",
) -> dict:
    """Build a ``generic_plot_spectrogram_set`` dataset dict from audio.

    The (frames, freq) device spectrogram becomes a (time, 1, freq) cube so
    it flows through the standard pipeline; ``x`` is frame-center seconds
    (``x_is_unix=False`` at plot time), ``y`` is Hz (FFT bins) or mel
    center frequencies.  Follows the render backend: ``host`` computes in
    numpy; ``device`` computes on the accelerator and raises if the
    dispatch exceeds its watchdog; ``auto`` falls back to numpy then.
    """
    from configurable_spectrograms_tpu.render.figure import (
        _BACKEND,
        _bounded_call,
        _dispatch_timeout,
        _host_backend_active,
        probe_device_link,
    )

    if method not in ("fft", "matmul"):
        # Validate up front so a typo fails identically on both backends
        # (the host fallback always computes fft math).
        raise ValueError(f"unknown stft method {method!r} (expected 'fft' or 'matmul')")
    probe_device_link()
    weights = None
    if n_mels is not None:
        weights, centers = mel_filterbank(n_mels, frame_length, float(sample_rate))
        freqs = centers
    else:
        freqs = np.linspace(0.0, sample_rate / 2.0, frame_length // 2 + 1).astype(np.float32)

    def _host():
        spec = host_stft_magnitude(signal, frame_length, hop_length, power)
        return spec @ weights if weights is not None else spec

    if _host_backend_active():
        spec_np = _host()
    else:

        def _device():
            x = jnp.asarray(np.asarray(signal, np.float32))
            if n_mels is not None:
                spec = mel_spectrogram(x, sample_rate, frame_length, hop_length, n_mels, power, method)
            else:
                spec = stft_magnitude(x, frame_length, hop_length, power, method)
            return np.asarray(spec)

        # Same watchdog as the render/extrema transfers: a hung readback
        # would otherwise block the CLI forever.
        timeout = _dispatch_timeout()
        ok, spec_np = _bounded_call(_device, timeout)
        if not ok:
            if _BACKEND["mode"] == "device":
                raise RuntimeError(
                    f"audio STFT dispatch/readback exceeded {timeout:.0f}s "
                    "(CST_DEVICE_DISPATCH_TIMEOUT) with CST_RENDER_BACKEND=device"
                )
            from configurable_spectrograms_tpu.utils.logging import log_error

            log_error(
                "[BACKEND] audio STFT dispatch/readback timed out; computing "
                "on the host instead"
            )
            spec_np = _host()
    frames = spec_np.shape[0]
    times = (np.arange(frames) * hop_length + frame_length / 2) / float(sample_rate)
    return {
        "x": times,
        "y": freqs,
        "data": spec_np[:, None, :],
        "label": label or ("Mel spectrogram" if n_mels else "STFT spectrogram"),
        "x_label": "Time (s)",
        "y_label": "Frequency (Hz)",
        "z_label": "Power",
    }

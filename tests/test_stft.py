"""Tests for the audio STFT/mel front-end."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from configurable_spectrograms_tpu.ops.stft import (  # noqa: E402
    audio_spectrogram_dataset,
    frame_signal,
    hann_window,
    hz_to_mel,
    mel_filterbank,
    mel_spectrogram,
    mel_to_hz,
    stft_magnitude,
)


def test_frame_signal():
    x = np.arange(10, dtype=np.float32)
    frames = np.asarray(frame_signal(x, 4, 2))
    assert frames.shape == (4, 4)
    np.testing.assert_array_equal(frames[0], [0, 1, 2, 3])
    np.testing.assert_array_equal(frames[1], [2, 3, 4, 5])


def test_stft_pure_tone_peak():
    rate, n = 8000, 8000
    freq = 1000.0
    t = np.arange(n) / rate
    sig = np.sin(2 * np.pi * freq * t).astype(np.float32)
    mag = np.asarray(stft_magnitude(sig, frame_length=512, hop_length=128, power=2.0))
    assert mag.shape[1] == 257
    peak_bin = mag.mean(axis=0).argmax()
    peak_freq = peak_bin * rate / 512
    assert abs(peak_freq - freq) < rate / 512  # within one bin


def test_stft_matches_numpy():
    rng = np.random.default_rng(3)
    sig = rng.normal(size=2048).astype(np.float32)
    L, H = 256, 64
    got = np.asarray(stft_magnitude(sig, L, H, power=1.0))
    w = hann_window(L)
    for f in [0, 5, got.shape[0] - 1]:
        seg = sig[f * H : f * H + L] * w
        ref = np.abs(np.fft.rfft(seg))
        np.testing.assert_allclose(got[f], ref, rtol=1e-4, atol=1e-4)


def test_mel_scale_roundtrip():
    f = np.array([0.0, 440.0, 8000.0])
    np.testing.assert_allclose(mel_to_hz(hz_to_mel(f)), f, rtol=1e-9)


def test_mel_filterbank_shapes_and_coverage():
    w, centers = mel_filterbank(40, 512, 16000.0)
    assert w.shape == (257, 40)
    assert centers.shape == (40,)
    assert np.all(np.diff(centers) > 0)
    assert w.sum() > 0 and np.all(w >= 0)


def test_mel_spectrogram_shape_and_energy():
    rate = 16000
    t = np.arange(rate) / rate
    sig = np.sin(2 * np.pi * 440.0 * t).astype(np.float32)
    mel = np.asarray(mel_spectrogram(sig, rate, frame_length=512, hop_length=256, n_mels=40))
    assert mel.shape[1] == 40
    _, centers = mel_filterbank(40, 512, rate)
    peak_center = centers[mel.mean(axis=0).argmax()]
    assert 300 < peak_center < 650  # band containing 440 Hz


def test_audio_dataset_renders(tmp_path):
    from configurable_spectrograms_tpu.render.plotting import generic_plot_spectrogram_set

    rate = 8000
    t = np.arange(rate // 2) / rate
    sig = np.sin(2 * np.pi * (500 + 1500 * t) * t).astype(np.float32)  # chirp
    ds = audio_spectrogram_dataset(sig, rate, frame_length=256, hop_length=128)
    assert ds["data"].shape[1] == 1  # singleton collapse axis
    fig, _ = generic_plot_spectrogram_set(
        [ds], x_is_unix=False, z_scale="log", colormap="magma",
        y_min=float(ds["y"][0]), y_max=float(ds["y"][-1]),
    )
    assert fig is not None
    out = tmp_path / "audio.png"
    fig.savefig(str(out), dpi=50)
    assert out.exists()


def test_wav_cli_roundtrip(tmp_path):
    import wave

    import single_plot_audio_spectrogram as cli

    rate = 8000
    t = np.arange(rate) / rate
    sig = (np.sin(2 * np.pi * 660 * t) * 0.5 * 32767).astype(np.int16)
    wav = str(tmp_path / "tone.wav")
    with wave.open(wav, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(sig.tobytes())
    loaded, r = cli.load_wav(wav)
    assert r == rate and abs(loaded).max() <= 0.5 + 1e-3
    out = str(tmp_path / "tone.png")
    assert cli.render_audio_spectrogram(wav, out, n_mels=32)
    from PIL import Image

    assert Image.open(out).size[0] > 0


def test_stft_matmul_matches_fft():
    """The DFT-matmul program agrees with the rFFT program across
    powers and frame lengths (same math, different hardware units)."""
    rng = np.random.default_rng(7)
    sig = rng.normal(size=4096).astype(np.float32)
    for L, H in ((256, 64), (512, 128)):
        for power in (1.0, 2.0):
            a = np.asarray(stft_magnitude(sig, L, H, power=power, method="fft"))
            b = np.asarray(stft_magnitude(sig, L, H, power=power, method="matmul"))
            assert a.shape == b.shape
            scale = np.abs(a).max()
            np.testing.assert_allclose(a, b, atol=5e-4 * scale, rtol=1e-3)


def test_stft_unknown_method_raises():
    with pytest.raises(ValueError, match="unknown stft method"):
        stft_magnitude(np.zeros(512, np.float32), 256, 64, method="welch")


def test_mel_spectrogram_method_passthrough():
    rng = np.random.default_rng(11)
    sig = rng.normal(size=4096).astype(np.float32)
    a = np.asarray(mel_spectrogram(sig, 16000, 256, 64, n_mels=32, method="fft"))
    b = np.asarray(mel_spectrogram(sig, 16000, 256, 64, n_mels=32, method="matmul"))
    scale = np.abs(a).max()
    np.testing.assert_allclose(a, b, atol=5e-4 * scale, rtol=1e-3)


def test_host_stft_matches_device(rng):
    """The numpy STFT fallback mirrors the device fft path within float32
    tolerance, for both raw-bin and mel datasets."""
    from configurable_spectrograms_tpu.ops.stft import (
        host_stft_magnitude,
        mel_filterbank,
        stft_magnitude,
    )

    sig = rng.normal(size=8000).astype(np.float32)
    dev = np.asarray(stft_magnitude(sig, 512, 128, 2.0, "fft"))
    host = host_stft_magnitude(sig, 512, 128, 2.0)
    assert dev.shape == host.shape
    np.testing.assert_allclose(host, dev, rtol=2e-4, atol=1e-3)
    weights, _ = mel_filterbank(24, 512, 8000.0)
    np.testing.assert_allclose(host @ weights, dev @ weights, rtol=2e-4, atol=1e-3)


def test_audio_dataset_host_fallback(rng, monkeypatch):
    """A forced-host backend routes the audio dataset through the numpy
    STFT (no device dispatch that could hang on a dead link)."""
    from configurable_spectrograms_tpu.ops import stft as stft_mod
    from configurable_spectrograms_tpu.render import figure

    monkeypatch.setitem(figure._BACKEND, "mode", "host")
    calls = {"n": 0}
    orig = stft_mod.host_stft_magnitude

    def counting(*a, **k):
        calls["n"] += 1
        return orig(*a, **k)

    monkeypatch.setattr(stft_mod, "host_stft_magnitude", counting)
    sig = rng.normal(size=4000).astype(np.float32)
    ds = stft_mod.audio_spectrogram_dataset(sig, 8000, frame_length=256, hop_length=128, n_mels=16)
    assert calls["n"] == 1
    assert ds["data"].shape[2] == 16 and ds["data"].shape[1] == 1


def test_audio_dataset_rejects_bad_method_on_both_backends(rng, monkeypatch):
    from configurable_spectrograms_tpu.ops import stft as stft_mod
    from configurable_spectrograms_tpu.render import figure

    sig = rng.normal(size=1000).astype(np.float32)
    for mode in ("host", "device"):
        monkeypatch.setitem(figure._BACKEND, "mode", mode)
        with pytest.raises(ValueError, match="unknown stft method"):
            stft_mod.audio_spectrogram_dataset(sig, 8000, method="bogus")


def test_audio_dataset_hung_device_falls_back(rng, monkeypatch):
    """Under the opt-in ``auto`` backend, a device STFT that hangs mid-run
    falls back to the numpy path."""
    import time

    from configurable_spectrograms_tpu.ops import stft as stft_mod
    from configurable_spectrograms_tpu.render import figure

    monkeypatch.setitem(figure._BACKEND, "mode", "auto")
    monkeypatch.setitem(figure._BACKEND, "forced_host", False)
    monkeypatch.setitem(figure._BACKEND, "probed", True)
    monkeypatch.setenv("CST_DEVICE_DISPATCH_TIMEOUT", "1")
    monkeypatch.setattr(stft_mod, "stft_magnitude", lambda *a, **k: time.sleep(600))
    sig = rng.normal(size=2000).astype(np.float32)
    t0 = time.monotonic()
    ds = stft_mod.audio_spectrogram_dataset(sig, 8000, frame_length=256, hop_length=128)
    assert time.monotonic() - t0 < 60
    expected = stft_mod.host_stft_magnitude(sig, 256, 128, 2.0)
    np.testing.assert_array_equal(ds["data"][:, 0, :], expected)


def test_audio_dataset_hung_device_raises_under_device_backend(rng, monkeypatch):
    """Under ``device`` (the default backend) a hung STFT dispatch raises
    instead of quietly computing on the host."""
    import time

    from configurable_spectrograms_tpu.ops import stft as stft_mod
    from configurable_spectrograms_tpu.render import figure

    monkeypatch.setitem(figure._BACKEND, "mode", "device")
    monkeypatch.setitem(figure._BACKEND, "forced_host", False)
    monkeypatch.setenv("CST_DEVICE_DISPATCH_TIMEOUT", "1")
    monkeypatch.setattr(stft_mod, "stft_magnitude", lambda *a, **k: time.sleep(600))
    sig = rng.normal(size=2000).astype(np.float32)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="CST_RENDER_BACKEND=device"):
        stft_mod.audio_spectrogram_dataset(sig, 8000, frame_length=256, hop_length=128)
    assert time.monotonic() - t0 < 60


def _tone_plus_noise(n: int) -> np.ndarray:
    rng = np.random.default_rng(0)
    t = np.arange(n) / 22050.0
    return (np.sin(2 * np.pi * 440.0 * t) + 0.1 * rng.standard_normal(n)).astype(np.float32)


#: Scale-relative bound for float32 STFTs against numpy's rFFT at real
#: frame lengths.  float32 rounding over an L-term sum stays near 1e-6 of
#: the spectrum's peak; a TF32 matmul (about three decimal digits) would
#: miss it by two orders of magnitude, so this also pins HIGHEST precision.
STFT_REL_TOL = 1e-5


@pytest.mark.parametrize("method", ["fft", "matmul"])
@pytest.mark.parametrize("power", [1.0, 2.0])
@pytest.mark.parametrize("n_fft", [512, 1024, 2048])
def test_stft_methods_match_numpy_at_real_frame_lengths(n_fft, power, method):
    """Both device programs agree with the numpy STFT at the frame lengths
    audio users run (librosa's default is n_fft 2048, hop 512)."""
    from configurable_spectrograms_tpu.ops.stft import host_stft_magnitude, stft_magnitude

    x = _tone_plus_noise(22050 * 2)
    ref = host_stft_magnitude(x, n_fft, n_fft // 4, power)
    got = np.asarray(stft_magnitude(x, n_fft, n_fft // 4, power, method))
    assert got.shape == ref.shape == (1 + (x.size - n_fft) // (n_fft // 4), n_fft // 2 + 1)
    assert np.max(np.abs(got - ref)) <= STFT_REL_TOL * np.max(np.abs(ref))


def test_stft_matmul_requests_highest_precision():
    """The DFT matmuls and the mel projection ask for HIGHEST precision, so a
    GPU never runs them in TF32."""
    import jax

    from configurable_spectrograms_tpu.ops.stft import mel_spectrogram, stft_magnitude

    x = np.zeros(4096, np.float32)
    for fn in (
        lambda v: stft_magnitude(v, 512, 128, 2.0, "matmul"),
        lambda v: mel_spectrogram(v, 22050, 512, 128, 32, 2.0, "fft"),
    ):
        jaxpr = str(jax.make_jaxpr(fn)(x))
        assert "dot_general" in jaxpr
        assert "precision=None" not in jaxpr and "HIGHEST" in jaxpr

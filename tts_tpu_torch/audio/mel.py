"""Mel filterbank + window construction (numpy, done once at init time).

Numerically equivalent to ``librosa.filters.mel`` (slaney mel scale, slaney area
normalization) which the reference audio frontend builds its mel basis with
(Mozilla TTS's TTS/utils/audio.py:89-97). librosa is not a dependency — the
filterbank is constructed from the definition.
"""

from __future__ import annotations

import numpy as np

_F_SP = 200.0 / 3.0          # slaney linear region: mels per Hz
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = np.log(6.4) / 27.0


def hz_to_mel(freq, htk: bool = False):
    freq = np.asarray(freq, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + freq / 700.0)
    mels = freq / _F_SP
    log_region = freq >= _MIN_LOG_HZ
    mels = np.where(
        log_region,
        _MIN_LOG_MEL + np.log(np.maximum(freq, _MIN_LOG_HZ) / _MIN_LOG_HZ) / _LOGSTEP,
        mels,
    )
    return mels


def mel_to_hz(mels, htk: bool = False):
    mels = np.asarray(mels, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (mels / 2595.0) - 1.0)
    freqs = _F_SP * mels
    log_region = mels >= _MIN_LOG_MEL
    freqs = np.where(
        log_region,
        _MIN_LOG_HZ * np.exp(_LOGSTEP * (np.maximum(mels, _MIN_LOG_MEL) - _MIN_LOG_MEL)),
        freqs,
    )
    return freqs


def mel_frequencies(n_mels: int, fmin: float, fmax: float, htk: bool = False):
    return mel_to_hz(np.linspace(hz_to_mel(fmin, htk), hz_to_mel(fmax, htk), n_mels), htk)


def mel_filterbank(
    sample_rate: int,
    n_fft: int,
    n_mels: int,
    fmin: float = 0.0,
    fmax: float | None = None,
    htk: bool = False,
    norm: str | None = "slaney",
    dtype=np.float32,
) -> np.ndarray:
    """Triangular mel filterbank, shape ``(n_mels, 1 + n_fft // 2)``."""
    if fmax is None:
        fmax = float(sample_rate) / 2
    n_bins = 1 + n_fft // 2
    fft_freqs = np.linspace(0.0, float(sample_rate) / 2, n_bins)
    mel_f = mel_frequencies(n_mels + 2, fmin, fmax, htk)

    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fft_freqs[None, :]

    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))

    if norm == "slaney":
        enorm = 2.0 / (mel_f[2: n_mels + 2] - mel_f[:n_mels])
        weights *= enorm[:, None]
    return weights.astype(dtype)


def hann_window(win_length: int, dtype=np.float32) -> np.ndarray:
    """Periodic Hann window (librosa/torch default, ``fftbins=True``)."""
    n = np.arange(win_length, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(dtype)


def pad_center(window: np.ndarray, size: int) -> np.ndarray:
    """Center-pad a window to ``size`` samples (librosa util.pad_center)."""
    lpad = (size - len(window)) // 2
    return np.pad(window, (lpad, size - len(window) - lpad))

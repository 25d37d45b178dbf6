"""DSP on tensors (≙ tts_tpu/audio/dsp.py), for any device: STFT and its
inverse, magnitudes and decibels, pre- and de-emphasis, spectrogram
normalization, linear and mel spectrograms, Griffin-Lim, mu-law and
quantization. Plain PyTorch with ``torch.fft``: no kernel stands behind
any of these in tts_tpu either.

Conventions are tts_tpu's (librosa's): a periodic Hann window centred in
``n_fft``, reflect padding of ``n_fft // 2`` when ``center``, and a
time-major layout, (..., frames, bins).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from tts_tpu_torch.audio import mel as _mel

Tensor = torch.Tensor


def hann(win_length: int, n_fft: int, device=None,
         dtype=torch.float32) -> Tensor:
    """The periodic Hann window of ``win_length`` centred in ``n_fft``."""
    w = _mel.pad_center(_mel.hann_window(win_length), n_fft)
    return torch.as_tensor(w, dtype=dtype, device=device)


def _frame(y: Tensor, frame_length: int, hop_length: int) -> Tensor:
    """(..., T) -> (..., n_frames, frame_length)."""
    return y.unfold(-1, frame_length, hop_length)


def stft(y: Tensor, n_fft: int, hop_length: int, win_length: int,
         window: Optional[Tensor] = None, center: bool = True,
         pad_mode: str = "reflect") -> Tensor:
    """(..., T) -> complex (..., n_frames, n_fft // 2 + 1)."""
    if window is None:
        window = hann(win_length, n_fft, y.device, y.dtype)
    if center:
        lead = y.shape[:-1]
        y = F.pad(y.reshape(-1, 1, y.shape[-1]), (n_fft // 2, n_fft // 2),
                  mode=pad_mode).reshape(*lead, -1)
    return torch.fft.rfft(_frame(y, n_fft, hop_length) * window, n=n_fft,
                          dim=-1)


def overlap_add(frames: Tensor, hop_length: int) -> Tensor:
    """(..., n_frames, n) -> (..., n + hop * (n_frames - 1)): frame l added
    at l * hop."""
    n_frames, n = frames.shape[-2:]
    idx = (torch.arange(n_frames, device=frames.device)[:, None] * hop_length
           + torch.arange(n, device=frames.device)[None, :]).reshape(-1)
    out = frames.new_zeros(frames.shape[:-2]
                           + (n + hop_length * (n_frames - 1),))
    return out.index_add(-1, idx, frames.reshape(frames.shape[:-2] + (-1,)))


def istft(spec: Tensor, n_fft: int, hop_length: int, win_length: int,
          length: Optional[int] = None, center: bool = True) -> Tensor:
    """Complex (..., n_frames, n_fft // 2 + 1) -> (..., T): windowed
    overlap-add divided by the window's summed squares (floored at 1e-10)."""
    window = hann(win_length, n_fft, spec.device, spec.real.dtype)
    frames = torch.fft.irfft(spec, n=n_fft, dim=-1) * window
    n_frames = frames.shape[-2]
    out = overlap_add(frames, hop_length)
    wss = overlap_add((window ** 2).expand(n_frames, n_fft), hop_length)
    out = out / wss.clamp_min(1e-10)
    out_len = out.shape[-1]
    if center:
        out = out[..., n_fft // 2:]
        out_len -= n_fft // 2
    if length is not None:
        return out[..., :length]
    if center:
        out = out[..., : out_len - n_fft // 2]
    return out


def magnitude(spec_complex: Tensor) -> Tensor:
    return spec_complex.abs()


def amp_to_db(x: Tensor, spec_gain: float = 20.0) -> Tensor:
    """``spec_gain * log10(max(x, 1e-5))``."""
    return spec_gain * torch.log10(x.clamp_min(1e-5))


def db_to_amp(x: Tensor, spec_gain: float = 20.0) -> Tensor:
    return torch.pow(10.0, x / spec_gain)


def preemphasis(y: Tensor, coef: float) -> Tensor:
    """y[t] - coef * y[t - 1], the first sample kept."""
    return torch.cat([y[..., :1], y[..., 1:] - coef * y[..., :-1]], dim=-1)


DEEMPHASIS_BLOCK = 512


def deemphasis(y: Tensor, coef: float) -> Tensor:
    """Inverse of :func:`preemphasis`, out[t] = y[t] + coef * out[t - 1],
    in blocks of ``DEEMPHASIS_BLOCK`` samples: inside a block a product
    with the (L, L) matrix of coef^(i - j), then the carry of the block
    before times coef^(i + 1)."""
    T = y.shape[-1]
    L = min(DEEMPHASIS_BLOCK, T)
    i = torch.arange(L, device=y.device, dtype=torch.float64)
    expo = i[:, None] - i[None, :]
    powers = torch.where(expo >= 0, coef ** expo.clamp_min(0), 0.0)
    M = powers.to(y.dtype)                                # (L, L)
    carry_w = (coef ** (i + 1)).to(y.dtype)               # (L,)
    n_blocks = -(-T // L)
    x = F.pad(y, (0, n_blocks * L - T)).unflatten(-1, (n_blocks, L))
    local = x @ M.T                                       # zero carry
    out, carry = [], torch.zeros_like(local[..., 0, 0])
    for b in range(n_blocks):
        blk = local[..., b, :] + carry[..., None] * carry_w
        out.append(blk)
        carry = blk[..., -1]
    return torch.cat(out, dim=-1)[..., :T]


def normalize_spectrogram(s_db: Tensor, *, min_level_db: float,
                          max_norm: float, symmetric: bool,
                          clip: bool) -> Tensor:
    s_norm = (s_db - min_level_db) / (-min_level_db)
    if symmetric:
        s_norm = 2.0 * max_norm * s_norm - max_norm
        return s_norm.clamp(-max_norm, max_norm) if clip else s_norm
    s_norm = max_norm * s_norm
    return s_norm.clamp(0.0, max_norm) if clip else s_norm


def denormalize_spectrogram(s_norm: Tensor, *, min_level_db: float,
                            max_norm: float, symmetric: bool,
                            clip: bool) -> Tensor:
    if symmetric:
        if clip:
            s_norm = s_norm.clamp(-max_norm, max_norm)
        return ((s_norm + max_norm) * -min_level_db / (2 * max_norm)
                + min_level_db)
    if clip:
        s_norm = s_norm.clamp(0.0, max_norm)
    return s_norm * -min_level_db / max_norm + min_level_db


def linear_spectrogram(y: Tensor, n_fft: int, hop_length: int,
                       win_length: int) -> Tensor:
    """(..., T) -> magnitudes (..., n_frames, n_fft // 2 + 1)."""
    return magnitude(stft(y, n_fft, hop_length, win_length))


def mel_spectrogram(y: Tensor, mel_basis: Tensor, n_fft: int,
                    hop_length: int, win_length: int) -> Tensor:
    """(..., T) -> mel magnitudes (..., n_frames, n_mels); mel_basis
    (n_mels, n_bins)."""
    return linear_spectrogram(y, n_fft, hop_length, win_length) @ mel_basis.T


def griffin_lim(mag: Tensor, n_fft: int, hop_length: int, win_length: int,
                n_iter: int = 60, generator: Optional[torch.Generator] = None,
                angles: Optional[Tensor] = None) -> Tensor:
    """Phases for magnitudes (..., n_frames, n_bins) -> waveform (..., T).
    The first phases are ``angles`` (unit complex numbers) or uniform from
    ``generator``, by default one seeded 0 (tts_tpu's ``PRNGKey(0)``)."""
    if angles is None:
        if generator is None:
            generator = torch.Generator(mag.device).manual_seed(0)
        u = torch.rand(mag.shape, generator=generator,
                       device=generator.device)
        angles = torch.polar(torch.ones_like(u), 2 * np.pi * u).to(mag.device)
    cmag = mag.to(torch.complex64)
    for _ in range(n_iter):
        rebuilt = stft(istft(cmag * angles, n_fft, hop_length, win_length),
                       n_fft, hop_length, win_length)
        angles = rebuilt / rebuilt.abs().clamp_min(1e-16)
    return istft(cmag * angles, n_fft, hop_length, win_length)


def mulaw_encode(y: Tensor, qc: int) -> Tensor:
    mu = qc - 1
    signal = torch.sign(y) * torch.log1p(mu * y.abs()) / np.log1p(mu)
    return torch.floor((signal + 1) / 2 * mu + 0.5)


def mulaw_decode(y: Tensor, qc: int) -> Tensor:
    mu = qc - 1
    x = y / mu * 2.0 - 1.0
    return torch.sign(x) * torch.expm1(x.abs() * np.log1p(mu)) / mu


def quantize(y: Tensor, bits: int) -> Tensor:
    return ((y + 1.0) * (2 ** bits - 1) / 2).clamp(0, 2 ** bits - 1)


def dequantize(y: Tensor, bits: int) -> Tensor:
    return 2 * y / (2 ** bits - 1) - 1

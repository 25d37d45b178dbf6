"""STFT magnitude for the GAN spectral losses (≙ tts_tpu/ops/pallas/
stft_kernel.py: ``_dft_banks``, ``_frames``, ``_stft_mag_frames`` with its
VJP, ``stft_magnitude``).

|STFT| is a product of the frames with window-folded cosine and sine DFT
banks, then sqrt(re^2 + im^2 + 1e-12). ``stft_magnitude`` frames the signal
(librosa's center/reflect padding) and runs ``StftMagnitudeFrames``: its
forward is the hand-written kernel (``ops/cuda/stft_mag.cu``) for a CUDA
tensor and the plain version ``stft_magnitude_torch`` for a CPU tensor;
its backward is tts_tpu's analytic one, recomputing re and im, in plain
matmuls on either device (tts_tpu computes it in XLA, outside any Pallas
kernel).

The kernel computes the same function from the window and the half-banks
of ``half_banks``: it folds each windowed frame by the DFT's real-input
symmetry (k <-> n_fft - k), after one radix-2 step where n_fft is a
multiple of 64, and multiplies in 3xTF32 on the tensor cores (see its
source).
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from tts_tpu_torch.audio import mel as _mel
from tts_tpu_torch.ops.cuda import stft_mag as stft_cuda

_EPS = 1e-12


@functools.lru_cache(maxsize=None)
def _dft_banks_np(n_fft: int, win_length: int) -> Tuple[np.ndarray, np.ndarray]:
    window = _mel.pad_center(_mel.hann_window(win_length), n_fft)
    k = np.arange(n_fft)[:, None]
    f = np.arange(n_fft // 2 + 1)[None, :]
    ang = 2.0 * np.pi * k * f / n_fft
    wr = (np.cos(ang) * window[:, None]).astype(np.float32)
    wi = (-np.sin(ang) * window[:, None]).astype(np.float32)
    return wr, wi


@functools.lru_cache(maxsize=None)
def dft_banks(n_fft: int, win_length: int, device: torch.device
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Window-folded real-DFT banks (n_fft, n_fft // 2 + 1), float32, on
    ``device``: the periodic Hann window of ``win_length`` centered in
    n_fft, times cos and -sin."""
    return tuple(torch.from_numpy(b).to(device)
                 for b in _dft_banks_np(n_fft, win_length))


BANK_TILE = 128  # half-banks are padded to a multiple of the kernel's tiles


def radix2(n_fft: int) -> bool:
    """Whether the kernel takes one radix-2 step first (n_fft a multiple
    of 64: 2048, 1024, 512 and 384 of the losses' resolutions), as
    ``stft_mag_forward`` in ``ops/cuda/stft_mag.cu`` decides; the kernel
    refuses banks smaller than its path needs."""
    return n_fft % 64 == 0


def fold_size(n_fft: int) -> int:
    """The length of the kernel's folded products (their depth and bins):
    n_fft / 4 on the radix-2 path (the sub-DFTs of size n_fft / 2, their
    middle samples taken apart), else n_fft / 2 for even n_fft (the middle
    sample and the Nyquist bin taken apart), n_fft // 2 + 1 for odd."""
    if radix2(n_fft):
        return n_fft // 4
    return n_fft // 2 if n_fft % 2 == 0 else n_fft // 2 + 1


@functools.lru_cache(maxsize=None)
def _half_banks_np(n_fft: int, win_length: int
                   ) -> Tuple[np.ndarray, np.ndarray]:
    window = _mel.pad_center(_mel.hann_window(win_length), n_fft)
    G = fold_size(n_fft)
    size = n_fft // 2 if radix2(n_fft) else n_fft    # the DFTs folded
    P = -(-G // BANK_TILE) * BANK_TILE
    jf = np.arange(G)[:, None] * np.arange(G)[None, :] % size
    ang = 2.0 * np.pi * jf / size
    banks = np.zeros((2, P, P), np.float32)
    banks[0, :G, :G] = np.cos(ang)
    banks[1, :G, :G] = np.where(jf == 0, 0.0, -np.sin(ang))
    return window.astype(np.float32), banks


@functools.lru_cache(maxsize=None)
def half_banks(n_fft: int, win_length: int, device: torch.device
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's operands besides the frames, float32 on ``device``: the
    periodic Hann window of ``win_length`` centred in n_fft, and (2, P, P)
    = C[j, f] = cos(2 pi j f / D) and S[j, f] = -sin(2 pi j f / D) for
    j, f < ``fold_size(n_fft)``, zero beyond (P a multiple of
    ``BANK_TILE``); D = n_fft / 2 on the radix-2 path, else n_fft."""
    return tuple(torch.from_numpy(b).to(device)
                 for b in _half_banks_np(n_fft, win_length))


def frames(y: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """(..., T) -> (..., n_frames, n_fft), reflect-padded by n_fft // 2 on
    both sides (librosa's center=True)."""
    lead, T = y.shape[:-1], y.shape[-1]
    p = n_fft // 2
    padded = F.pad(y.reshape(-1, 1, T), (p, p), mode="reflect")[:, 0]
    out = padded.unfold(-1, n_fft, hop)
    return out.reshape(*lead, out.shape[1], n_fft)


def stft_magnitude_torch(frames2d: torch.Tensor, wr: torch.Tensor,
                         wi: torch.Tensor) -> torch.Tensor:
    """The plain version of the kernel: (N, n_fft) frames -> (N, bins)."""
    re = frames2d @ wr
    im = frames2d @ wi
    return torch.sqrt(re * re + im * im + _EPS)


class StftMagnitudeFrames(torch.autograd.Function):
    """|DFT| of each row of ``frames2d`` (N, n_fft), float32, with tts_tpu's
    analytic backward: d|z| = (re dre + im dim) / max(|z|, 1e-7)."""

    @staticmethod
    def forward(ctx, frames2d: torch.Tensor, n_fft: int, win_length: int):
        if frames2d.device.type == "cpu":
            mag = stft_magnitude_torch(
                frames2d, *dft_banks(n_fft, win_length, frames2d.device))
        else:
            mag = stft_cuda.stft_mag_cuda(
                frames2d, *half_banks(n_fft, win_length, frames2d.device))
        ctx.save_for_backward(frames2d, mag)
        ctx.banks = (n_fft, win_length)
        return mag

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        frames2d, mag = ctx.saved_tensors
        wr, wi = dft_banks(*ctx.banks, frames2d.device)
        # re and im recomputed (two matmuls) rather than stored
        re = frames2d @ wr
        im = frames2d @ wi
        scale = g / mag.clamp_min(1e-7)
        dframes = (scale * re) @ wr.T + (scale * im) @ wi.T
        return dframes, None, None


def stft_magnitude(y: torch.Tensor, n_fft: int, hop_length: int,
                   win_length: int) -> torch.Tensor:
    """|STFT(y)|: float32 (..., T) -> (..., n_frames, n_fft // 2 + 1)."""
    fr = frames(y, n_fft, hop_length)
    mag = StftMagnitudeFrames.apply(fr.reshape(-1, n_fft).contiguous(),
                                    n_fft, win_length)
    return mag.reshape(*fr.shape[:-1], mag.shape[-1])

"""iSTFT-head MelGAN generator (≙ tts_tpu/models/vocoder/istft_melgan.py:
``istft_head`` and ``ISTFTMelganGenerator``), in (B, C, T) layout.

The conv body is the MelGAN generator's (``melgan.generator_layers``: the
same module tree and key names, ``layers.N``, with the output conv
predicting ``n_fft_head // 2 + 1`` log-magnitudes and as many phases);
it stops at 1 / ``hop_head`` of the audio rate, and a closed-form inverse
STFT gives the last factor: a matmul with the real irfft basis, then a
stride-``hop_head`` overlap-add (``conv_transpose1d`` with the windowed
identity) divided by the window's summed squares. The head runs in float32
whatever the body's dtype, as tts_tpu's (a bfloat16 spectrum times its
float32 basis promotes to float32 there).
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tts_tpu_torch.audio import mel as _mel
from tts_tpu_torch.models.vocoder.melgan import generator_layers

Tensor = torch.Tensor


@lru_cache(maxsize=None)
def istft_constants(n_fft: int, device: torch.device
                    ) -> Tuple[Tensor, Tensor, Tensor]:
    """(basis (2 * bins, n_fft), overlap-add weight (n_fft, 1, n_fft),
    squared window (1, n_fft, 1)) in float32 on ``device``: all depend on
    n_fft alone, so one copy serves every hop and length."""
    bins = n_fft // 2 + 1
    n = np.arange(n_fft)
    k = np.arange(bins)[:, None]
    # irfft(a + ib)[n] = 1/N sum_k w_k (a_k cos(2 pi k n / N)
    #                                   - b_k sin(2 pi k n / N)),
    # w_k = 1 for DC and Nyquist, 2 between (the hermitian half)
    w = np.full((bins, 1), 2.0)
    w[0, 0] = 1.0
    if n_fft % 2 == 0:
        w[-1, 0] = 1.0
    ang = 2.0 * np.pi * k * n[None, :] / n_fft
    basis = np.concatenate([w * np.cos(ang) / n_fft,
                            -w * np.sin(ang) / n_fft]).astype(np.float32)
    window = _mel.pad_center(_mel.hann_window(n_fft), n_fft).astype(np.float32)
    # conv_transpose1d scatters input[c, l] * weight[c, 0, j] to l * hop + j
    # (no flip, unlike lax.conv_transpose): the windowed identity as it is
    ola = (np.eye(n_fft, dtype=np.float32) * window[None, :])[:, None, :]
    win_sq = (window ** 2)[None, :, None]
    return tuple(torch.from_numpy(a).to(device) for a in (basis, ola, win_sq))


def istft_head(spec_ri: Tensor, n_fft: int, hop: int) -> Tensor:
    """(B, 2 * (n_fft // 2 + 1), n_frames) real parts then imaginary parts
    -> (B, n_fft + hop * (n_frames - 1)) float32 waveform; equals
    ``audio.dsp.istft(spec, center=False)`` of the complex spectrum."""
    spec_ri = spec_ri.float()
    n_frames = spec_ri.shape[-1]
    out_len = n_fft + hop * (n_frames - 1)
    basis, ola, win_sq = istft_constants(n_fft, spec_ri.device)
    frames = torch.einsum("bkl,kn->bnl", spec_ri, basis)   # (B, n_fft, L)
    wav = F.conv_transpose1d(frames, ola, stride=hop)[:, 0]
    # window-sum-squares: the squared window overlap-added at every frame
    # (fold sums in float32 on every device, with no TF32 rounding)
    wss = F.fold(win_sq.expand(1, n_fft, n_frames), (1, out_len),
                 (1, n_fft), stride=(1, hop))[0, 0, 0]
    return wav * (1.0 / wss.clamp_min(1e-10))


class ISTFTMelganGenerator(nn.Module):
    """mel (B, in, T) -> waveform (B, 1, T * prod(upsample_factors) *
    hop_head)."""

    def __init__(self, in_channels: int = 80, proj_kernel: int = 7,
                 base_channels: int = 512,
                 upsample_factors: Sequence[int] = (8, 8),
                 num_res_blocks: int = 3, n_fft_head: int = 16,
                 hop_head: int = 4, inference_padding: int = 2,
                 use_weight_norm: bool = True):
        super().__init__()
        self.upsample_factors = tuple(upsample_factors)
        self.num_res_blocks = num_res_blocks
        self.n_fft_head, self.hop_head = n_fft_head, hop_head
        self.inference_padding = inference_padding
        self.layers = nn.Sequential(*generator_layers(
            in_channels, 2 * (n_fft_head // 2 + 1), proj_kernel,
            base_channels, self.upsample_factors, 3, num_res_blocks,
            use_weight_norm))

    @property
    def hop(self) -> int:
        return math.prod(self.upsample_factors) * self.hop_head

    def forward(self, c: Tensor) -> Tensor:
        head = self.layers(c)
        bins = self.n_fft_head // 2 + 1
        log_mag, phase = head[:, :bins], head[:, bins:]
        mag = torch.exp(log_mag.clamp(-12.0, 6.0))
        spec_ri = torch.cat([mag * torch.cos(phase), mag * torch.sin(phase)],
                            dim=1)
        wav = istft_head(spec_ri, self.n_fft_head, self.hop_head)
        # frame l covers [l * hop, l * hop + n_fft): keep n_frames * hop
        return torch.tanh(wav[:, : spec_ri.shape[-1] * self.hop_head])[:, None]

    @torch.no_grad()
    def inference(self, c: Tensor) -> Tensor:
        p = self.inference_padding
        return self(F.pad(c, (p, p), mode="replicate") if p else c)

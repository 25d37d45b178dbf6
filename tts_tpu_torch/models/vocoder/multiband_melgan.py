"""Multiband / Fullband MelGAN generators
(≙ tts_tpu/models/vocoder/multiband_melgan.py)."""

from __future__ import annotations

import torch

from tts_tpu_torch.models.vocoder.melgan import MelganGenerator
from tts_tpu_torch.models.vocoder.pqmf import PQMF


class MultibandMelganGenerator(MelganGenerator):
    """4-subband generator; the waveform is the PQMF synthesis of its
    outputs."""

    def __init__(self, in_channels: int = 80, out_channels: int = 4,
                 base_channels: int = 384, upsample_factors=(2, 8, 2, 2),
                 num_res_blocks: int = 3, **kwargs):
        super().__init__(in_channels=in_channels, out_channels=out_channels,
                         base_channels=base_channels,
                         upsample_factors=upsample_factors,
                         num_res_blocks=num_res_blocks, **kwargs)
        self.pqmf = PQMF(N=out_channels)

    def pqmf_analysis(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 1, T) waveform -> (B, N, T / N) subbands (differentiable)."""
        return self.pqmf.analysis(x)

    @torch.no_grad()
    def inference(self, c: torch.Tensor) -> torch.Tensor:
        """(B, 80, T) -> (B, 1, T * hop * N) waveform."""
        return self.pqmf.synthesis(super().inference(c))


class FullbandMelganGenerator(MelganGenerator):
    """Full-band single-output variant."""

    def __init__(self, in_channels: int = 80, base_channels: int = 512,
                 upsample_factors=(2, 8, 2, 2), num_res_blocks: int = 4,
                 **kwargs):
        super().__init__(in_channels=in_channels, out_channels=1,
                         base_channels=base_channels,
                         upsample_factors=upsample_factors,
                         num_res_blocks=num_res_blocks, **kwargs)

"""Glow-TTS inference: transformer encoder + duration predictor ->
``generate_path`` -> inverse flow decoder (≙ tts_tpu/models/glow_tts.py,
``GlowTTS.inference``; single speaker). Training (MAS, the forward flow and
its loss) comes with the Glow training slice."""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from tts_tpu_torch.models.glow.decoder import FlowDecoder
from tts_tpu_torch.models.glow.encoder import GlowTTSEncoder
from tts_tpu_torch.ops.mas import generate_path
from tts_tpu_torch.ops.masking import sequence_mask


class GlowTTS(nn.Module):
    def __init__(self, num_chars: int = 200, out_channels: int = 80,
                 hidden_channels_enc: int = 192,
                 hidden_channels_dec: int = 192, filter_channels: int = 768,
                 filter_channels_dp: int = 256, num_heads: int = 2,
                 num_layers_enc: int = 6, kernel_size: int = 3,
                 rel_attn_window_size: Optional[int] = 4,
                 kernel_size_dec: int = 5, dilation_rate: int = 1,
                 num_flow_blocks_dec: int = 12, num_block_layers: int = 4,
                 num_splits: int = 4, num_sqz: int = 2):
        super().__init__()
        self.num_sqz = num_sqz
        self.encoder = GlowTTSEncoder(
            num_chars=num_chars, out_channels=out_channels,
            hidden_channels=hidden_channels_enc,
            filter_channels=filter_channels,
            filter_channels_dp=filter_channels_dp, num_heads=num_heads,
            num_layers=num_layers_enc, kernel_size=kernel_size,
            rel_attn_window_size=rel_attn_window_size)
        self.decoder = FlowDecoder(
            in_channels=out_channels, hidden_channels=hidden_channels_dec,
            kernel_size=kernel_size_dec, dilation_rate=dilation_rate,
            num_flow_blocks=num_flow_blocks_dec,
            num_coupling_layers=num_block_layers, num_splits=num_splits,
            num_sqz=num_sqz)

    def store_inverse(self) -> None:
        """Cache every flow's inverse 1x1 weight; call after loading
        weights and moving the model to its device."""
        for flow in self.decoder.flows:
            if hasattr(flow, "store_inverse"):
                flow.store_inverse()

    @torch.no_grad()
    def inference(self, text: torch.Tensor,
                  text_lengths: Optional[torch.Tensor] = None,
                  noise_scale: float = 0.33, length_scale: float = 1.0,
                  y_max_length: int = 1024,
                  generator: Optional[torch.Generator] = None
                  ) -> Dict[str, torch.Tensor]:
        """Duration-driven flow inversion. ``y_max_length`` is the frame
        budget (rounded down to num_sqz), as in tts_tpu. Outputs keep
        tts_tpu's layout: ``model_outputs`` (B, T_y, C), ``alignments``
        (B, T_y, T_x), ``durations_log`` (B, T_x, 1)."""
        if text_lengths is None:
            text_lengths = torch.full((text.shape[0],), text.shape[1],
                                      dtype=torch.int32, device=text.device)
        o_mean, o_log_scale, o_dur_log, x_mask = self.encoder(
            text, text_lengths)

        # expm1, not exp: durations were regressed against log1p(sum attn)
        w = torch.expm1(o_dur_log[:, 0]) * x_mask[:, 0] * length_scale
        w_ceil = torch.ceil(w)
        y_lengths = torch.clamp(w_ceil.sum(dim=1), 1, y_max_length
                                ).to(torch.int32)
        y_lengths = (torch.ceil(y_lengths / self.num_sqz) * self.num_sqz
                     ).to(torch.int32)
        y_max = y_max_length // self.num_sqz * self.num_sqz

        y_mask = sequence_mask(y_lengths, y_max).to(o_mean.dtype)[:, None]
        attn_mask = x_mask[:, 0, :, None] * y_mask[:, 0, None, :]
        attn = generate_path(w_ceil.to(torch.int32), attn_mask)  # (B,Tx,Ty)

        y_mean = torch.matmul(o_mean, attn)                  # (B, C, T_y)
        y_log_scale = torch.matmul(o_log_scale, attn)
        if noise_scale:
            noise = torch.randn(y_mean.shape, generator=generator,
                                device=y_mean.device, dtype=y_mean.dtype)
            z = (y_mean + torch.exp(y_log_scale) * noise_scale * noise) * y_mask
        else:
            # noise_scale == 0: deterministic, no random numbers drawn
            z = y_mean * y_mask
        mel, _ = self.decoder.reverse(z, y_mask)
        return {
            "model_outputs": mel.transpose(1, 2),
            "mel_lengths": y_lengths,
            "alignments": attn.transpose(1, 2),
            "durations_log": o_dur_log.transpose(1, 2),
        }

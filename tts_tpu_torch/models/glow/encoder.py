"""Glow-TTS text encoder: embeddings -> prenet -> rel-pos transformer ->
mean projection + duration predictor (≙ tts_tpu/models/glow/encoder.py,
transformer type with prenet, mean_only — the configuration tts_tpu's
registry builds), in PyTorch's (B, C, T) layout. With ``c_in_channels`` >
0 the duration predictor reads the speaker vector too, concatenated after
the encoder's channels."""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from tts_tpu_torch.models.dropout import Dropout
from tts_tpu_torch.models.glow.flows import ConvLayerNorm
from tts_tpu_torch.models.glow.transformer import (LayerNorm,
                                                   RelPosTransformer)
from tts_tpu_torch.ops.masking import sequence_mask


class DurationPredictor(nn.Module):
    """2x [conv -> relu -> LN -> dropout] -> 1-channel log-durations
    (≙ DurationPredictor)."""

    def __init__(self, in_channels: int, hidden_channels: int = 256,
                 kernel_size: int = 3, dropout_rate: float = 0.1):
        super().__init__()
        self.dropout = Dropout(dropout_rate)
        pad = kernel_size // 2
        self.conv_1 = nn.Conv1d(in_channels, hidden_channels, kernel_size,
                                padding=pad)
        self.norm_1 = LayerNorm(hidden_channels)
        self.conv_2 = nn.Conv1d(hidden_channels, hidden_channels, kernel_size,
                                padding=pad)
        self.norm_2 = LayerNorm(hidden_channels)
        self.proj = nn.Conv1d(hidden_channels, 1, 1)

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor) -> torch.Tensor:
        y = self.dropout(self.norm_1(torch.relu(self.conv_1(x * x_mask))))
        y = self.dropout(self.norm_2(torch.relu(self.conv_2(y * x_mask))))
        return self.proj(y * x_mask) * x_mask        # (B, 1, T)


class GlowTTSEncoder(nn.Module):
    """(≙ GlowTTSEncoder with encoder_type="transformer"). Dropout: 0.5 in
    the prenet and 0.1 in the duration predictor, as tts_tpu fixes them;
    ``dropout_rate`` in the transformer."""

    def __init__(self, num_chars: int = 200, out_channels: int = 80,
                 hidden_channels: int = 192, filter_channels: int = 768,
                 filter_channels_dp: int = 256, num_heads: int = 2,
                 num_layers: int = 6, kernel_size: int = 3,
                 rel_attn_window_size: Optional[int] = 4,
                 dropout_rate: float = 0.1, c_in_channels: int = 0):
        super().__init__()
        self.hidden_channels = hidden_channels
        self.c_in_channels = c_in_channels
        self.emb = nn.Embedding(num_chars, hidden_channels)
        nn.init.normal_(self.emb.weight, 0.0, hidden_channels ** -0.5)
        self.pre = ConvLayerNorm(hidden_channels, hidden_channels,
                                 hidden_channels, kernel_size=5, num_layers=3,
                                 dropout_rate=0.5)
        self.encoder = RelPosTransformer(
            hidden_channels, filter_channels, num_heads, num_layers,
            kernel_size, rel_attn_window_size, dropout_rate)
        self.proj_m = nn.Conv1d(hidden_channels, out_channels, 1)
        self.duration_predictor = DurationPredictor(
            hidden_channels + c_in_channels, filter_channels_dp)

    def forward(self, x_ids: torch.Tensor, x_lengths: torch.Tensor,
                g: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           torch.Tensor]:
        """x_ids (B, T) int -> (means, log_scales, log_durations, x_mask),
        the first three (B, C, T) and the mask (B, 1, T); mean_only, so the
        log-scales are zero. The duration predictor sees the encoder output
        and the speaker vector ``g`` (B, c_in, 1) detached, so its loss
        trains only its own weights."""
        x = self.emb(x_ids) * math.sqrt(self.hidden_channels)
        x = x.transpose(1, 2)                                   # (B, C, T)
        x_mask = sequence_mask(x_lengths, x_ids.shape[1]).to(x.dtype)[:, None]
        x = self.encoder(self.pre(x, x_mask), x_mask)
        o_mean = self.proj_m(x) * x_mask
        o_log_scale = torch.zeros_like(o_mean)
        x_dp = x.detach()
        if g is not None:
            x_dp = torch.cat([x_dp, g.detach().expand(-1, -1, x.shape[2])],
                             dim=1)
        o_dur_log = self.duration_predictor(x_dp, x_mask)
        return o_mean, o_log_scale, o_dur_log, x_mask

    @torch.no_grad()
    def packed_weights(self):
        """The fused encoder's operands (``ops/glow_encoder.py``), packed
        once and kept on the module while every parameter keeps its storage
        and version counter: a parameter moved, stepped by an optimizer or
        overwritten by ``load_state_dict`` repacks, so a served model never
        runs stale weights (as the 1x1 inverses, ROADMAP C6)."""
        key = tuple((p.data_ptr(), p._version) for p in self.parameters())
        cached = self.__dict__.get("_packed")
        if cached is None or cached[0] != key:
            from tts_tpu_torch.ops.glow_encoder import \
                pack_glow_encoder_params
            cached = (key, pack_glow_encoder_params(self))
            self.__dict__["_packed"] = cached
        return cached[1]

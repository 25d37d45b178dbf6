"""Glow-TTS text encoder: embeddings -> (prenet) -> rel-pos transformer,
gated convs or time-depth-separable convs -> mean projection + duration
predictor (≙ tts_tpu/models/glow/encoder.py with its prenet and mean_only,
the configuration tts_tpu's registry builds; ``encoder_type`` picks the
body as there), in PyTorch's (B, C, T) layout, Mozilla's names
(``encoder.conv_layers`` / ``norm_layers`` for the gated convs,
``encoder.layers.{i}.time_conv`` / ``depth_conv`` / ``time_conv2`` /
``norm1-3`` for the separable ones). With ``c_in_channels`` > 0 the
duration predictor reads the speaker vector too, concatenated after the
encoder's channels."""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from tts_tpu_torch.models.dropout import Dropout
from tts_tpu_torch.models.glow.flows import ConvLayerNorm
from tts_tpu_torch.models.glow.transformer import (LayerNorm,
                                                   RelPosTransformer)
from tts_tpu_torch.models.layers import BatchNorm1d
from tts_tpu_torch.ops.masking import sequence_mask

ENCODER_TYPES = ("transformer", "gatedconv", "time-depth-separable")


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


class GatedConvBlock(nn.Module):
    """Per layer: dropout -> conv (k 5, 2C, on the masked input) ->
    LayerNorm (eps 1e-4) -> GLU -> residual (≙ GatedConvBlock). The output
    is not masked, as in tts_tpu."""

    def __init__(self, channels: int, kernel_size: int = 5,
                 num_layers: int = 9, dropout_rate: float = 0.1):
        super().__init__()
        self.dropout = Dropout(dropout_rate)
        self.conv_layers = nn.ModuleList(
            nn.Conv1d(channels, 2 * channels, kernel_size,
                      padding=kernel_size // 2) for _ in range(num_layers))
        self.norm_layers = nn.ModuleList(LayerNorm(2 * channels)
                                         for _ in range(num_layers))

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor) -> torch.Tensor:
        o = x
        for conv, norm in zip(self.conv_layers, self.norm_layers):
            a, b = torch.chunk(norm(conv(self.dropout(o) * x_mask)), 2,
                               dim=1)
            o = o + a * torch.sigmoid(b)
        return o


class TimeDepthSeparableConv(nn.Module):
    """1x1 conv to 2C -> BN -> GLU -> depthwise conv (k) -> BN -> swish ->
    1x1 conv -> BN, plus the layer's input (≙ TimeDepthSeparableConv).
    BatchNorm is flax's ``momentum=0.9``, eps 1e-5 (``layers.BatchNorm1d``:
    running statistics in ``eval()`` mode, the batch's, moved 0.1 of the
    way to them, in ``train()`` mode)."""

    def __init__(self, channels: int, kernel_size: int):
        super().__init__()
        self.time_conv = nn.Conv1d(channels, 2 * channels, 1)
        self.norm1 = BatchNorm1d(2 * channels)
        self.depth_conv = nn.Conv1d(channels, channels, kernel_size,
                                    padding=kernel_size // 2,
                                    groups=channels)
        self.norm2 = BatchNorm1d(channels)
        self.time_conv2 = nn.Conv1d(channels, channels, 1)
        self.norm3 = BatchNorm1d(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, b = torch.chunk(self.norm1(self.time_conv(x)), 2, dim=1)
        y = self.norm2(self.depth_conv(a * torch.sigmoid(b)))
        y = self.norm3(self.time_conv2(y * torch.sigmoid(y)))
        return x + y


class TimeDepthSeparableConvBlock(nn.Module):
    """``num_layers`` separable layers, each on its masked input; the
    output is not masked (≙ TimeDepthSeparableConvBlock)."""

    def __init__(self, channels: int, kernel_size: int = 5,
                 num_layers: int = 3):
        super().__init__()
        self.layers = nn.ModuleList(
            TimeDepthSeparableConv(channels, kernel_size)
            for _ in range(num_layers))

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x * x_mask)
        return x


class GlowTTSEncoder(nn.Module):
    """(≙ GlowTTSEncoder). ``encoder_type``: "transformer" (prenet, then
    ``num_layers`` rel-pos attention layers), "gatedconv" (no prenet, 3 +
    ``num_layers`` gated convs) or "time-depth-separable" (prenet, then 3 +
    ``num_layers`` separable layers). Dropout: 0.5 in the prenet and 0.1
    in the duration predictor, as tts_tpu fixes them; ``dropout_rate`` in
    the transformer and the gated convs."""

    def __init__(self, num_chars: int = 200, out_channels: int = 80,
                 hidden_channels: int = 192, filter_channels: int = 768,
                 filter_channels_dp: int = 256,
                 encoder_type: str = "transformer", num_heads: int = 2,
                 num_layers: int = 6, kernel_size: int = 3,
                 rel_attn_window_size: Optional[int] = 4,
                 dropout_rate: float = 0.1, c_in_channels: int = 0):
        super().__init__()
        if encoder_type not in ENCODER_TYPES:
            raise ValueError(f"unknown encoder type {encoder_type}")
        self.encoder_type = encoder_type
        self.hidden_channels = hidden_channels
        self.c_in_channels = c_in_channels
        self.emb = nn.Embedding(num_chars, hidden_channels)
        nn.init.normal_(self.emb.weight, 0.0, hidden_channels ** -0.5)
        if encoder_type != "gatedconv":
            self.pre = ConvLayerNorm(hidden_channels, hidden_channels,
                                     hidden_channels, kernel_size=5,
                                     num_layers=3, dropout_rate=0.5)
        if encoder_type == "transformer":
            self.encoder = RelPosTransformer(
                hidden_channels, filter_channels, num_heads, num_layers,
                kernel_size, rel_attn_window_size, dropout_rate)
        elif encoder_type == "gatedconv":
            self.encoder = GatedConvBlock(hidden_channels, 5, 3 + num_layers,
                                          dropout_rate)
        else:
            self.encoder = TimeDepthSeparableConvBlock(hidden_channels, 5,
                                                       3 + num_layers)
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
        if hasattr(self, "pre"):
            x = self.pre(x, x_mask)
        x = self.encoder(x, x_mask)
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

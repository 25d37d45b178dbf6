"""Building blocks of the spectrogram models (≙ tts_tpu/models/layers.py:
Prenet, ConvBNBlock, Postnet, Tacotron2Encoder, StopNet), in PyTorch's
(B, C, T) layout for convolutions, with Mozilla TTS's module names so that a
Mozilla Tacotron2 state dict loads as it is.

Eval semantics are tts_tpu's: BatchNorm uses its running statistics
(eps 1e-5, as flax's), and every dropout is gated by train mode (tts_tpu's
prenet comment at layers.py:41-42). Training is not ported, so ``train()``
mode only switches the dropouts on.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from tts_tpu_torch.ops.bilstm import bilstm
from tts_tpu_torch.ops.masking import sequence_mask


class Linear(nn.Module):
    """Mozilla's ``Linear`` wrapper: the layer sits under ``linear_layer``."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True):
        super().__init__()
        self.linear_layer = nn.Linear(in_features, out_features, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear_layer(x)


class LinearBN(Linear):
    """Linear then eval BatchNorm over the features (prenet_type "bn")."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True):
        super().__init__(in_features, out_features, bias)
        self.batch_normalization = nn.BatchNorm1d(out_features, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.batch_normalization(self.linear_layer(x))


class Prenet(nn.Module):
    """Bottleneck MLP: per layer linear (-> BN) -> relu (-> dropout 0.5 in
    train mode, "original" type only) (≙ Prenet)."""

    def __init__(self, in_features: int, prenet_type: str = "original",
                 prenet_dropout: bool = True,
                 out_features: Sequence[int] = (256, 256), bias: bool = True):
        super().__init__()
        if prenet_type not in ("original", "bn"):
            raise ValueError(f"unknown prenet_type: {prenet_type}")
        layer = LinearBN if prenet_type == "bn" else Linear
        dims = [in_features, *out_features]
        self.linear_layers = nn.ModuleList(
            layer(i, o, bias=bias) for i, o in zip(dims[:-1], dims[1:]))
        self.prenet_type = prenet_type
        self.dropout = prenet_dropout and prenet_type == "original"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.linear_layers:
            x = torch.relu(layer(x))
            if self.dropout:
                x = F.dropout(x, 0.5, training=self.training)
        return x


class ConvBNBlock(nn.Module):
    """conv1d (SAME) -> BatchNorm -> activation -> dropout 0.5 in train mode
    (≙ ConvBNBlock). tts_tpu's conv has no bias (BatchNorm cancels it);
    Mozilla's has one, so the port keeps it and a tts_tpu tree maps to a
    zero bias."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 activation: Optional[str] = None):
        super().__init__()
        self.convolution1d = nn.Conv1d(in_channels, out_channels, kernel_size,
                                       padding=(kernel_size - 1) // 2)
        self.batch_normalization = nn.BatchNorm1d(out_channels, eps=1e-5)
        if activation not in (None, "relu", "tanh"):
            raise ValueError(f"unknown activation: {activation}")
        self.activation = activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.batch_normalization(self.convolution1d(x))
        if self.activation == "relu":
            x = torch.relu(x)
        elif self.activation == "tanh":
            x = torch.tanh(x)
        return F.dropout(x, 0.5, training=self.training)


class Postnet(nn.Module):
    """4 x ConvBN(512, k=5, tanh) + ConvBN(n_mels, k=5, linear)
    (≙ Postnet). (B, n_mels, T) -> (B, n_mels, T)."""

    def __init__(self, out_channels: int, num_convs: int = 5,
                 hidden_channels: int = 512):
        super().__init__()
        dims = [out_channels] + [hidden_channels] * (num_convs - 1)
        self.convolutions = nn.ModuleList(
            ConvBNBlock(dims[i], dims[i + 1] if i + 1 < num_convs
                        else out_channels, 5,
                        "tanh" if i + 1 < num_convs else None)
            for i in range(num_convs))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.convolutions:
            x = layer(x)
        return x


class Encoder(nn.Module):
    """3 x ConvBN(k=5, relu) + a BiLSTM of C/2 per direction over the
    ragged lengths (≙ Tacotron2Encoder).

    ``lstm`` is a ``torch.nn.LSTM`` only to hold the weights under Mozilla's
    names (``weight_ih_l0``, ``..._reverse``); it is never called. The
    recurrence runs through ``ops.bilstm.bilstm``: the hand-written CUDA
    kernel on the card, its plain version on the CPU."""

    def __init__(self, in_features: int = 512):
        super().__init__()
        self.convolutions = nn.ModuleList(
            ConvBNBlock(in_features, in_features, 5, "relu")
            for _ in range(3))
        self.lstm = nn.LSTM(in_features, in_features // 2, num_layers=1,
                            batch_first=True, bias=True, bidirectional=True)

    def packed_lstm(self):
        """(wf, bf, wb, bb): per direction the fused (C + H, 4H) weight
        [W_ih^T; W_hh^T] and the bias b_ih + b_hh, gates i, f, g, o (≙
        ``pack_bilstm_params``)."""
        lstm = self.lstm
        out = []
        for sfx in ("", "_reverse"):
            w = torch.cat([getattr(lstm, f"weight_ih_l0{sfx}").t(),
                           getattr(lstm, f"weight_hh_l0{sfx}").t()], dim=0)
            b = (getattr(lstm, f"bias_ih_l0{sfx}")
                 + getattr(lstm, f"bias_hh_l0{sfx}"))
            out += [w.detach().contiguous(), b.detach().contiguous()]
        return tuple(out)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor,
                mask_pads: bool = False, packed=None) -> torch.Tensor:
        """x (B, C, T) embedded text -> (B, T, C). ``mask_pads`` zeroes the
        pad positions before and after every conv, so a text-length bucket
        gives the unpadded result (serving; tts_tpu's ``mask_pads``).
        ``packed``: ``packed_lstm()``'s result, when the caller keeps it."""
        mask = None
        if mask_pads:
            mask = sequence_mask(lengths, x.shape[2]).to(x.dtype)[:, None]
            x = x * mask
        for layer in self.convolutions:
            x = layer(x)
            if mask is not None:
                x = x * mask
        if packed is None:
            packed = self.packed_lstm()
        return bilstm(x.transpose(1, 2).contiguous(), lengths, *packed)

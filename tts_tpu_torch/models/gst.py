"""Global Style Tokens: reference encoder + style-token attention
(≙ tts_tpu/models/gst.py), with Mozilla TTS's names (``encoder.convs``,
``encoder.bns``, ``encoder.recurrence``, ``style_token_layer.style_tokens``,
``style_token_layer.attention.W_query`` / ``W_key`` / ``W_value``).

Where tts_tpu and Mozilla differ, the port computes tts_tpu's function:

- the six 3x3 stride-2 convs pad as flax's ``padding="SAME"`` does, (0, 1)
  on an even axis and (1, 1) on an odd one (Mozilla pads (1, 1) always);
- BatchNorm is flax's ``BatchNorm(momentum=0.9)``: running statistics at
  eval, the batch's in ``train()`` mode with the running variance moved to
  the *biased* batch variance (``layers.BatchNorm1d``, over (B, C, H, W));
- the attention scales by sqrt(num_units / heads) (Mozilla by
  sqrt(key_dim)).

The GRU runs as ``nn.GRU`` over (time, channel x mel) features, Mozilla's
order (flax's is mel x channel: the weight converter permutes). flax's
``GRUCell`` has no hidden-side bias on the r and z gates: that part of
``bias_hh_l0`` stays at zero (a gradient hook drops its gradient), as
tts_tpu's parameters hold it.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tts_tpu_torch.models.layers import BatchNorm1d, hold_gru_rz_bias

FILTERS = (32, 32, 64, 64, 128, 128)


def same_pad(n: int, kernel: int = 3, stride: int = 2) -> Tuple[int, int]:
    """flax/XLA ``SAME`` padding of an axis of length ``n``: output
    ceil(n / stride), the extra pad at the high end."""
    total = max((-(-n // stride) - 1) * stride + kernel - n, 0)
    return total // 2, total - total // 2


class ReferenceEncoder(nn.Module):
    """mel (B, T, n_mel) -> prosody embedding (B, out_dim): the GRU's last
    state."""

    def __init__(self, num_mel: int = 80, out_dim: int = 128):
        super().__init__()
        chans = (1,) + FILTERS
        self.convs = nn.ModuleList(
            nn.Conv2d(chans[i], chans[i + 1], 3, stride=2)
            for i in range(len(FILTERS)))
        self.bns = nn.ModuleList(BatchNorm1d(c) for c in FILTERS)
        width = num_mel
        for _ in FILTERS:
            width = -(-width // 2)
        self.recurrence = nn.GRU(FILTERS[-1] * width, out_dim,
                                 batch_first=True)
        hold_gru_rz_bias(self.recurrence.bias_hh_l0, out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x[:, None]                               # (B, 1, T, n_mel)
        for conv, bn in zip(self.convs, self.bns):
            h_pad, w_pad = same_pad(y.shape[2]), same_pad(y.shape[3])
            y = torch.relu(bn(conv(F.pad(y, (*w_pad, *h_pad)))))
        B, C, T, M = y.shape
        y = y.transpose(1, 2).reshape(B, T, C * M)
        # the GRU computes in its weights' dtype (float32 in mixed
        # precision, as tts_tpu's float32 carry makes its flax GRU)
        y = y.to(self.recurrence.weight_hh_l0.dtype)
        return self.recurrence(y)[1][0]


class MultiHeadAttention(nn.Module):
    """The prosody query over the style tokens, ``num_heads`` heads."""

    def __init__(self, query_dim: int, key_dim: int, num_units: int,
                 num_heads: int):
        super().__init__()
        self.num_units = num_units
        self.num_heads = num_heads
        self.W_query = nn.Linear(query_dim, num_units, bias=False)
        self.W_key = nn.Linear(key_dim, num_units, bias=False)
        self.W_value = nn.Linear(key_dim, num_units, bias=False)

    def forward(self, query: torch.Tensor, keys: torch.Tensor
                ) -> torch.Tensor:
        """query (B, T_q, D_q), keys (B, T_k, D_k) -> (B, T_q, num_units)."""
        H, d = self.num_heads, self.num_units // self.num_heads
        B, Tq, _ = query.shape
        Tk = keys.shape[1]
        q = self.W_query(query).view(B, Tq, H, d).transpose(1, 2)
        k = self.W_key(keys).view(B, Tk, H, d).transpose(1, 2)
        v = self.W_value(keys).view(B, Tk, H, d).transpose(1, 2)
        p = torch.softmax(q @ k.transpose(2, 3) / math.sqrt(d), dim=-1)
        return (p @ v).transpose(1, 2).reshape(B, Tq, self.num_units)


class StyleTokenLayer(nn.Module):
    def __init__(self, num_heads: int, num_style_tokens: int,
                 embedding_dim: int):
        super().__init__()
        key_dim = embedding_dim // num_heads
        self.style_tokens = nn.Parameter(
            torch.randn(num_style_tokens, key_dim) * 0.5)
        self.attention = MultiHeadAttention(embedding_dim // 2, key_dim,
                                            embedding_dim, num_heads)

    def forward(self, prosody: torch.Tensor) -> torch.Tensor:
        keys = torch.tanh(self.style_tokens)[None].expand(
            prosody.shape[0], -1, -1)
        return self.attention(prosody[:, None], keys)[:, 0]


class GST(nn.Module):
    """style mel (B, T, n_mel) -> style embedding (B, embedding_dim)."""

    def __init__(self, num_mel: int = 80, num_heads: int = 4,
                 num_style_tokens: int = 10, embedding_dim: int = 512):
        super().__init__()
        self.encoder = ReferenceEncoder(num_mel, embedding_dim // 2)
        self.style_token_layer = StyleTokenLayer(num_heads, num_style_tokens,
                                                 embedding_dim)

    def forward(self, style_mel: torch.Tensor) -> torch.Tensor:
        return self.style_token_layer(self.encoder(style_mel))

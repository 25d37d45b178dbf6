"""Relative-position transformer encoder for Glow-TTS
(≙ tts_tpu/models/glow/transformer.py), in PyTorch's (B, C, T) layout.

Module and parameter names follow Mozilla TTS (``conv_q``, ``emb_rel_k``,
``attn_layers``, ``norm_layers_1`` ...), so its state dicts load unchanged.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from tts_tpu_torch.models.dropout import Dropout


class LayerNorm(nn.Module):
    """LayerNorm over the channel axis of (B, C, T), eps 1e-4
    (≙ flax LayerNorm(epsilon=1e-4) on NWC, scale initialized to 0.1)."""

    def __init__(self, channels: int, eps: float = 1e-4):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.full((channels,), 0.1))
        self.beta = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.transpose(1, 2), (x.shape[1],), self.gamma,
                         self.beta, self.eps)
        return y.transpose(1, 2)


class RelativePositionMultiHeadAttention(nn.Module):
    """Multi-head attention with windowed relative key/value embeddings.
    Outside the window the relative embeddings are zero (not the clipped edge
    embedding), as in tts_tpu and the Mozilla reference."""

    def __init__(self, channels: int, num_heads: int,
                 rel_attn_window_size: Optional[int] = 4,
                 dropout_rate: float = 0.0):
        super().__init__()
        assert channels % num_heads == 0
        self.dropout = Dropout(dropout_rate)
        self.num_heads = num_heads
        self.k_channels = channels // num_heads
        self.window = rel_attn_window_size
        self.conv_q = nn.Conv1d(channels, channels, 1)
        self.conv_k = nn.Conv1d(channels, channels, 1)
        self.conv_v = nn.Conv1d(channels, channels, 1)
        self.conv_o = nn.Conv1d(channels, channels, 1)
        if self.window is not None:
            n = 2 * self.window + 1
            std = self.k_channels ** -0.5
            self.emb_rel_k = nn.Parameter(torch.randn(1, n, self.k_channels) * std)
            self.emb_rel_v = nn.Parameter(torch.randn(1, n, self.k_channels) * std)

    def _band_index(self, T: int, device) -> tuple:
        """(T, 2W+1) key positions t + r - W of each relative slot r, and
        which of them fall inside the sequence."""
        W = self.window
        cols = (torch.arange(T, device=device)[:, None]
                + torch.arange(2 * W + 1, device=device)[None, :] - W)
        return cols.clamp(0, T - 1), (cols >= 0) & (cols < T)

    def forward(self, x: torch.Tensor, attn_mask: torch.Tensor) -> torch.Tensor:
        """x (B, C, T); attn_mask (B, 1, T, T) bool."""
        B, C, T = x.shape
        H, d = self.num_heads, self.k_channels
        q = self.conv_q(x).view(B, H, d, T).transpose(2, 3)   # (B, H, T, d)
        k = self.conv_k(x).view(B, H, d, T).transpose(2, 3)
        v = self.conv_v(x).view(B, H, d, T).transpose(2, 3)
        scale = 1.0 / math.sqrt(d)
        scores = torch.matmul(q, k.transpose(2, 3)) * scale   # (B, H, T, S)
        if self.window is not None:
            W = self.window
            # relative logits q . emb_k[s - t + W] on the band |s - t| <= W
            rel = torch.matmul(q, self.emb_rel_k[0].t()) * scale  # (B,H,T,2W+1)
            pos = torch.arange(T, device=x.device)
            diff = pos[None, :] - pos[:, None]                   # s - t
            slot = (diff.clamp(-W, W) + W).expand(B, H, T, T)
            band = (diff.abs() <= W).to(scores.dtype)
            scores = scores + torch.gather(rel, 3, slot) * band
        scores = scores.masked_fill(~attn_mask, -1e4)
        p = self.dropout(torch.softmax(scores, dim=-1))
        out = torch.matmul(p, v)                                 # (B, H, T, d)
        if self.window is not None:
            cols, valid = self._band_index(T, x.device)
            p_band = torch.gather(p, 3, cols.expand(B, H, T, -1))
            p_band = p_band * valid.to(p.dtype)
            out = out + torch.matmul(p_band, self.emb_rel_v[0])
        out = out.transpose(2, 3).reshape(B, C, T)
        return self.conv_o(out)


class FFN(nn.Module):
    """Conv feed-forward (≙ FFN): conv -> relu -> dropout -> conv, masked."""

    def __init__(self, in_channels: int, out_channels: int,
                 filter_channels: int, kernel_size: int = 1,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.dropout = Dropout(dropout_rate)
        pad = kernel_size // 2
        self.conv_1 = nn.Conv1d(in_channels, filter_channels, kernel_size,
                                padding=pad)
        self.conv_2 = nn.Conv1d(filter_channels, out_channels, kernel_size,
                                padding=pad)

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor) -> torch.Tensor:
        y = self.dropout(torch.relu(self.conv_1(x * x_mask)))
        return self.conv_2(y * x_mask) * x_mask


class RelPosTransformer(nn.Module):
    """Stack of rel-pos attention + conv FFN blocks (≙ RelPosTransformer)."""

    def __init__(self, hidden_channels: int = 192, filter_channels: int = 768,
                 num_heads: int = 2, num_layers: int = 6, kernel_size: int = 3,
                 rel_attn_window_size: Optional[int] = 4,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.dropout = Dropout(dropout_rate)
        self.attn_layers = nn.ModuleList()
        self.norm_layers_1 = nn.ModuleList()
        self.ffn_layers = nn.ModuleList()
        self.norm_layers_2 = nn.ModuleList()
        for _ in range(num_layers):
            self.attn_layers.append(RelativePositionMultiHeadAttention(
                hidden_channels, num_heads, rel_attn_window_size,
                dropout_rate))
            self.norm_layers_1.append(LayerNorm(hidden_channels))
            self.ffn_layers.append(FFN(hidden_channels, hidden_channels,
                                       filter_channels, kernel_size,
                                       dropout_rate))
            self.norm_layers_2.append(LayerNorm(hidden_channels))

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor) -> torch.Tensor:
        """x (B, C, T); x_mask (B, 1, T)."""
        m = x_mask > 0
        attn_mask = m[:, :, :, None] & m[:, :, None, :]          # (B,1,T,T)
        for attn, ln1, ffn, ln2 in zip(self.attn_layers, self.norm_layers_1,
                                       self.ffn_layers, self.norm_layers_2):
            x = ln1(x + self.dropout(attn(x * x_mask, attn_mask)))
            x = ln2(x + self.dropout(ffn(x, x_mask)))
        return x * x_mask

"""Normalizing-flow blocks for the Glow-TTS decoder, reverse direction
(≙ tts_tpu/models/glow/flows.py), in PyTorch's (B, C, T) layout.

Only inference runs here, so each flow has ``reverse(x, x_mask)``; the
forward direction and its log-determinants come with Glow training.
Parameter names follow Mozilla TTS (``logs``/``bias``, ``weight``,
``start``/``wn``/``end``, ``in_layers``/``res_skip_layers`` with
``weight_v``/``weight_g``).
"""

from __future__ import annotations

import torch
from torch import nn

from tts_tpu_torch.models.glow.transformer import LayerNorm
from tts_tpu_torch.models.weight_norm import weight_norm


def fused_gate(x: torch.Tensor) -> torch.Tensor:
    """tanh of the first channel half times sigmoid of the second (single
    speaker: no conditioning term is added first)."""
    t, s = torch.chunk(x, 2, dim=1)
    return torch.tanh(t) * torch.sigmoid(s)


class ConvLayerNorm(nn.Module):
    """conv -> layernorm -> relu stack + zero-initialized residual projection
    (≙ ConvLayerNorm, the encoder prenet)."""

    def __init__(self, in_channels: int, hidden_channels: int,
                 out_channels: int, kernel_size: int = 5, num_layers: int = 3):
        super().__init__()
        self.conv_layers = nn.ModuleList()
        self.norm_layers = nn.ModuleList()
        ch = in_channels
        for _ in range(num_layers):
            self.conv_layers.append(nn.Conv1d(ch, hidden_channels, kernel_size,
                                              padding=kernel_size // 2))
            self.norm_layers.append(LayerNorm(hidden_channels))
            ch = hidden_channels
        self.proj = nn.Conv1d(hidden_channels, out_channels, 1)
        nn.init.zeros_(self.proj.weight)
        nn.init.zeros_(self.proj.bias)

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor) -> torch.Tensor:
        y = x
        for conv, norm in zip(self.conv_layers, self.norm_layers):
            y = torch.relu(norm(conv(y * x_mask)))
        return (x + self.proj(y)) * x_mask


class ActNorm(nn.Module):
    """Per-channel affine (≙ ActNorm); reverse z = (x - bias) e^-logs."""

    def __init__(self, channels: int):
        super().__init__()
        self.logs = nn.Parameter(torch.zeros(1, channels, 1))
        self.bias = nn.Parameter(torch.zeros(1, channels, 1))

    def reverse(self, x: torch.Tensor, x_mask: torch.Tensor) -> torch.Tensor:
        return (x - self.bias) * torch.exp(-self.logs) * x_mask


def _closed_form_inv(w: torch.Tensor) -> torch.Tensor:
    """Inverse of a tiny (n <= 5) matrix by cofactor expansion, the same
    arithmetic as tts_tpu's ``_closed_form_inv`` (so both packages invert the
    4x4 weights identically); torch.linalg.inv above that."""
    n = w.shape[0]
    if n > 5:
        return torch.linalg.inv(w)

    def minor(m, i, j):
        rows = [r for r in range(m.shape[0]) if r != i]
        cols = [c for c in range(m.shape[1]) if c != j]
        return m[rows][:, cols]

    def det(m):
        if m.shape[0] == 1:
            return m[0, 0]
        return sum(((-1.0) ** j) * m[0, j] * det(minor(m, 0, j))
                   for j in range(m.shape[0]))

    cof = torch.stack([
        torch.stack([((-1.0) ** (i + j)) * det(minor(w, i, j))
                     for j in range(n)])
        for i in range(n)])
    return cof.t() / det(w)


class InvConvNear(nn.Module):
    """Invertible 1x1 conv over channel groups of ``n_split``
    (≙ InvConvNear): halves first, then an n_split/2 interleave."""

    def __init__(self, channels: int, n_split: int = 4):
        super().__init__()
        assert channels % n_split == 0
        self.channels = channels
        self.n_split = n_split
        q, _ = torch.linalg.qr(torch.randn(n_split, n_split))
        if torch.det(q) < 0:
            q[:, 0] = -q[:, 0]
        self.weight = nn.Parameter(q)
        self.weight_inv = None

    def store_inverse(self) -> None:
        """Cache the inverse for inference (≙ Mozilla's ``store_inverse``).
        The cofactor expansion is a few hundred tiny ops: computed on the
        CPU once, not on the device per call. Call again after the weights
        change."""
        w = self.weight.detach().float().cpu()
        self.weight_inv = _closed_form_inv(w).to(self.weight.device)

    def reverse(self, x: torch.Tensor, x_mask: torch.Tensor) -> torch.Tensor:
        B, C, T = x.shape
        ns, half = self.n_split, self.n_split // 2
        xg = x.reshape(B, 2, C // ns, half, T).transpose(2, 3)
        xg = xg.reshape(B, ns, C // ns, T)
        w = self.weight_inv
        if w is None:
            w = _closed_form_inv(self.weight.float())
        w = w.to(x.dtype)
        zg = torch.einsum("rs,bsgt->brgt", w, xg)
        z = zg.reshape(B, 2, half, C // ns, T).transpose(2, 3).reshape(B, C, T)
        return z * x_mask


class WN(nn.Module):
    """Dilated-conv WaveNet core with weight norm (≙ WN), single speaker."""

    def __init__(self, hidden_channels: int, kernel_size: int = 5,
                 dilation_rate: int = 1, num_layers: int = 4):
        super().__init__()
        self.hidden_channels = hidden_channels
        self.num_layers = num_layers
        self.in_layers = nn.ModuleList()
        self.res_skip_layers = nn.ModuleList()
        for i in range(num_layers):
            dilation = dilation_rate ** i
            pad = (kernel_size - 1) // 2 * dilation
            self.in_layers.append(weight_norm(nn.Conv1d(
                hidden_channels, 2 * hidden_channels, kernel_size,
                dilation=dilation, padding=pad)))
            res_skip = (2 * hidden_channels if i < num_layers - 1
                        else hidden_channels)
            self.res_skip_layers.append(weight_norm(nn.Conv1d(
                hidden_channels, res_skip, 1)))

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor) -> torch.Tensor:
        H = self.hidden_channels
        output = torch.zeros_like(x)
        for i, (conv_in, conv_rs) in enumerate(zip(self.in_layers,
                                                   self.res_skip_layers)):
            res_skip = conv_rs(fused_gate(conv_in(x)))
            if i < self.num_layers - 1:
                x = (x + res_skip[:, :H]) * x_mask
                output = output + res_skip[:, H:]
            else:
                output = output + res_skip
        return output * x_mask


class CouplingBlock(nn.Module):
    """Affine coupling (≙ CouplingBlock): the first channel half conditions
    an affine map of the second."""

    def __init__(self, in_channels: int, hidden_channels: int,
                 kernel_size: int = 5, dilation_rate: int = 1,
                 num_layers: int = 4):
        super().__init__()
        self.half = in_channels // 2
        self.start = weight_norm(nn.Conv1d(self.half, hidden_channels, 1))
        self.wn = WN(hidden_channels, kernel_size, dilation_rate, num_layers)
        # zero-initialized end conv: an identity flow at start
        self.end = nn.Conv1d(hidden_channels, in_channels, 1)
        nn.init.zeros_(self.end.weight)
        nn.init.zeros_(self.end.bias)

    def reverse(self, x: torch.Tensor, x_mask: torch.Tensor) -> torch.Tensor:
        x_0, x_1 = x[:, :self.half], x[:, self.half:]
        h = self.start(x_0) * x_mask
        out = self.end(self.wn(h, x_mask))
        m, logs = out[:, :self.half], out[:, self.half:]
        z_1 = (x_1 - m) * torch.exp(-logs) * x_mask
        return torch.cat([x_0, z_1], dim=1)

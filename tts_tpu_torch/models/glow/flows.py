"""Normalizing-flow blocks for the Glow-TTS decoder
(≙ tts_tpu/models/glow/flows.py), in PyTorch's (B, C, T) layout.

Each flow has ``forward(x, x_mask) -> (z, logdet)`` (training; logdet is
(B,), float32) and ``reverse(x, x_mask) -> x`` (inference); the coupling
block takes the speaker vector ``g`` (B, c_in, 1) too. Parameter names
follow Mozilla TTS (``logs``/``bias``, ``weight``, ``start``/``wn``/``end``,
``in_layers``/``res_skip_layers``/``cond_layer`` with
``weight_v``/``weight_g``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from tts_tpu_torch.models.dropout import Dropout
from tts_tpu_torch.models.glow.transformer import LayerNorm
from tts_tpu_torch.models.weight_norm import weight_norm


def fused_gate(x: torch.Tensor, g: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
    """tanh of the first channel half times sigmoid of the second, of x
    plus the speaker conditioning ``g`` where there is one."""
    if g is not None:
        x = x + g
    t, s = torch.chunk(x, 2, dim=1)
    return torch.tanh(t) * torch.sigmoid(s)


class ConvLayerNorm(nn.Module):
    """conv -> layernorm -> relu -> dropout stack + zero-initialized
    residual projection (≙ ConvLayerNorm, the encoder prenet)."""

    def __init__(self, in_channels: int, hidden_channels: int,
                 out_channels: int, kernel_size: int = 5, num_layers: int = 3,
                 dropout_rate: float = 0.5):
        super().__init__()
        self.dropout = Dropout(dropout_rate)
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
            y = self.dropout(torch.relu(norm(conv(y * x_mask))))
        return (x + self.proj(y)) * x_mask


class ActNorm(nn.Module):
    """Per-channel affine (≙ ActNorm): z = (bias + e^logs x) * mask.

    Data-dependent init: ``apply_ddi`` clears ``initialized``; the next
    forward then sets ``logs`` and ``bias`` from the masked mean and
    variance of its input (variance floored at 1e-6) and applies them in
    the same pass, so the ActNorms after it see this one already
    normalized."""

    def __init__(self, channels: int):
        super().__init__()
        self.logs = nn.Parameter(torch.zeros(1, channels, 1))
        self.bias = nn.Parameter(torch.zeros(1, channels, 1))
        self.initialized = True

    @torch.no_grad()
    def _initialize(self, x: torch.Tensor, x_mask: torch.Tensor) -> None:
        denom = x_mask.sum().clamp_min(1.0)
        m = (x * x_mask).sum(dim=(0, 2)) / denom
        m_sq = (x * x * x_mask).sum(dim=(0, 2)) / denom
        logs = -0.5 * torch.log((m_sq - m ** 2).clamp_min(1e-6))
        self.logs.copy_(logs.view_as(self.logs))
        self.bias.copy_((-m * torch.exp(logs)).view_as(self.bias))
        self.initialized = True

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor):
        if not self.initialized:
            self._initialize(x, x_mask)
        z = (self.bias + torch.exp(self.logs) * x) * x_mask
        logdet = self.logs.sum() * x_mask.sum(dim=(1, 2))
        return z, logdet

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
    (≙ InvConvNear): halves first, then an n_split/2 interleave.

    ``store_inverse`` caches the inverse weight for inference; the cache
    holds only while ``weight`` is unchanged (its version counter, which
    every in-place update bumps: an optimizer step, ``load_state_dict``),
    so a model trained after caching never inverts with stale weights."""

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
        self._inverse_of = None     # weight's version when weight_inv was set

    def store_inverse(self) -> None:
        """Cache the inverse for inference (≙ Mozilla's ``store_inverse``).
        The cofactor expansion is a few hundred tiny ops: computed on the
        CPU once, not on the device per call. Call after moving the model
        to its device."""
        w = self.weight.detach().float().cpu()
        self.weight_inv = _closed_form_inv(w).to(self.weight.device)
        self._inverse_of = self.weight._version

    def _mix(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        B, C, T = x.shape
        ns, half = self.n_split, self.n_split // 2
        xg = x.reshape(B, 2, C // ns, half, T).transpose(2, 3)
        xg = xg.reshape(B, ns, C // ns, T)
        zg = torch.einsum("rs,bsgt->brgt", w, xg)
        return zg.reshape(B, 2, half, C // ns, T).transpose(2, 3).reshape(
            B, C, T)

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor):
        C = x.shape[1]
        _, logabsdet = torch.linalg.slogdet(self.weight.float())
        logdet = logabsdet * (C / self.n_split) * x_mask.sum(dim=(1, 2))
        return self._mix(x, self.weight) * x_mask, logdet

    def reverse(self, x: torch.Tensor, x_mask: torch.Tensor) -> torch.Tensor:
        w = self.weight_inv
        # under torch.export the weight is a stand-in tensor of its own
        # version: the stored inverse holds while the weights are fixed
        stale = self._inverse_of != self.weight._version
        if w is None or (stale and not torch.compiler.is_exporting()):
            w = _closed_form_inv(self.weight.float())
        return self._mix(x, w.to(x.dtype)) * x_mask


class WN(nn.Module):
    """Dilated-conv WaveNet core with weight norm (≙ WN). With
    ``c_in_channels`` > 0, one weight-normed 1x1 conv (``cond_layer``) maps
    the speaker vector to 2 x hidden channels per layer, split by layer and
    added before each gate."""

    def __init__(self, hidden_channels: int, kernel_size: int = 5,
                 dilation_rate: int = 1, num_layers: int = 4,
                 dropout_rate: float = 0.0, c_in_channels: int = 0):
        super().__init__()
        self.dropout = Dropout(dropout_rate)
        self.hidden_channels = hidden_channels
        self.num_layers = num_layers
        self.in_layers = nn.ModuleList()
        self.res_skip_layers = nn.ModuleList()
        if c_in_channels > 0:
            self.cond_layer = weight_norm(nn.Conv1d(
                c_in_channels, 2 * hidden_channels * num_layers, 1))
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

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor,
                g: Optional[torch.Tensor] = None) -> torch.Tensor:
        H = self.hidden_channels
        output = torch.zeros_like(x)
        g_all = (self.cond_layer(g) if g is not None
                 and hasattr(self, "cond_layer") else None)
        for i, (conv_in, conv_rs) in enumerate(zip(self.in_layers,
                                                   self.res_skip_layers)):
            g_l = None if g_all is None else g_all[:, 2 * H * i:
                                                   2 * H * (i + 1)]
            res_skip = conv_rs(fused_gate(self.dropout(conv_in(x)), g_l))
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
                 num_layers: int = 4, dropout_rate: float = 0.0,
                 c_in_channels: int = 0):
        super().__init__()
        self.half = in_channels // 2
        self.start = weight_norm(nn.Conv1d(self.half, hidden_channels, 1))
        self.wn = WN(hidden_channels, kernel_size, dilation_rate, num_layers,
                     dropout_rate, c_in_channels)
        # zero-initialized end conv: an identity flow at start
        self.end = nn.Conv1d(hidden_channels, in_channels, 1)
        nn.init.zeros_(self.end.weight)
        nn.init.zeros_(self.end.bias)

    def _affine(self, x_0: torch.Tensor, x_mask: torch.Tensor,
                g: Optional[torch.Tensor]):
        h = self.start(x_0) * x_mask
        out = self.end(self.wn(h, x_mask, g))
        return out[:, :self.half], out[:, self.half:]       # m, logs

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor,
                g: Optional[torch.Tensor] = None):
        x_0, x_1 = x[:, :self.half], x[:, self.half:]
        m, logs = self._affine(x_0, x_mask, g)
        z_1 = (m + torch.exp(logs) * x_1) * x_mask
        logdet = (logs.float() * x_mask).sum(dim=(1, 2))
        return torch.cat([x_0, z_1], dim=1), logdet

    def reverse(self, x: torch.Tensor, x_mask: torch.Tensor,
                g: Optional[torch.Tensor] = None) -> torch.Tensor:
        x_0, x_1 = x[:, :self.half], x[:, self.half:]
        m, logs = self._affine(x_0, x_mask, g)
        z_1 = (x_1 - m) * torch.exp(-logs) * x_mask
        return torch.cat([x_0, z_1], dim=1)

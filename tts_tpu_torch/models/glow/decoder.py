"""Glow-TTS flow decoder: time squeeze + stacked invertible flows, both
directions (≙ tts_tpu/models/glow/decoder.py), (B, C, T) layout. A speaker
vector g (B, c_in, 1) conditions every coupling block, broadcast over the
squeezed time axis."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from tts_tpu_torch.models.glow.flows import ActNorm, CouplingBlock, InvConvNear


def squeeze(x: torch.Tensor, x_mask: torch.Tensor, num_sqz: int = 2
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, C, T) -> (B, C*s, T//s); channel index = s_idx * C + c. A squeezed
    step is valid only if its last sub-frame is."""
    B, C, T = x.shape
    T_sqz = (T // num_sqz) * num_sqz
    x = x[:, :, :T_sqz].reshape(B, C, T_sqz // num_sqz, num_sqz)
    x = x.permute(0, 3, 1, 2).reshape(B, num_sqz * C, T_sqz // num_sqz)
    x_mask = x_mask[:, :, num_sqz - 1:T_sqz:num_sqz]
    return x * x_mask, x_mask


def unsqueeze(x: torch.Tensor, x_mask: torch.Tensor, num_sqz: int = 2
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, C*s, T) -> (B, C, T*s)."""
    B, C, T = x.shape
    x = x.reshape(B, num_sqz, C // num_sqz, T).permute(0, 2, 3, 1)
    x = x.reshape(B, C // num_sqz, T * num_sqz)
    x_mask = x_mask.repeat_interleave(num_sqz, dim=2)
    return x * x_mask, x_mask


class FlowDecoder(nn.Module):
    """(≙ FlowDecoder): ``flows`` holds [ActNorm, InvConvNear, CouplingBlock]
    per block, the Mozilla order (``flows.3i``, ``3i+1``, ``3i+2``)."""

    def __init__(self, in_channels: int = 80, hidden_channels: int = 192,
                 kernel_size: int = 5, dilation_rate: int = 1,
                 num_flow_blocks: int = 12, num_coupling_layers: int = 4,
                 dropout_rate: float = 0.05, num_splits: int = 4,
                 num_sqz: int = 2, c_in_channels: int = 0):
        super().__init__()
        self.num_sqz = num_sqz
        ch = in_channels * num_sqz
        self.flows = nn.ModuleList()
        for _ in range(num_flow_blocks):
            self.flows.append(ActNorm(ch))
            self.flows.append(InvConvNear(ch, num_splits))
            self.flows.append(CouplingBlock(
                ch, hidden_channels, kernel_size, dilation_rate,
                num_coupling_layers, dropout_rate, c_in_channels))

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor,
                g: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Mel (B, C, T) -> (latent (B, C, T'), logdet (B,) summed over the
        flows in float32, mask (B, 1, T'))."""
        x, sq_mask = squeeze(x, x_mask, self.num_sqz)
        logdet_total = torch.zeros(x.shape[0], device=x.device)
        for flow in self.flows:
            x, logdet = (flow(x, sq_mask, g) if isinstance(flow, CouplingBlock)
                         else flow(x, sq_mask))
            logdet_total = logdet_total + logdet
        z, z_mask = unsqueeze(x, sq_mask, self.num_sqz)
        return z, logdet_total, z_mask

    def reverse(self, z: torch.Tensor, z_mask: torch.Tensor,
                g: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Latent (B, C, T) -> (mel (B, C, T'), mask (B, 1, T'))."""
        x, sq_mask = squeeze(z, z_mask, self.num_sqz)
        for flow in reversed(self.flows):
            x = (flow.reverse(x, sq_mask, g) if isinstance(flow, CouplingBlock)
                 else flow.reverse(x, sq_mask))
        return unsqueeze(x, sq_mask, self.num_sqz)

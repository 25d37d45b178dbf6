"""ParallelWaveGAN generator and discriminators, plain PyTorch (≙
tts_tpu/models/vocoder/pwgan.py: ``Stretch2d``, ``ConvUpsample``,
``ResidualBlock``, ``ParallelWaveganGenerator``,
``ParallelWaveganDiscriminator``, ``ResidualParallelWaveganDiscriminator``),
in (B, C, T) layout.

The module trees are Mozilla TTS's, so a Mozilla generator state dict loads
unchanged and ``tts_tpu/compat/torch_port.py::port_pwgan`` reads the port's:
``upsample_net.conv_in``, ``upsample_net.upsample.up_layers.{2i+1}`` (a
bias-free ``Conv2d(1, 1, (1, 2s + 1))`` over (B, 1, C, T) after each
stretch), ``first_conv``, ``conv_layers.{i}.{conv, conv1x1_aux,
conv1x1_skip, conv1x1_out}``, ``last_conv_layers.{1,3}``. The
discriminators take Mozilla's names too (``conv_layers.{2i}`` with the
output conv last; ``first_conv.0``, ``conv_layers.{i}``,
``last_conv_layers.{1,3}``) and tts_tpu's weight norm: every conv of the
plain discriminator, only the residual blocks of the residual one.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tts_tpu_torch.models.weight_norm import weight_norm

NEGATIVE_SLOPE = 0.2


def _maybe_wn(module: nn.Module, use_weight_norm: bool) -> nn.Module:
    return weight_norm(module) if use_weight_norm else module


class Stretch2d(nn.Module):
    """Nearest-neighbour stretch of the last (time) axis by ``scale``."""

    def __init__(self, scale: int):
        super().__init__()
        self.scale = scale

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.repeat_interleave(self.scale, dim=-1)


class UpsampleNetwork(nn.Module):
    """Per factor s: stretch, then a bias-free (1, 2s + 1) conv over time
    that every mel channel shares."""

    def __init__(self, upsample_factors: Sequence[int],
                 use_weight_norm: bool = True):
        super().__init__()
        layers = []
        for s in upsample_factors:
            layers += [Stretch2d(s),
                       _maybe_wn(nn.Conv2d(1, 1, (1, 2 * s + 1),
                                           padding=(0, s), bias=False),
                                 use_weight_norm)]
        self.up_layers = nn.ModuleList(layers)

    def forward(self, c: torch.Tensor) -> torch.Tensor:
        x = c.unsqueeze(1)                      # (B, 1, C, T)
        for layer in self.up_layers:
            x = layer(x)
        return x.squeeze(1)


class ConvUpsample(nn.Module):
    """conv_in (kernel 2 * aux_context_window + 1, no padding: the dataset
    supplies the context frames), then the upsample network."""

    def __init__(self, upsample_factors: Sequence[int], aux_channels: int = 80,
                 aux_context_window: int = 0, use_weight_norm: bool = True):
        super().__init__()
        self.conv_in = _maybe_wn(nn.Conv1d(
            aux_channels, aux_channels, 2 * aux_context_window + 1,
            bias=False), use_weight_norm)
        self.upsample = UpsampleNetwork(upsample_factors, use_weight_norm)

    def forward(self, c: torch.Tensor) -> torch.Tensor:
        return self.upsample(self.conv_in(c))


class ResidualBlock(nn.Module):
    """Gated dilated conv with a 1x1 auxiliary conditioning conv (none when
    ``aux_channels`` is 0), returning (residual output, skip)."""

    def __init__(self, kernel_size: int = 3, res_channels: int = 64,
                 gate_channels: int = 128, skip_channels: int = 64,
                 aux_channels: int = 80, dilation: int = 1,
                 use_weight_norm: bool = True):
        super().__init__()
        pad = (kernel_size - 1) // 2 * dilation
        self.conv = _maybe_wn(nn.Conv1d(res_channels, gate_channels,
                                        kernel_size, padding=pad,
                                        dilation=dilation), use_weight_norm)
        self.conv1x1_aux = (_maybe_wn(nn.Conv1d(aux_channels, gate_channels, 1,
                                                bias=False), use_weight_norm)
                            if aux_channels > 0 else None)
        half = gate_channels // 2
        self.conv1x1_out = _maybe_wn(nn.Conv1d(half, res_channels, 1),
                                     use_weight_norm)
        self.conv1x1_skip = _maybe_wn(nn.Conv1d(half, skip_channels, 1),
                                      use_weight_norm)

    def forward(self, x: torch.Tensor, c: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        y = self.conv(x)
        if self.conv1x1_aux is not None:
            y = y + self.conv1x1_aux(c)
        a, b = y.chunk(2, dim=1)
        z = torch.tanh(a) * torch.sigmoid(b)
        # * 0.25, not sqrt(0.5): Mozilla's and tts_tpu's residual scale
        return (x + self.conv1x1_out(z)) * 0.25, self.conv1x1_skip(z)


class ParallelWaveganGenerator(nn.Module):
    """noise (B, 1, T) + mel (B, aux, T_frames) -> waveform (B, 1, T)."""

    def __init__(self, in_channels: int = 1, out_channels: int = 1,
                 kernel_size: int = 3, num_res_blocks: int = 30,
                 stacks: int = 3, res_channels: int = 64,
                 gate_channels: int = 128, skip_channels: int = 64,
                 aux_channels: int = 80, aux_context_window: int = 0,
                 upsample_factors: Sequence[int] = (4, 4, 4, 4),
                 inference_padding: int = 2, use_weight_norm: bool = True):
        super().__init__()
        assert num_res_blocks % stacks == 0
        self.in_channels = in_channels
        self.aux_context_window = aux_context_window
        self.upsample_factors = tuple(upsample_factors)
        self.inference_padding = inference_padding
        self.upsample_net = ConvUpsample(upsample_factors, aux_channels,
                                         aux_context_window, use_weight_norm)
        self.first_conv = _maybe_wn(nn.Conv1d(in_channels, res_channels, 1),
                                    use_weight_norm)
        per_stack = num_res_blocks // stacks
        self.conv_layers = nn.ModuleList(
            ResidualBlock(kernel_size, res_channels, gate_channels,
                          skip_channels, aux_channels, 2 ** (i % per_stack),
                          use_weight_norm)
            for i in range(num_res_blocks))
        self.last_conv_layers = nn.ModuleList([
            nn.ReLU(),
            _maybe_wn(nn.Conv1d(skip_channels, skip_channels, 1),
                      use_weight_norm),
            nn.ReLU(),
            _maybe_wn(nn.Conv1d(skip_channels, out_channels, 1),
                      use_weight_norm)])

    @property
    def hop(self) -> int:
        return math.prod(self.upsample_factors)

    def forward(self, z: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        # the context window can make the conditioning longer than z
        c = self.upsample_net(c)[..., : z.shape[-1]]
        x = self.first_conv(z)
        skips = 0.0
        for block in self.conv_layers:
            x, skip = block(x, c)
            skips = skips + skip
        x = skips * math.sqrt(1.0 / len(self.conv_layers))
        for layer in self.last_conv_layers:
            x = layer(x)
        return x

    @torch.no_grad()
    def inference(self, c: torch.Tensor, generator: torch.Generator
                  ) -> torch.Tensor:
        """Edge-pad ``inference_padding`` frames on both sides, draw white
        noise at the audio rate from ``generator`` (on the generator's
        device, then moved to ``c``'s: a CPU generator gives the same audio
        on any device) and run the generator."""
        p = self.inference_padding
        if p:
            c = F.pad(c, (p, p), mode="replicate")
        t_out = (c.shape[-1] - 2 * self.aux_context_window) * self.hop
        z = torch.randn((c.shape[0], self.in_channels, t_out),
                        generator=generator, device=generator.device)
        return self(z.to(c.device, c.dtype), c)


class ParallelWaveganDiscriminator(nn.Module):
    """(B, 1, T) -> score (B, 1, T): num_layers - 1 weight-normed dilated
    convs (dilation max(1, i)) with leaky ReLU, then the output conv."""

    def __init__(self, num_layers: int = 10, conv_channels: int = 64,
                 kernel_size: int = 3):
        super().__init__()
        layers = []
        cin = 1
        for i in range(num_layers - 1):
            dilation = max(1, i)
            layers += [weight_norm(nn.Conv1d(
                cin, conv_channels, kernel_size,
                padding=(kernel_size - 1) // 2 * dilation, dilation=dilation)),
                nn.LeakyReLU(NEGATIVE_SLOPE)]
            cin = conv_channels
        layers.append(weight_norm(nn.Conv1d(cin, 1, kernel_size,
                                            padding=(kernel_size - 1) // 2)))
        self.conv_layers = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.conv_layers:
            x = layer(x)
        return x


class ResidualParallelWaveganDiscriminator(nn.Module):
    """(B, 1, T) -> score (B, 1, T): WaveNet-style residual blocks without
    conditioning; the 1x1 convs outside the blocks are not weight-normed
    (tts_tpu's choice)."""

    def __init__(self, num_layers: int = 30, stacks: int = 3,
                 res_channels: int = 64, gate_channels: int = 128,
                 skip_channels: int = 64, kernel_size: int = 3):
        super().__init__()
        assert num_layers % stacks == 0
        self.first_conv = nn.Sequential(nn.Conv1d(1, res_channels, 1),
                                        nn.LeakyReLU(NEGATIVE_SLOPE))
        per_stack = num_layers // stacks
        self.conv_layers = nn.ModuleList(
            ResidualBlock(kernel_size, res_channels, gate_channels,
                          skip_channels, 0, 2 ** (i % per_stack))
            for i in range(num_layers))
        self.last_conv_layers = nn.ModuleList([
            nn.LeakyReLU(NEGATIVE_SLOPE),
            nn.Conv1d(skip_channels, skip_channels, 1),
            nn.LeakyReLU(NEGATIVE_SLOPE),
            nn.Conv1d(skip_channels, 1, 1)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.first_conv(x)
        skips = 0.0
        for block in self.conv_layers:
            x, skip = block(x, None)
            skips = skips + skip
        x = skips * math.sqrt(1.0 / len(self.conv_layers))
        for layer in self.last_conv_layers:
            x = layer(x)
        return x

"""MelGAN generator and discriminators, plain PyTorch (≙
tts_tpu/models/vocoder/melgan.py: ``WNConv``, ``ResidualStack``,
``MelganGenerator``, ``GroupedStridedConv``, ``MelganDiscriminator``,
``MelganMultiscaleDiscriminator``), in (B, C, T) layout.

The module tree is Mozilla TTS's (``layers`` = reflect pad, proj_in, then per
stage [LeakyReLU, ConvTranspose1d, ResidualStack], then LeakyReLU, reflect
pad, proj_out, tanh; ``blocks.j.{2,4}`` and ``shortcuts.j`` in each stack),
so Mozilla state dicts load unchanged and ``tts_tpu``'s ``port_melgan`` reads
the port's. This is the plain version of the two CUDA kernels in
``ops/cuda/``: tests and ``chip_smoke.py`` hold the kernels against it.

The discriminators keep tts_tpu's layer names (``disc_{i}``, ``conv_in``,
``down_{i}``, ``conv_post1``, ``conv_out``), with weight norm per output
channel as flax's, so ``compat/from_jax.py`` carries (v, g) over verbatim.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from tts_tpu_torch.models.weight_norm import weight_norm
from tts_tpu_torch.ops.grouped_conv import grouped_conv

NEGATIVE_SLOPE = 0.2


def conv_transpose_same_padding(factor: int) -> int:
    """The ``padding`` that makes torch's ConvTranspose1d(kernel 2f, stride
    f) place its taps as flax ``ConvTranspose(padding="SAME")`` does.

    lax.conv_transpose SAME pads the stride-dilated input by
    pad_a = ceil((3f - 2) / 2) on the left (3f/2 - 1 for even f), while
    torch's output n reads input (n + padding - k) / f, so padding =
    2f - 1 - pad_a (f/2 for even f, Mozilla's choice). Odd f gives one extra
    output sample, which ``UpsampleConvTranspose1d`` drops."""
    pad_a = -(-(3 * factor - 2) // 2)
    return 2 * factor - 1 - pad_a


class UpsampleConvTranspose1d(nn.ConvTranspose1d):
    """Transposed conv (kernel 2f, stride f) with exact f-times upsampling
    and flax SAME tap placement."""

    def __init__(self, in_channels: int, out_channels: int, factor: int):
        super().__init__(in_channels, out_channels, 2 * factor, stride=factor,
                         padding=conv_transpose_same_padding(factor))
        self.factor = factor

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x)[..., : x.shape[-1] * self.factor]


def _maybe_wn(module: nn.Module, use_weight_norm: bool) -> nn.Module:
    return weight_norm(module) if use_weight_norm else module


class ResidualStack(nn.Module):
    """n blocks of [LReLU, reflect pad, dilated conv (k=3, d=3^j), LReLU,
    1x1 conv] + a 1x1 shortcut per block."""

    def __init__(self, channels: int, kernel_size: int = 3,
                 num_res_blocks: int = 3, use_weight_norm: bool = True):
        super().__init__()
        self.kernel_size = kernel_size
        self.blocks = nn.ModuleList()
        self.shortcuts = nn.ModuleList()
        for j in range(num_res_blocks):
            d = kernel_size ** j
            self.blocks.append(nn.Sequential(
                nn.LeakyReLU(NEGATIVE_SLOPE),
                nn.ReflectionPad1d((kernel_size - 1) // 2 * d),
                _maybe_wn(nn.Conv1d(channels, channels, kernel_size,
                                    dilation=d), use_weight_norm),
                nn.LeakyReLU(NEGATIVE_SLOPE),
                _maybe_wn(nn.Conv1d(channels, channels, 1), use_weight_norm)))
            self.shortcuts.append(
                _maybe_wn(nn.Conv1d(channels, channels, 1), use_weight_norm))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block, shortcut in zip(self.blocks, self.shortcuts):
            x = shortcut(x) + block(x)
        return x


def generator_layers(in_channels: int, out_channels: int, proj_kernel: int,
                     base_channels: int, upsample_factors: Sequence[int],
                     res_kernel: int, num_res_blocks: int,
                     use_weight_norm: bool) -> list:
    """Mozilla's ``layers`` up to the output conv (no tanh): reflect pad,
    proj_in, per factor [LeakyReLU, ConvTranspose1d, ResidualStack] halving
    the channels, LeakyReLU, reflect pad, proj_out."""
    pad = (proj_kernel - 1) // 2
    layers = [nn.ReflectionPad1d(pad),
              _maybe_wn(nn.Conv1d(in_channels, base_channels, proj_kernel),
                        use_weight_norm)]
    ch = base_channels
    for f in upsample_factors:
        layers += [nn.LeakyReLU(NEGATIVE_SLOPE),
                   _maybe_wn(UpsampleConvTranspose1d(ch, ch // 2, f),
                             use_weight_norm),
                   ResidualStack(ch // 2, res_kernel, num_res_blocks,
                                 use_weight_norm)]
        ch //= 2
    layers += [nn.LeakyReLU(NEGATIVE_SLOPE), nn.ReflectionPad1d(pad),
               _maybe_wn(nn.Conv1d(ch, out_channels, proj_kernel),
                         use_weight_norm)]
    return layers


class MelganGenerator(nn.Module):
    """mel (B, in, T) -> (B, out, T * prod(upsample_factors))."""

    def __init__(self, in_channels: int = 80, out_channels: int = 1,
                 proj_kernel: int = 7, base_channels: int = 512,
                 upsample_factors: Sequence[int] = (8, 8, 2, 2),
                 res_kernel: int = 3, num_res_blocks: int = 3,
                 inference_padding: int = 2, use_weight_norm: bool = True):
        super().__init__()
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.proj_kernel = proj_kernel
        self.base_channels = base_channels
        self.upsample_factors = tuple(upsample_factors)
        self.num_res_blocks = num_res_blocks
        self.inference_padding = inference_padding
        self.use_weight_norm = use_weight_norm
        self.layers = nn.Sequential(
            *generator_layers(in_channels, out_channels, proj_kernel,
                              base_channels, self.upsample_factors,
                              res_kernel, num_res_blocks, use_weight_norm),
            nn.Tanh())

    def forward(self, c: torch.Tensor) -> torch.Tensor:
        return self.layers(c)

    def pad_inference(self, c: torch.Tensor) -> torch.Tensor:
        """Edge-replicate ``inference_padding`` frames on both sides."""
        p = self.inference_padding
        return F.pad(c, (p, p), mode="replicate") if p else c

    @torch.no_grad()
    def inference(self, c: torch.Tensor) -> torch.Tensor:
        return self(self.pad_inference(c))


class GroupedStridedConv(nn.Conv1d):
    """Grouped strided conv with zero padding (k - 1) // 2. Where tts_tpu's
    rule sends a layer to its Pallas gradient kernels (one input channel
    per group, stride 4, (L + k - 1) % 4 == 0), the gradients go through
    the port's kernels (``ops/grouped_conv.py``); any other layer is the
    library conv with autograd, as tts_tpu uses XLA there."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int, groups: int):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride,
                         padding=(kernel_size - 1) // 2, groups=groups)

    def uses_kernel_grads(self, length: int) -> bool:
        return (self.in_channels // self.groups == 1 and self.stride[0] == 4
                and (length + self.kernel_size[0] - 1) % 4 == 0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.uses_kernel_grads(x.shape[-1]):
            return (grouped_conv(x, self.weight, self.stride[0], self.groups)
                    + self.bias[:, None])
        return super().forward(x)


# MelganDiscriminator's geometry (tts_tpu's defaults, which its registry
# uses): conv_in k = 5 * 3 from 16 channels, four stride-4 downsamples of
# 4 * 10 + 1 taps with 4 channels per group up to 1024 channels, then
# conv_post1 (k = 5) and conv_out (k = 3)
KERNEL_SIZES = (5, 3)
BASE_CHANNELS = 16
MAX_CHANNELS = 1024
DOWNSAMPLE_FACTORS = (4, 4, 4, 4)
DOWNSAMPLE_KERNEL_MULT = 10


class MelganDiscriminator(nn.Module):
    """(B, 1, T) waveform -> (score (B, 1, T / 256), the 6 layers' leaky
    outputs)."""

    def __init__(self):
        super().__init__()
        k = KERNEL_SIZES[0] * KERNEL_SIZES[1]
        self.conv_in = weight_norm(nn.Conv1d(1, BASE_CHANNELS, k))
        ch = cin = BASE_CHANNELS
        for i, df in enumerate(DOWNSAMPLE_FACTORS):
            ch = min(ch * df, MAX_CHANNELS)
            groups = min(max(1, ch // 4), cin)
            self.add_module(f"down_{i}", weight_norm(GroupedStridedConv(
                cin, ch, df * DOWNSAMPLE_KERNEL_MULT + 1, df, groups)))
            cin = ch
        out = min(ch * 2, MAX_CHANNELS)
        self.conv_post1 = weight_norm(nn.Conv1d(
            ch, out, KERNEL_SIZES[0], padding=(KERNEL_SIZES[0] - 1) // 2))
        self.conv_out = weight_norm(nn.Conv1d(
            out, 1, KERNEL_SIZES[1], padding=(KERNEL_SIZES[1] - 1) // 2))

    def forward(self, x: torch.Tensor):
        feats = []
        pad = (self.conv_in.kernel_size[0] - 1) // 2
        y = F.leaky_relu(self.conv_in(F.pad(x, (pad, pad), mode="reflect")),
                         NEGATIVE_SLOPE)
        feats.append(y)
        for i in range(len(DOWNSAMPLE_FACTORS)):
            y = F.leaky_relu(getattr(self, f"down_{i}")(y), NEGATIVE_SLOPE)
            feats.append(y)
        y = F.leaky_relu(self.conv_post1(y), NEGATIVE_SLOPE)
        feats.append(y)
        return self.conv_out(y), feats


class MelganMultiscaleDiscriminator(nn.Module):
    """``num_scales`` discriminators on the waveform average-pooled by 2
    between scales. The pool counts the zero padding (flax ``avg_pool``'s
    default, which tts_tpu uses)."""

    def __init__(self, num_scales: int = 3):
        super().__init__()
        self.pool = nn.AvgPool1d(4, 2, padding=1, count_include_pad=True)
        self.num_scales = num_scales
        for i in range(num_scales):
            self.add_module(f"disc_{i}", MelganDiscriminator())

    def forward(self, x: torch.Tensor):
        scores, feats = [], []
        y = x
        for i in range(self.num_scales):
            if i > 0:
                y = self.pool(y)
            score, feat = getattr(self, f"disc_{i}")(y)
            scores.append(score)
            feats.append(feat)
        return scores, feats

"""Channel-sharded vocoder generators (≙ tts_tpu/parallel/model_parallel.py).

tts_tpu lays the ranks out as a (data, model) mesh, shards every wide
kernel on its output channels over the model axis and lets XLA insert the
all-gathers. Here the same rule picks the layers: a convolution whose
output channels are at least ``min_channels`` and divisible by the model
dim holds its slice of output channels on each rank of the model dim, and
its output is all-gathered along the channels before the next layer reads
it; the batch is split over the data dim. tts_tpu reads a flax kernel's
output channels at ``shape[-1]`` ((k, in, out)); a ``Conv1d`` weight holds
them in dim 0 and a ``ConvTranspose1d`` weight in dim 1, so the sharded
layers are tts_tpu's, name for name through the weights bridge.

This path runs the generator's plain layers, as tts_tpu's does: no kernel.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from tts_tpu_torch.models.weight_norm import weight_from_norm

CONVS = (nn.Conv1d, nn.ConvTranspose1d)


def out_channel_dim(conv: nn.Module) -> int:
    """The weight dim that holds a convolution's output channels."""
    return 1 if isinstance(conv, nn.ConvTranspose1d) else 0


def channel_shardings(module: nn.Module, mesh, axis: str = "model",
                      min_channels: int = 128) -> Dict[str, int]:
    """{name of a sharded convolution: its weight's output-channel dim}:
    the convolutions (groups 1) whose output channels are at least
    ``min_channels`` and divisible by the size of ``mesh``'s ``axis``;
    every other tensor is replicated."""
    n = mesh[axis].size()
    return {name: out_channel_dim(m) for name, m in module.named_modules()
            if isinstance(m, CONVS) and m.groups == 1
            and m.out_channels >= min_channels and m.out_channels % n == 0}


class ChannelShardedConv(nn.Module):
    """One rank's output channels of a convolution (its effective weight:
    weight norm folded), its output gathered along the channels over the
    model dim's group. Keeps no other rank's channels."""

    def __init__(self, conv: nn.Module, group, n: int, rank: int):
        super().__init__()
        dim = out_channel_dim(conv)
        c = conv.out_channels // n
        sl = slice(rank * c, (rank + 1) * c)
        weight = (weight_from_norm(conv.weight_v, conv.weight_g)
                  if hasattr(conv, "weight_v") else conv.weight).detach()
        self.weight = nn.Parameter(
            (weight[sl] if dim == 0 else weight[:, sl]).clone(),
            requires_grad=False)
        self.bias = (None if conv.bias is None else nn.Parameter(
            conv.bias.detach()[sl].clone(), requires_grad=False))
        self.transposed = isinstance(conv, nn.ConvTranspose1d)
        self.stride, self.padding = conv.stride, conv.padding
        self.dilation = conv.dilation
        self.output_padding = getattr(conv, "output_padding", 0)
        # UpsampleConvTranspose1d keeps factor x the input's length
        self.factor = getattr(conv, "factor", None)
        self.group, self.n = group, n

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.transposed:
            y = F.conv_transpose1d(x, self.weight, self.bias, self.stride,
                                   self.padding, self.output_padding, 1,
                                   self.dilation)
            if self.factor is not None:
                y = y[..., : x.shape[-1] * self.factor]
        else:
            y = F.conv1d(x, self.weight, self.bias, self.stride,
                         self.padding, self.dilation)
        parts = [torch.empty_like(y) for _ in range(self.n)]
        dist.all_gather(parts, y.contiguous(), group=self.group)
        return torch.cat(parts, dim=1)


def shard_params(module: nn.Module, mesh, axis: str = "model",
                 min_channels: int = 128) -> nn.Module:
    """Replace, in place, every convolution of ``channel_shardings`` by this
    rank's ``ChannelShardedConv``; returns ``module``."""
    group = mesh.get_group(axis)
    n, rank = mesh[axis].size(), mesh.get_local_rank(axis)
    for name in channel_shardings(module, mesh, axis, min_channels):
        parent_name, _, child = name.rpartition(".")
        parent = module.get_submodule(parent_name)
        setattr(parent, child, ChannelShardedConv(
            getattr(parent, child), group, n, rank))
    return module


def make_sharded_generator_forward(gen: nn.Module, mesh,
                                   data_axis: str = "data") -> Callable:
    """forward(mel (B, n_mels, T)) -> the generator's output on the whole
    batch (PQMF-synthesised where the generator has a PQMF), the batch
    split over ``data_axis`` and ``gen``'s sharded convolutions
    (``shard_params``) gathering over the model dim."""
    from tts_tpu_torch.infer.serving_dp import make_dp_serving

    def local(mel: torch.Tensor) -> torch.Tensor:
        out = gen(mel)
        if hasattr(gen, "pqmf"):
            out = gen.pqmf.synthesis(out)
        return out

    serve = make_dp_serving(local, mesh, data_axis)

    @torch.no_grad()
    def forward(mel: torch.Tensor) -> torch.Tensor:
        return serve(mel)

    return forward

"""Dropout drawn from an explicit generator, shared by every model of the
port (Glow-TTS, Tacotron2 and their layers)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


class Dropout(nn.Module):
    """Dropout as flax computes it (keep with probability 1 - rate, kept
    values divided by 1 - rate), drawing its mask from ``generator`` (an
    explicit ``torch.Generator`` on the input's device; the default one when
    None). The draws are float32 whatever the input's dtype, so a bfloat16
    and a float32 run from one seed drop the same values. Active only in
    ``train()`` mode."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        keep = torch.rand(x.shape, generator=self.generator,
                          device=x.device) < 1.0 - self.rate
        return x * keep / (1.0 - self.rate)


def set_generator(module: nn.Module,
                  generator: Optional[torch.Generator]) -> None:
    """Draw every dropout mask under ``module`` from ``generator`` (on the
    module's device)."""
    for m in module.modules():
        if isinstance(m, Dropout):
            m.generator = generator

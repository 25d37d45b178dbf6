"""Per-stack serving path for MelGAN-family generators
(≙ tts_tpu/models/vocoder/serving.py::fused_inference).

The folded generator's own layers run the proj/upsample convs while every
residual stack runs through the CUDA stack kernel (ops/cuda/fused_resstack.py)
— its plain version on the CPU. ``Synthesizer`` takes this path where
``megakernel_supported`` says no (odd upsample factors)."""

from __future__ import annotations

from typing import List

import torch

from tts_tpu_torch.models.vocoder.melgan import MelganGenerator, ResidualStack
from tts_tpu_torch.ops.cuda.fused_resstack import (StackWeights,
                                                   pack_stack_params,
                                                   residual_stack_nct)


def pack_stacks(gen: MelganGenerator) -> List[StackWeights]:
    """Kernel operands of every residual stack of a folded
    (``use_weight_norm=False``) generator, on its device."""
    sd = gen.state_dict()
    return [pack_stack_params(sd, f"layers.{i}", len(layer.blocks))
            for i, layer in enumerate(gen.layers)
            if isinstance(layer, ResidualStack)]


@torch.no_grad()
def fused_generator_apply(gen: MelganGenerator, stacks: List[StackWeights],
                          c: torch.Tensor) -> torch.Tensor:
    """(B, n_mels, T) -> (B, out_channels, T*hop), stacks on the kernel."""
    x = c
    stack_iter = iter(stacks)
    for layer in gen.layers:
        if isinstance(layer, ResidualStack):
            x = residual_stack_nct(x, *next(stack_iter))
        else:
            x = layer(x)
    return x


@torch.no_grad()
def fused_inference(gen: MelganGenerator, stacks: List[StackWeights],
                    mel: torch.Tensor) -> torch.Tensor:
    """Serving entry in tts_tpu's layout: mel (B, T, n_mels) -> inference
    padding -> generator -> PQMF synthesis for multiband -> (B, L, 1)."""
    out = fused_generator_apply(gen, stacks,
                                gen.pad_inference(mel.transpose(1, 2)))
    pqmf = getattr(gen, "pqmf", None)
    if pqmf is not None and gen.out_channels > 1:
        out = pqmf.synthesis(out)
    return out.transpose(1, 2)

"""Weight-norm folding for inference (≙ tts_tpu/models/vocoder/fold.py):
re-parameterize w = g * v / ||v|| into plain kernels once at load, so the
serving path runs bare convs. Load the result into the same model built
with ``use_weight_norm=False``."""

from __future__ import annotations

from typing import Dict

import torch

from tts_tpu_torch.models.weight_norm import weight_from_norm


def fold_weight_norm(state_dict: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    """``{p}.weight_v`` + ``{p}.weight_g`` -> ``{p}.weight``; every other
    entry is kept as it is."""
    out: Dict[str, torch.Tensor] = {}
    for key, val in state_dict.items():
        if key.endswith(".weight_g"):
            continue
        if key.endswith(".weight_v"):
            prefix = key[: -len(".weight_v")]
            out[prefix + ".weight"] = weight_from_norm(
                val.float(), state_dict[prefix + ".weight_g"].float())
        else:
            out[key] = val
    return out

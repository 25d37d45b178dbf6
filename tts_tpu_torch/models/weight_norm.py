"""Weight normalization with Mozilla TTS's parameter names.

``weight_norm(module)`` re-parameterizes ``module.weight`` as
``weight_g * weight_v / ||weight_v||`` with the norm over every axis but the
first, exactly as ``torch.nn.utils.weight_norm(module, dim=0)`` does, so
Mozilla ``.pth.tar`` state dicts (``*.weight_v`` / ``*.weight_g``) load
unchanged. ``models/vocoder/fold.py`` folds such a state dict into plain
``*.weight`` entries.
"""

from __future__ import annotations

import torch
from torch import nn


def _norm_except_dim0(v: torch.Tensor) -> torch.Tensor:
    return v.flatten(1).norm(dim=1).view(-1, *([1] * (v.dim() - 1)))


def weight_from_norm(v: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    # the 1e-12 floor matches tts_tpu's fold_weight_norm
    return v * (g / _norm_except_dim0(v).clamp_min(1e-12))


def _compute_weight(module: nn.Module, _inputs) -> None:
    module.weight = weight_from_norm(module.weight_v, module.weight_g)


def weight_norm(module: nn.Module) -> nn.Module:
    w = module.weight.detach()
    del module._parameters["weight"]
    module.weight_v = nn.Parameter(w.clone())
    module.weight_g = nn.Parameter(_norm_except_dim0(w).clone())
    module.weight = weight_from_norm(module.weight_v, module.weight_g)
    module.register_forward_pre_hook(_compute_weight)
    return module



def remove_weight_norm(model: nn.Module) -> nn.Module:
    """Fold every ``weight_norm`` of ``model`` back into a plain ``weight``
    parameter (in place), so the module computes the same function with
    bare kernels (``torch.export`` traces no parameter assignment)."""
    for module in model.modules():
        if "weight_v" not in module._parameters:
            continue
        w = weight_from_norm(module.weight_v, module.weight_g).detach()
        for key, hook in list(module._forward_pre_hooks.items()):
            if hook is _compute_weight:
                del module._forward_pre_hooks[key]
        del module._parameters["weight_v"], module._parameters["weight_g"]
        if "weight" in module.__dict__:
            del module.__dict__["weight"]
        module.weight = nn.Parameter(w)
    return model

"""Deployment through ``torch.export`` (≙ tts_tpu/export/deploy.py, which
stages a jitted function to a TF SavedModel / TFLite through jax2tf).

A model or a function of tensors is traced once at its example inputs'
shapes into an ``ExportedProgram`` and saved as a ``.pt2`` file that
``torch.export.load`` reads back without this package's Python code. The
trace is of the plain PyTorch modules (every Python loop unrolled); no
hand-written kernel is in the graph, as tts_tpu stages no Pallas kernel.
``max_abs_diff`` is the parity measure (≙ tts_tpu's)."""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn


class _Function(nn.Module):
    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def export_program(fn_or_module: Union[nn.Module, Callable],
                   example_args: Sequence[torch.Tensor], path: str
                   ) -> torch.export.ExportedProgram:
    """Trace ``fn_or_module`` (a module, or a function closed over its
    weights) at ``example_args``'s shapes without autograd, save the
    program to ``path`` (``.pt2``) and return it."""
    module = (fn_or_module if isinstance(fn_or_module, nn.Module)
              else _Function(fn_or_module))
    with torch.no_grad():
        program = torch.export.export(module, tuple(example_args))
    torch.export.save(program, path)
    return program


def load_program(path: str) -> torch.export.ExportedProgram:
    return torch.export.load(path)


def run_program(program: torch.export.ExportedProgram, *args: torch.Tensor,
                device: Optional[Union[str, torch.device]] = None) -> Any:
    """Run ``program`` on ``args``; with ``device`` the program's weights
    and constants are moved there first (``move_to_device_pass``) and the
    inputs with them."""
    if device is not None:
        from torch.export.passes import move_to_device_pass
        program = move_to_device_pass(program, torch.device(device))
        args = tuple(a.to(device) for a in args)
    with torch.no_grad():
        return program.module()(*args)


def max_abs_diff(a, b) -> float:
    """The largest element-wise difference of two arrays or tensors."""
    def host(x):
        return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
            else np.asarray(x)
    return float(np.max(np.abs(host(a) - host(b))))

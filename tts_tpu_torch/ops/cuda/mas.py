"""Monotonic alignment search: launch of the CUDA kernel (``mas.cu``).

Replaces ``tts_tpu/ops/pallas/mas_kernel.py::maximum_path_pallas`` (the
pallas_call of ``_mas_kernel``). The plain PyTorch version and the
dispatcher by device live in ``tts_tpu_torch/ops/mas.py``; this module only
launches. Bound on the card: bytes (value inside the lengths, the mask and
the path: at most 12 per text x mel cell); its real limit is the serial
chain of mel columns, see the source.
"""

from __future__ import annotations

import ctypes

import torch

from tts_tpu_torch.ops.cuda import build

KERNEL = "maximum_path"

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "mas_forward": (ctypes.c_int, [_P, _P, _P, _P, _P, _I, _I, _I, _P]),
}


def maximum_path_cuda(value: torch.Tensor, mask: torch.Tensor
                      ) -> torch.Tensor:
    """value, mask: (B, T_x, T_y) float32 CUDA tensors -> 0/1 path of the
    same shape, multiplied by ``mask``. As in tts_tpu, ``value`` is zeroed
    outside the mask and the lengths are read from the mask's first column
    (t_x) and first row (t_y)."""
    build.require_cuda_f32("value", value)
    build.require_cuda_f32("mask", mask, tuple(value.shape))
    if value.dim() != 3:
        raise ValueError(f"value: expected (B, T_x, T_y), got "
                         f"{tuple(value.shape)}")
    B, T_x, T_y = value.shape
    value_t = torch.where(mask > 0, value, torch.zeros((), device=value.device))
    value_t = value_t.transpose(1, 2).contiguous()          # (B, T_y, T_x)
    t_xs = (mask[:, :, 0] > 0).sum(dim=1, dtype=torch.int32)
    t_ys = (mask[:, 0, :] > 0).sum(dim=1, dtype=torch.int32)
    path = torch.empty_like(value)
    dec = torch.empty((B, T_y, T_x), dtype=torch.uint8, device=value.device)
    lib = build.library("mas", _SIGNATURES)
    err = lib.mas_forward(build.ptr(value_t), build.ptr(t_xs), build.ptr(t_ys),
                          build.ptr(path), build.ptr(dec), B, T_x, T_y,
                          build.stream_handle(value.device))
    build.check(lib, KERNEL, err)
    return path.mul_(mask)

"""Monotonic alignment search: launch of the CUDA kernel (``mas.cu``).

Replaces ``tts_tpu/ops/pallas/mas_kernel.py::maximum_path_pallas`` (the
pallas_call of ``_mas_kernel``). The plain PyTorch version and the
dispatcher by device live in ``tts_tpu_torch/ops/mas.py``; this module only
launches. The kernel reads value and mask as they are and writes the whole
path, masked: one launch and nothing else on the card. Bound on the card:
bytes (value inside the lengths, the mask and the path: at most 12 per text
x mel cell); its real limit is the serial chain of mel columns, see the
source.
"""

from __future__ import annotations

import ctypes

import torch

from tts_tpu_torch.ops.cuda import build

KERNEL = "maximum_path"

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "mas_scratch_words": (ctypes.c_longlong, [_I, _I, _I]),
    "mas_forward": (ctypes.c_int, [_P, _P, _P, _P, _I, _I, _I, _P]),
}


def maximum_path_cuda(value: torch.Tensor, mask: torch.Tensor
                      ) -> torch.Tensor:
    """value, mask: (B, T_x, T_y) float32 contiguous CUDA tensors -> 0/1
    path of the same shape, multiplied by ``mask``. As in tts_tpu, ``value``
    is zeroed where mask <= 0 and the lengths are the counts of mask > 0 in
    its first column (t_x) and first row (t_y)."""
    build.require_cuda_f32("value", value)
    build.require_cuda_f32("mask", mask, tuple(value.shape))
    if value.dim() != 3:
        raise ValueError(f"value: expected (B, T_x, T_y), got "
                         f"{tuple(value.shape)}")
    B, T_x, T_y = value.shape
    path = torch.empty_like(value)
    lib = build.library("mas", _SIGNATURES)
    scratch = torch.empty(max(lib.mas_scratch_words(B, T_x, T_y), 1),
                          dtype=torch.int32, device=value.device)
    err = lib.mas_forward(build.ptr(value), build.ptr(mask), build.ptr(path),
                          build.ptr(scratch), B, T_x, T_y,
                          build.stream_handle(value.device))
    build.check(lib, KERNEL, err)
    return path

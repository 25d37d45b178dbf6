"""Grouped strided conv gradients: launch of the CUDA kernels
(``grouped_conv_grad.cu``).

Replaces ``tts_tpu/ops/pallas/grouped_conv_grad.py``: ``grouped_conv_wgrad``
(the pallas_call of ``_wgrad_kernel``) and ``grouped_conv_dgrad`` (the
pallas_call of ``_dgrad_kernel``). The plain PyTorch versions, the dtype
handling and the autograd Function live in ``tts_tpu_torch/ops/
grouped_conv.py``; this module only launches. Bound on the card: bytes (x
and dy read once, dW or dx written once); see the source for the design.

The kernels take one input channel per group (m = 1), at most 4 output
channels per group, stride 1-4 and an odd kernel of at most 63 taps with
padding (k - 1) // 2; anything else raises.
"""

from __future__ import annotations

import ctypes

import torch

from tts_tpu_torch.ops.cuda import build

WGRAD = "grouped_conv_wgrad"
DGRAD = "grouped_conv_dgrad"

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "grouped_conv_wgrad_scratch_floats": (ctypes.c_longlong, [_I] * 6),
    "grouped_conv_wgrad_forward": (ctypes.c_int, [_P, _P, _P, _P] + [_I] * 8
                                   + [_P]),
    "grouped_conv_dgrad_forward": (ctypes.c_int, [_P, _P, _P] + [_I] * 8
                                   + [_P]),
}


def _geometry(B: int, cin: int, L: int, dy: torch.Tensor, k: int,
              stride: int, groups: int):
    """Checks what the kernels take; returns (n, pad, Lout)."""
    if groups < 1 or cin != groups:
        raise ValueError(f"the kernels take one input channel per group; "
                         f"got {cin} channels in {groups} groups")
    if dy.dim() != 3 or dy.shape[0] != B or dy.shape[1] % groups:
        raise ValueError(f"dy: expected ({B}, groups * n, L_out), got "
                         f"{tuple(dy.shape)}")
    n = dy.shape[1] // groups
    pad = (k - 1) // 2
    Lout = (L + 2 * pad - k) // stride + 1
    if not (1 <= n <= 4 and 1 <= stride <= 4 and k % 2 == 1 and k <= 63):
        raise ValueError(f"unsupported geometry: {n} outputs per group, "
                         f"stride {stride}, kernel {k}")
    if dy.shape[2] != Lout:
        raise ValueError(f"dy: expected {Lout} positions, got {dy.shape[2]}")
    return n, pad, Lout


def grouped_conv_wgrad_cuda(x: torch.Tensor, dy: torch.Tensor,
                            kernel_size: int, stride: int, groups: int
                            ) -> torch.Tensor:
    """x (B, groups, L), dy (B, groups * n, L_out), float32 contiguous CUDA
    tensors -> dW (groups * n, 1, kernel_size) of
    y = conv1d(x, W, stride, padding (k - 1) // 2, groups)."""
    build.require_cuda_f32("x", x)
    build.require_cuda_f32("dy", dy)
    if x.dim() != 3 or dy.device != x.device:
        raise ValueError("x: expected (B, C, L) on dy's device")
    B, cin, L = x.shape
    n, pad, Lout = _geometry(B, cin, L, dy, kernel_size, stride, groups)
    cout = dy.shape[1]
    dw = torch.empty((cout, 1, kernel_size), dtype=torch.float32,
                     device=x.device)
    lib = build.library("grouped_conv_grad", _SIGNATURES)
    partial = torch.empty(lib.grouped_conv_wgrad_scratch_floats(
        B, groups, n, Lout, kernel_size, stride), dtype=torch.float32,
        device=x.device)
    err = lib.grouped_conv_wgrad_forward(
        build.ptr(x), build.ptr(dy), build.ptr(dw), build.ptr(partial), B,
        groups, n, L, Lout, kernel_size, stride, pad,
        build.stream_handle(x.device))
    build.check(lib, WGRAD, err)
    return dw


def grouped_conv_dgrad_cuda(dy: torch.Tensor, weight: torch.Tensor,
                            x_len: int, stride: int, groups: int
                            ) -> torch.Tensor:
    """dy (B, groups * n, L_out), weight (groups * n, 1, k), float32
    contiguous CUDA tensors -> dx (B, groups, x_len)."""
    build.require_cuda_f32("dy", dy)
    build.require_cuda_f32("weight", weight)
    if weight.dim() != 3 or weight.shape[:2] != (dy.shape[1], 1) \
            or weight.device != dy.device:
        raise ValueError(f"weight: expected ({dy.shape[1]}, 1, k) on dy's "
                         f"device, got {tuple(weight.shape)}")
    B = dy.shape[0]
    k = weight.shape[2]
    n, pad, Lout = _geometry(B, groups, x_len, dy, k, stride, groups)
    dx = torch.empty((B, groups, x_len), dtype=torch.float32, device=dy.device)
    lib = build.library("grouped_conv_grad", _SIGNATURES)
    err = lib.grouped_conv_dgrad_forward(
        build.ptr(dy), build.ptr(weight), build.ptr(dx), B, groups, n, x_len,
        Lout, k, stride, pad, build.stream_handle(dy.device))
    build.check(lib, DGRAD, err)
    return dx

"""Encoder BiLSTM: launch of the CUDA kernels (``bilstm.cu``).

Replaces ``tts_tpu/ops/pallas/fused_bilstm.py::fused_bilstm`` (the
pallas_call of ``_make_kernel``). The reversal of the backward direction,
the plain PyTorch version and the dispatcher by device live in
``tts_tpu_torch/ops/bilstm.py``; this module only launches. One call is
1 + T launches: the input GEMM of both directions, then one recurrent step
kernel per time step. Bound on the card: fp32 operations; see the source.
"""

from __future__ import annotations

import ctypes

import torch

from tts_tpu_torch.ops.cuda import build

KERNEL = "fused_bilstm"

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "bilstm_forward": (ctypes.c_int, [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                      _I, _I, _P]),
}


def bilstm_cuda(x: torch.Tensor, xr: torch.Tensor, wf: torch.Tensor,
                bf: torch.Tensor, wb: torch.Tensor, bb: torch.Tensor
                ) -> torch.Tensor:
    """x, xr (B, T, C): the input and its per-item reversal; fused weights
    (C + H, 4H) and biases (4H,) per direction, all float32 CUDA tensors ->
    h (2, T, B, H): both directions scanned forward over all T steps."""
    build.require_cuda_f32("x", x)
    if x.dim() != 3:
        raise ValueError(f"x: expected (B, T, C), got {tuple(x.shape)}")
    B, T, C = x.shape
    H = wf.shape[1] // 4
    build.require_cuda_f32("xr", xr, (B, T, C))
    for name, w, b in (("wf", wf, bf), ("wb", wb, bb)):
        build.require_cuda_f32(name, w, (C + H, 4 * H))
        build.require_cuda_f32(name.replace("w", "b"), b, (4 * H,))
    if len({t.device for t in (x, xr, wf, bf, wb, bb)}) != 1:
        raise ValueError("bilstm: every operand must be on one device")
    xt = torch.stack([x.transpose(0, 1), xr.transpose(0, 1)]).contiguous()
    g = torch.empty((2, T * B, 4 * H), dtype=torch.float32, device=x.device)
    c = torch.zeros((2, B, H), dtype=torch.float32, device=x.device)
    out = torch.empty((2, T, B, H), dtype=torch.float32, device=x.device)
    lib = build.library("bilstm", _SIGNATURES)
    err = lib.bilstm_forward(build.ptr(xt), build.ptr(wf), build.ptr(bf),
                             build.ptr(wb), build.ptr(bb), build.ptr(g),
                             build.ptr(c), build.ptr(out), B, T, C, H,
                             build.stream_handle(x.device))
    build.check(lib, KERNEL, err, launches=(1 + T) if B and T else 0)
    return out

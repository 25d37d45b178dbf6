"""STFT magnitude: launch of the CUDA kernel (``stft_mag.cu``).

Replaces ``tts_tpu/ops/pallas/stft_kernel.py::_mag_fwd`` (the pallas_call
of ``_mag_kernel`` behind ``stft_magnitude``). The plain PyTorch version, the
framing, the window and half-banks and the autograd Function live in
``tts_tpu_torch/ops/stft.py``; this module only launches. Bound on the card:
bytes (frames in, magnitudes out); the kernel itself is bound by its 3xTF32
tensor-core products. See the source for the design.
"""

from __future__ import annotations

import ctypes

import torch

from tts_tpu_torch.ops.cuda import build

KERNEL = "stft_magnitude"

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "stft_mag_forward": (ctypes.c_int, [_P, _P, _P, _P, _I, _I, _I, _P]),
}


def stft_mag_cuda(frames: torch.Tensor, window: torch.Tensor,
                  banks: torch.Tensor) -> torch.Tensor:
    """frames (N, n_fft), window (n_fft,), banks (2, P, P) from
    ``ops/stft.py::half_banks``: float32 contiguous CUDA tensors on one
    device -> magnitudes (N, n_fft // 2 + 1), sqrt(re^2 + im^2 + 1e-12)."""
    build.require_cuda_f32("frames", frames)
    if frames.dim() != 2:
        raise ValueError(f"frames: expected (N, n_fft), got "
                         f"{tuple(frames.shape)}")
    N, K = frames.shape
    build.require_cuda_f32("window", window, (K,))
    build.require_cuda_f32("banks", banks)
    P = banks.shape[-1]
    if banks.dim() != 3 or tuple(banks.shape) != (2, P, P):
        raise ValueError(f"banks: expected (2, P, P), got "
                         f"{tuple(banks.shape)}")
    if window.device != frames.device or banks.device != frames.device:
        raise ValueError("frames, window and banks must be on one device")
    mag = torch.empty((N, K // 2 + 1), dtype=torch.float32,
                      device=frames.device)
    lib = build.library("stft_mag", _SIGNATURES)
    err = lib.stft_mag_forward(build.ptr(frames), build.ptr(window),
                               build.ptr(banks), build.ptr(mag), N, K, P,
                               build.stream_handle(frames.device))
    build.check(lib, KERNEL, err)
    return mag

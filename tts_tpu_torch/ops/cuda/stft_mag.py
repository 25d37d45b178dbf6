"""STFT magnitude: launch of the CUDA kernel (``stft_mag.cu``).

Replaces ``tts_tpu/ops/pallas/stft_kernel.py::_mag_fwd`` (the pallas_call
of ``_mag_kernel`` behind ``stft_magnitude``). The plain PyTorch version, the
framing, the DFT banks and the autograd Function live in
``tts_tpu_torch/ops/stft.py``; this module only launches. Bound on the card:
fp32 operations (4 N n_fft bins FLOPs); see the source for the design.
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


def stft_mag_cuda(frames: torch.Tensor, wr: torch.Tensor, wi: torch.Tensor
                  ) -> torch.Tensor:
    """frames (N, n_fft), banks wr / wi (n_fft, bins): float32 contiguous
    CUDA tensors -> magnitudes (N, bins), sqrt(re^2 + im^2 + 1e-12)."""
    build.require_cuda_f32("frames", frames)
    if frames.dim() != 2:
        raise ValueError(f"frames: expected (N, n_fft), got "
                         f"{tuple(frames.shape)}")
    N, K = frames.shape
    build.require_cuda_f32("wr", wr)
    if wr.dim() != 2 or wr.shape[0] != K:
        raise ValueError(f"wr: expected ({K}, bins), got {tuple(wr.shape)}")
    build.require_cuda_f32("wi", wi, tuple(wr.shape))
    if wr.device != frames.device or wi.device != frames.device:
        raise ValueError("frames and banks must be on one device")
    mag = torch.empty((N, wr.shape[1]), dtype=torch.float32,
                      device=frames.device)
    lib = build.library("stft_mag", _SIGNATURES)
    err = lib.stft_mag_forward(build.ptr(frames), build.ptr(wr), build.ptr(wi),
                               build.ptr(mag), N, K, wr.shape[1],
                               build.stream_handle(frames.device))
    build.check(lib, KERNEL, err)
    return mag

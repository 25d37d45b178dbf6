"""Whole eval-mode Glow-TTS encoder: launch of the CUDA kernels
(``glow_encoder.cu``).

Replaces ``tts_tpu/ops/pallas/fused_glow_encoder.py::fused_glow_encoder_apply``
(the pallas_call of ``_make_kernel``). The packing, the plain PyTorch version
and the dispatcher by device live in ``tts_tpu_torch/ops/glow_encoder.py``;
this module only launches. One call is ``launches_per_call(dims)`` launches
from one C entry point (38 at the shipped width). Bound on the card: fp32
operations at a large batch; see the source.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from tts_tpu_torch.ops.cuda import build

KERNEL = "fused_glow_encoder"

_P, _I = ctypes.c_void_p, ctypes.c_int
_DIMS = ("hidden", "filt", "filt_dp", "heads", "layers", "n_out", "k_pre",
         "n_pre", "k_ffn", "k_dp")
_SIGNATURES = {
    "glow_encoder_forward": (ctypes.c_int, [_P] * 8 + [_I] * 12
                             + [ctypes.c_float, _P]),
    "glow_encoder_weight_floats": (ctypes.c_longlong, [_I] * 10),
    "glow_encoder_max_text_length": (ctypes.c_int, [_I, _I]),
}


def launches_per_call(dims) -> int:
    """Prenet convs + projection, 5 per layer, proj_mean, the duration
    predictor's 2 convs and projection."""
    return dims.n_pre + 1 + 5 * dims.layers + 4


@functools.lru_cache(maxsize=None)
def _max_text_length(kc: int, index: int) -> int:
    lib = build.library("glow_encoder", _SIGNATURES)
    n = lib.glow_encoder_max_text_length(kc, index)
    if n < 0:
        raise RuntimeError(f"glow encoder: cannot read the shared memory "
                           f"limit: {lib.kernel_error_string(-n).decode()}")
    return n


def max_text_length(kc: int, device: torch.device) -> int:
    """The longest text (T) whose attention block the card's shared memory
    holds at k_ch ``kc``, as ``glow_encoder.cu`` computes it from
    ``attention_floats`` (so the two cannot drift apart). A longer text
    makes the kernel raise."""
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    return _max_text_length(kc, index)


def glow_encoder_cuda(flat: torch.Tensor, dims, emb: torch.Tensor,
                      mask: torch.Tensor) -> torch.Tensor:
    """flat: the packed weights (``pack_glow_encoder_params``), emb (B, T, C)
    the embedded text, mask (B, T) 1/0, float32 on one CUDA device ->
    (B, T, 2 n_out + 1): means | log-scales (zero) | log-durations."""
    build.require_cuda_f32("emb", emb)
    if emb.dim() != 3 or emb.shape[2] != dims.hidden:
        raise ValueError(f"emb: expected (B, T, {dims.hidden}), got "
                         f"{tuple(emb.shape)}")
    B, T, C = emb.shape
    build.require_cuda_f32("mask", mask, (B, T))
    build.require_cuda_f32("weights", flat)
    if len({t.device for t in (emb, mask, flat)}) != 1:
        raise ValueError("glow encoder: every operand must be on one device")
    if any(t.requires_grad for t in (emb, mask, flat)):
        raise RuntimeError("glow encoder kernel: it has no backward; call it "
                           "under torch.no_grad() (the module computes "
                           "gradients)")
    lib = build.library("glow_encoder", _SIGNATURES)
    want = lib.glow_encoder_weight_floats(*(getattr(dims, d) for d in _DIMS))
    if flat.numel() != want:
        raise ValueError(f"glow encoder: {flat.numel()} packed weights, the "
                         f"kernel walks {want}")
    dev = emb.device
    M, width = B * T, max(C, dims.filt, dims.filt_dp)
    x = emb.clone()
    h0 = torch.empty((M, width), dtype=torch.float32, device=dev)
    h1 = torch.empty_like(h0)
    qkv = torch.empty((M, 3 * C), dtype=torch.float32, device=dev)
    att = torch.empty((M, C), dtype=torch.float32, device=dev)
    out = torch.zeros((B, T, 2 * dims.n_out + 1), dtype=torch.float32,
                      device=dev)
    scale = 1.0 / math.sqrt(C // dims.heads)
    err = lib.glow_encoder_forward(
        build.ptr(x), build.ptr(mask), build.ptr(flat), build.ptr(h0),
        build.ptr(h1), build.ptr(qkv), build.ptr(att), build.ptr(out), B, T,
        *(getattr(dims, d) for d in _DIMS), scale, build.stream_handle(dev))
    build.check(lib, KERNEL, err,
                launches=launches_per_call(dims) if B and T else 0)
    return out

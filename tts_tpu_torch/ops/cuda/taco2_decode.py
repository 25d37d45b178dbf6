"""Whole greedy Tacotron2 decode: launch of the CUDA kernels
(``taco2_decode.cu``).

Replaces ``tts_tpu/ops/pallas/fused_taco2_decode.py::fused_decode`` (the
pallas_call of ``_make_kernel``). The packing, the plain PyTorch version and
the dispatcher by device live in ``tts_tpu_torch/ops/taco2_decode.py``; this
module only launches. One call runs every step from C, 8 launches a step.
Bound on the card: fp32 operations at a batch of 64, weight bytes at a
batch of 1; see the source.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from tts_tpu_torch.ops.cuda import build

KERNEL = "fused_decode"
LAUNCHES_PER_STEP = 8

_P, _I = ctypes.c_void_p, ctypes.c_int
WEIGHTS = ("pw1", "pw2", "aw", "ab", "qk", "kloc", "ld", "v", "dw", "db",
            "projw", "projb", "stopw", "stopb")
_SIGNATURES = {
    "taco2_decode": (ctypes.c_int, [_P] * (3 + len(WEIGHTS) + 4)
                     + [_I] * 14 + [_P]),
    "state_floats": (ctypes.c_longlong, [_I] * 10),
}


def decode_cuda(enc: torch.Tensor, processed_inputs: torch.Tensor,
                mask: torch.Tensor, packed: Dict[str, torch.Tensor],
                steps: int, r: int, n_mels: int = 80
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """enc (B, T, D), processed_inputs (B, T, A), mask (B, T) and the
    packed weights (``pack_decoder_params``), float32 on one CUDA device ->
    frames (steps, B, r * n_mels), stop logits (steps, B), alignments
    (steps, B, T)."""
    build.require_cuda_f32("enc", enc)
    if enc.dim() != 3:
        raise ValueError(f"enc: expected (B, T, D), got {tuple(enc.shape)}")
    B, T, D = enc.shape
    p = packed
    M, P1 = p["pw1"].shape
    P2 = p["pw2"].shape[1]
    H, A = p["qk"].shape
    KL, _, F = p["kloc"].shape
    H2 = p["db"].shape[0] // 4
    NP = p["projw"].shape[1]
    if M != n_mels or not 1 <= r * n_mels <= NP:
        raise ValueError(f"decode: n_mels {n_mels} and r {r} do not fit the "
                         f"prenet input {M} and the projection's {NP} "
                         f"outputs")
    if F != 32 or A % 32 or 256 % A or D % 4:
        raise ValueError(f"decode: the kernel takes 32 location filters, "
                         f"an attention dim of 32, 64, 128 or 256 and an "
                         f"encoder dim that is a multiple of 4, got {F}, "
                         f"{A} and {D}")
    shapes = dict(pw1=(M, P1), pw2=(P1, P2), aw=(P2 + D + H, 4 * H),
                  ab=(4 * H,), qk=(H, A), kloc=(KL, 2, F), ld=(F, A), v=(A,),
                  dw=(H + D + H2, 4 * H2), db=(4 * H2,),
                  projw=(H2 + D, NP), projb=(NP,), stopw=(H2 + NP,),
                  stopb=(1,))
    for name in WEIGHTS:
        build.require_cuda_f32(name, p[name], shapes[name])
    build.require_cuda_f32("processed_inputs", processed_inputs, (B, T, A))
    maskf = mask.to(torch.float32).contiguous()
    build.require_cuda_f32("mask", maskf, (B, T))
    tensors = (enc, processed_inputs, maskf, *(p[n] for n in WEIGHTS))
    if len({t.device for t in tensors}) != 1:
        raise ValueError("decode: every operand must be on one device")
    dev = enc.device
    lib = build.library("taco2_decode", _SIGNATURES)
    state = torch.zeros(int(lib.state_floats(B, T, D, A, M, P1, P2, H, H2,
                                             NP)),
                        dtype=torch.float32, device=dev)
    frames = torch.empty((steps, B, r * M), dtype=torch.float32, device=dev)
    stop = torch.empty((steps, B), dtype=torch.float32, device=dev)
    align = torch.empty((steps, B, T), dtype=torch.float32, device=dev)
    err = lib.taco2_decode(*(build.ptr(t) for t in tensors), build.ptr(state),
                           build.ptr(frames), build.ptr(stop),
                           build.ptr(align), steps, B, T, D, A, F, KL, M, P1,
                           P2, H, H2, NP, r, build.stream_handle(dev))
    build.check(lib, KERNEL, err,
                launches=LAUNCHES_PER_STEP * steps if B else 0)
    return frames, stop, align

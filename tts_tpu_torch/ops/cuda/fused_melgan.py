"""The whole MelGAN-family generator through hand-written CUDA kernels
(``fused_melgan.cu`` and ``fused_resstack.cu``), and its plain PyTorch
version.

Replaces ``tts_tpu/ops/pallas/fused_melgan.py::megakernel_inference`` and
``megakernel_generator_apply`` (the pallas_call in ``_fused_generator``),
PQMF synthesis included. A call launches, on PyTorch's current stream:
proj_in (1), then per stage the polyphase upsample (1) and the residual
stack (one per residual block), then the tail (leaky, proj_out, tanh, PQMF)
(1): for Multiband-MelGAN (4 stages, 4 blocks) that is 22 launches, no
library conv or matmul among them. Bound on the card: operations (fp32 FMA,
about 16.5 MFLOP per mel frame for the 384-wide Multiband-MelGAN).

Weights are packed once (``pack_generator_params``) from a folded state dict
into the kernels' layouts. A CUDA mel launches the kernels (or raises); a
CPU mel takes the plain version of the same function.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from tts_tpu_torch import DeviceLike, resolve_device
from tts_tpu_torch.models.vocoder.melgan import (NEGATIVE_SLOPE,
                                                 conv_transpose_same_padding)
from tts_tpu_torch.ops.cuda import build
from tts_tpu_torch.ops.cuda.fused_resstack import (StackWeights,
                                                   pack_stack_params,
                                                   residual_stack_nct)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "melgan_proj_in": (_I, [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]),
    "melgan_upsample": (_I, [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P]),
    "melgan_tail": (_I, [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F,
                         _P]),
}
PROJ_IN, UPSAMPLE, TAIL = "melgan_proj_in", "melgan_upsample", "melgan_tail"


@dataclass
class UpsampleWeights:
    """Polyphase transposed conv: output phase p of frame u reads tap A_p at
    frame u + q_p and tap B_p at frame u + q_p - 1. ``w[p, g, ci]`` holds
    (A_p, B_p)[ci] for output channels 4g..4g+3."""
    w: torch.Tensor          # (f, C_out/4, C_in, 2, 4)
    bias: torch.Tensor       # (C_out,)
    factor: int
    padding: int             # torch ConvTranspose1d padding P; q_p = (p+P)//f


@dataclass
class GeneratorWeights:
    proj_in_w: torch.Tensor               # (C0/4, n_mels, K, 4)
    proj_in_b: torch.Tensor               # (C0,)
    upsamples: List[UpsampleWeights]
    stacks: List[StackWeights]
    proj_out_w: torch.Tensor              # (C_last, K, N)
    proj_out_b: torch.Tensor              # (N,)
    syn: Optional[torch.Tensor]           # (J, N subbands, N phases) or None
    syn_q: int                            # left frame pad of the synthesis


def pack_upsample_params(weight: torch.Tensor, bias: torch.Tensor,
                         factor: int) -> UpsampleWeights:
    """torch ConvTranspose1d weight (C_in, C_out, 2f) -> two taps per phase.
    Output n = u*f + p reads input (n + P - k) / f: the tap k0 = (p + P) % f
    lands on frame u + q_p and k0 + f on u + q_p - 1."""
    f = factor
    P = conv_transpose_same_padding(f)
    if not 0 <= P < f:
        raise ValueError(f"upsample factor {f} has no two-tap form")
    w = weight.float()
    C_in, C_out, _ = w.shape
    if C_out % 4:
        raise ValueError(f"upsample needs C_out % 4 == 0, got {C_out}")
    taps = []
    for p in range(f):
        k0 = (p + P) % f
        ab = torch.stack([w[:, :, k0], w[:, :, k0 + f]], dim=1)  # (Ci, 2, Co)
        taps.append(ab.reshape(C_in, 2, C_out // 4, 4).permute(2, 0, 1, 3))
    return UpsampleWeights(torch.stack(taps).contiguous(),
                           bias.float().contiguous(), f, P)


def _phase_taps(up: UpsampleWeights, p: int):
    """(A_p, B_p), each (C_in, C_out), from the grouped layout."""
    g, C_in = up.w.shape[1], up.w.shape[2]
    ab = up.w[p].permute(1, 2, 0, 3).reshape(C_in, 2, 4 * g)
    return ab[:, 0], ab[:, 1]


def _proj_in_weight(weight: torch.Tensor) -> torch.Tensor:
    """torch Conv1d (C_out, C_in, K) -> (C_out/4, C_in, K, 4)."""
    C_out, C_in, K = weight.shape
    if C_out % 4:
        raise ValueError(f"proj_in needs C_out % 4 == 0, got {C_out}")
    return (weight.float().reshape(C_out // 4, 4, C_in, K)
            .permute(0, 2, 3, 1).contiguous())


def _proj_in_conv_weight(w: torch.Tensor) -> torch.Tensor:
    """The packed proj_in weight back in torch Conv1d layout."""
    g, C_in, K, _ = w.shape
    return w.permute(0, 3, 1, 2).reshape(4 * g, C_in, K)


def _proj_out_weight(weight: torch.Tensor) -> torch.Tensor:
    """torch Conv1d (N, C_in, K) -> (C_in, K, N)."""
    return weight.float().permute(1, 2, 0).contiguous()


def pack_generator_params(gen, state_dict: Dict[str, torch.Tensor],
                          device: DeviceLike = None) -> GeneratorWeights:
    """A folded (``fold_weight_norm``) MelGAN-family state dict -> the
    kernels' operands on ``device`` (CUDA unless asked otherwise). For a
    multiband generator the PQMF synthesis bank is packed too and runs in
    the tail kernel."""
    dev = resolve_device(device)
    n_stage = len(gen.upsample_factors)
    sd = {k: v.detach().float() for k, v in state_dict.items()}
    upsamples, stacks = [], []
    for i, f in enumerate(gen.upsample_factors):
        up = f"layers.{3 + 3 * i}"
        upsamples.append(pack_upsample_params(sd[f"{up}.weight"],
                                              sd[f"{up}.bias"], f))
        stacks.append(pack_stack_params(sd, f"layers.{4 + 3 * i}",
                                        gen.num_res_blocks))
    out = f"layers.{4 + 3 * n_stage}"
    pqmf = getattr(gen, "pqmf", None)
    syn, syn_q = None, 0
    if pqmf is not None and gen.out_channels > 1:
        syn = torch.from_numpy(np.ascontiguousarray(pqmf.syn_poly))
        syn_q = int(pqmf.syn_pad[0])

    def to(t):
        return None if t is None else t.to(dev)

    return GeneratorWeights(
        proj_in_w=to(_proj_in_weight(sd["layers.1.weight"])),
        proj_in_b=to(sd["layers.1.bias"].contiguous()),
        upsamples=[UpsampleWeights(to(u.w), to(u.bias), u.factor, u.padding)
                   for u in upsamples],
        stacks=[tuple(to(t) for t in s) for s in stacks],
        proj_out_w=to(_proj_out_weight(sd[f"{out}.weight"])),
        proj_out_b=to(sd[f"{out}.bias"].contiguous()),
        syn=to(syn), syn_q=syn_q)


def megakernel_supported(gen) -> bool:
    """The kernel chain takes every MelGAN-family generator whose upsample
    factors are even (the case ``tts_tpu`` also requires) and whose channel
    counts are multiples of 4 (the kernels' channel tile). Shared memory
    holds a time tile, not a whole item, so length sets no limit."""
    if any(f % 2 for f in gen.upsample_factors):
        return False
    ch = gen.base_channels
    widths = [ch >> i for i in range(len(gen.upsample_factors) + 1)]
    return all(c % 4 == 0 for c in widths)


# ---------------------------------------------------------------------------
# plain versions, one per kernel
# ---------------------------------------------------------------------------

def proj_in_plain(mel: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  pad: int) -> torch.Tensor:
    """mel (B, T, n_mels) -> edge pad ``pad`` -> reflect conv -> (B, C0, T')."""
    x = mel.transpose(1, 2)
    if pad:
        x = F.pad(x, (pad, pad), mode="replicate")
    k = _proj_in_conv_weight(w)
    K = k.shape[2]
    x = F.pad(x, (K // 2, K // 2), mode="reflect")
    return F.conv1d(x, k, b)


def upsample_plain(x: torch.Tensor, up: UpsampleWeights,
                   slope: float = NEGATIVE_SLOPE) -> torch.Tensor:
    """(B, C_in, T) -> leaky -> polyphase transposed conv -> (B, C_out, T*f)."""
    B, _, T = x.shape
    lx = F.pad(F.leaky_relu(x, slope), (1, 1))        # frames [-1, T]
    phases = []
    for p in range(up.factor):
        q = (p + up.padding) // up.factor
        wa, wb = _phase_taps(up, p)
        a = lx[:, :, 1 + q:1 + q + T]                  # frame u + q
        b = lx[:, :, q:q + T]                          # frame u + q - 1
        phases.append(torch.einsum("io,bit->bot", wa, a)
                      + torch.einsum("io,bit->bot", wb, b))
    y = torch.stack(phases, dim=-1).reshape(B, -1, T * up.factor)
    return y + up.bias[None, :, None]


def tail_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               syn: Optional[torch.Tensor], syn_q: int,
               slope: float = NEGATIVE_SLOPE) -> torch.Tensor:
    """(B, C, T) -> leaky -> reflect conv -> tanh -> PQMF synthesis:
    (B, T*N, 1) waveform, or (B, T, N) subbands without ``syn``."""
    K = w.shape[1]
    y = F.pad(F.leaky_relu(x, slope), (K // 2, K // 2), mode="reflect")
    sub = torch.tanh(F.conv1d(y, w.permute(2, 0, 1), b))    # (B, N, T)
    if syn is None:
        return sub.transpose(1, 2).contiguous()
    B, N, T = sub.shape
    J = syn.shape[0]
    sp = F.pad(sub, (syn_q, J - 1 - syn_q))
    phases = F.conv1d(sp, syn.permute(2, 1, 0))              # (B, N, T)
    return phases.transpose(1, 2).reshape(B, T * N, 1)


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------

def _lib():
    return build.library("fused_melgan", _SIGNATURES)


def proj_in_cuda(mel: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 pad: int) -> torch.Tensor:
    build.require_cuda_f32("mel", mel)
    B, T, Cm = mel.shape
    g, _, K, _ = w.shape
    Co = 4 * g
    build.require_cuda_f32("proj_in_w", w, (g, Cm, K, 4))
    build.require_cuda_f32("proj_in_b", b, (Co,))
    if T + 2 * pad <= K // 2:
        raise ValueError(f"{T} mel frames are too few for a k={K} conv")
    lib = _lib()
    out = torch.empty((B, Co, T + 2 * pad), device=mel.device,
                      dtype=torch.float32)
    err = lib.melgan_proj_in(build.ptr(mel), build.ptr(out), build.ptr(w),
                             build.ptr(b), B, T, Cm, Co, K, pad,
                             build.stream_handle(mel.device))
    build.check(lib, PROJ_IN, err)
    return out


def upsample_cuda(x: torch.Tensor, up: UpsampleWeights) -> torch.Tensor:
    build.require_cuda_f32("x", x)
    B, Ci, T = x.shape
    f = up.factor
    Co = 4 * up.w.shape[1]
    build.require_cuda_f32("upsample_w", up.w, (f, Co // 4, Ci, 2, 4))
    build.require_cuda_f32("upsample_b", up.bias, (Co,))
    lib = _lib()
    out = torch.empty((B, Co, T * f), device=x.device, dtype=torch.float32)
    err = lib.melgan_upsample(build.ptr(x), build.ptr(out), build.ptr(up.w),
                              build.ptr(up.bias), B, Ci, Co, T, f, up.padding,
                              NEGATIVE_SLOPE, build.stream_handle(x.device))
    build.check(lib, UPSAMPLE, err)
    return out


def tail_cuda(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              syn: Optional[torch.Tensor], syn_q: int) -> torch.Tensor:
    build.require_cuda_f32("x", x)
    B, C, T = x.shape
    _, K, N = w.shape
    build.require_cuda_f32("proj_out_w", w, (C, K, N))
    build.require_cuda_f32("proj_out_b", b, (N,))
    J = 0
    if syn is not None:
        J = syn.shape[0]
        build.require_cuda_f32("syn", syn, (J, N, N))
    if T <= K // 2:
        raise ValueError(f"{T} samples are too few for a k={K} conv")
    lib = _lib()
    shape = (B, T * N, 1) if J else (B, T, N)
    out = torch.empty(shape, device=x.device, dtype=torch.float32)
    err = lib.melgan_tail(build.ptr(x), build.ptr(out), build.ptr(w),
                          build.ptr(b), build.ptr(syn) if J else None, B, C, T,
                          N, K, J, syn_q, NEGATIVE_SLOPE,
                          build.stream_handle(x.device))
    build.check(lib, TAIL, err)
    return out


# ---------------------------------------------------------------------------
# entry points (tts_tpu's layout: mel (B, T, n_mels) in, NWC out)
# ---------------------------------------------------------------------------

def _generator(weights: GeneratorWeights, mel: torch.Tensor,
               pad: int) -> torch.Tensor:
    on_cpu = mel.device.type == "cpu"
    x = (proj_in_plain if on_cpu else proj_in_cuda)(
        mel, weights.proj_in_w, weights.proj_in_b, pad)
    for up, stack in zip(weights.upsamples, weights.stacks):
        x = upsample_plain(x, up) if on_cpu else upsample_cuda(x, up)
        x = residual_stack_nct(x, *stack)
    return (tail_plain if on_cpu else tail_cuda)(
        x, weights.proj_out_w, weights.proj_out_b, weights.syn,
        weights.syn_q)


def megakernel_generator_apply(gen, weights: GeneratorWeights,
                               c: torch.Tensor) -> torch.Tensor:
    """Generator forward without inference padding: c (B, T, n_mels) ->
    (B, T*hop*N, 1) waveform when the weights carry the PQMF bank, else
    (B, T*hop, out_channels)."""
    return _generator(weights, c, 0)


def megakernel_inference(gen, weights: GeneratorWeights,
                         mel: torch.Tensor) -> torch.Tensor:
    """Serving entry: edge pad of ``gen.inference_padding`` frames (inside
    the proj_in kernel) + the whole generator + PQMF synthesis. mel
    (B, T, n_mels) -> waveform (B, (T + 2*pad)*hop*N, 1)."""
    return _generator(weights, mel, gen.inference_padding)

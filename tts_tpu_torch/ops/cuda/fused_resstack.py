"""Fused MelGAN residual stack: CUDA kernel (``fused_resstack.cu``) and its
plain PyTorch version.

Replaces ``tts_tpu/ops/pallas/fused_resstack.py::fused_residual_stack`` (the
pallas_call in ``_fused_stack_packed``). The stack runs one launch per
residual block: leaky -> reflect-padded dilated conv (k=3, d=3^j) -> leaky ->
1x1 conv, plus a 1x1 shortcut of the block input, added. Bound on the card:
operations (10*C fp32 MACs per element moved); see the source for the design.

A CUDA tensor launches the kernel (or raises); a CPU tensor takes the plain
version, which is what the CPU tests hold against ``tts_tpu``.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from tts_tpu_torch.ops.cuda import build

KERNEL = "fused_residual_stack"
NEGATIVE_SLOPE = 0.2

_P, _L, _I, _F = ctypes.c_void_p, ctypes.c_long, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "resblock_forward": (ctypes.c_int, [_P, _L, _L, _L, _P, _L, _L, _L, _P, _P,
                                        _P, _P, _I, _I, _I, _I, _F, _P]),
}

StackWeights = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def pack_stack_params(state_dict: Dict[str, torch.Tensor], prefix: str,
                      num_res_blocks: int) -> StackWeights:
    """A folded ``ResidualStack`` (Mozilla names under ``prefix``) -> the
    kernel's operands, float32, grouped by 4 output channels:

    w1 (n, C/4, C_in, 3, 4): the dilated conv; b1 (n, C);
    w2 (n, C/4, 2C, 4): rows [0, C) the 1x1 conv2 (over leaky(h)), rows
    [C, 2C) the 1x1 shortcut (over x); bout (n, C) = both biases."""
    w1s, b1s, w2s, bouts = [], [], [], []
    for j in range(num_res_blocks):
        k1 = state_dict[f"{prefix}.blocks.{j}.2.weight"].float()   # (C, C, 3)
        k2 = state_dict[f"{prefix}.blocks.{j}.4.weight"].float()[:, :, 0]
        ksc = state_dict[f"{prefix}.shortcuts.{j}.weight"].float()[:, :, 0]
        C = k1.shape[0]
        if C % 4:
            raise ValueError(f"the residual-stack kernel needs C % 4 == 0, "
                             f"got {C}")
        w1s.append(k1.reshape(C // 4, 4, C, 3).permute(0, 2, 3, 1))
        b1s.append(state_dict[f"{prefix}.blocks.{j}.2.bias"].float())
        w2s.append(torch.cat([k2, ksc], dim=1).reshape(C // 4, 4, 2 * C)
                   .permute(0, 2, 1))
        bouts.append(state_dict[f"{prefix}.blocks.{j}.4.bias"].float()
                     + state_dict[f"{prefix}.shortcuts.{j}.bias"].float())
    return tuple(torch.stack(t).contiguous() for t in (w1s, b1s, w2s, bouts))


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def residual_block_plain(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                         w2: torch.Tensor, bout: torch.Tensor, dilation: int,
                         slope: float = NEGATIVE_SLOPE) -> torch.Tensor:
    """One block on (B, C, T) with one block's packed weights."""
    C = x.shape[1]
    k1 = w1.permute(0, 3, 1, 2).reshape(C, C, 3)          # (C_out, C_in, 3)
    k2 = w2.permute(0, 2, 1).reshape(C, 2 * C)            # (C_out, [h; x])
    y = F.pad(F.leaky_relu(x, slope), (dilation, dilation), mode="reflect")
    h = F.leaky_relu(F.conv1d(y, k1, b1, dilation=dilation), slope)
    return (F.conv1d(h, k2[:, :C, None]) + F.conv1d(x, k2[:, C:, None])
            + bout[None, :, None])


# ---------------------------------------------------------------------------
# kernel launch
# ---------------------------------------------------------------------------

def _check_operands(C: int, T: int, w1, b1, w2, bout) -> int:
    n = w1.shape[0]
    for name, t, shape in (("w1", w1, (n, C // 4, C, 3, 4)),
                           ("b1", b1, (n, C)),
                           ("w2", w2, (n, C // 4, 2 * C, 4)),
                           ("bout", bout, (n, C))):
        build.require_cuda_f32(name, t, shape)
    if C % 4:
        raise ValueError(f"the residual-stack kernel needs C % 4 == 0, got {C}")
    if T <= 3 ** (n - 1):
        raise ValueError(f"sequence of {T} samples is too short for "
                         f"dilation {3 ** (n - 1)}")
    return n


def _launch_block(x: torch.Tensor, x_strides, out: torch.Tensor, out_strides,
                  w1, b1, w2, bout, B: int, C: int, T: int,
                  dilation: int) -> None:
    lib = build.library("fused_resstack", _SIGNATURES)
    err = lib.resblock_forward(
        build.ptr(x), *x_strides, build.ptr(out), *out_strides,
        build.ptr(w1), build.ptr(b1), build.ptr(w2), build.ptr(bout),
        B, C, T, dilation, NEGATIVE_SLOPE, build.stream_handle(x.device))
    build.check(lib, KERNEL, err)


def _stack_cuda(x: torch.Tensor, x_strides, out: torch.Tensor, out_strides,
                w1, b1, w2, bout, B: int, C: int, T: int) -> None:
    """Run the n blocks, ping-ponging (B, C, T) scratch buffers between
    them; the first reads ``x`` and the last writes ``out`` through their
    (batch, channel, time) strides."""
    n = _check_operands(C, T, w1, b1, w2, bout)
    nct = (C * T, T, 1)
    bufs = [torch.empty((B, C, T), device=x.device, dtype=torch.float32)
            for _ in range(min(n - 1, 2))]
    src, src_strides = x, x_strides
    for j in range(n):
        last = j == n - 1
        dst, dst_strides = (out, out_strides) if last else (bufs[j % 2], nct)
        _launch_block(src, src_strides, dst, dst_strides, w1[j], b1[j], w2[j],
                      bout[j], B, C, T, 3 ** j)
        src, src_strides = dst, dst_strides


def residual_stack_nct(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                       w2: torch.Tensor, bout: torch.Tensor) -> torch.Tensor:
    """(B, C, T) -> (B, C, T): the layout the generator keeps between
    stages."""
    if x.device.type == "cpu":
        for j in range(w1.shape[0]):
            x = residual_block_plain(x, w1[j], b1[j], w2[j], bout[j], 3 ** j)
        return x
    build.require_cuda_f32("x", x)
    B, C, T = x.shape
    out = torch.empty_like(x)
    _stack_cuda(x, (C * T, T, 1), out, (C * T, T, 1), w1, b1, w2, bout,
                B, C, T)
    return out


def fused_residual_stack(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                         w2: torch.Tensor, bout: torch.Tensor) -> torch.Tensor:
    """tts_tpu's layout: x (B, T, C) -> (B, T, C). The kernel reads and
    writes (B, T, C) through strides, so no transpose runs on the card."""
    if x.device.type == "cpu":
        y = residual_stack_nct(x.transpose(1, 2), w1, b1, w2, bout)
        return y.transpose(1, 2).contiguous()
    build.require_cuda_f32("x", x)
    B, T, C = x.shape
    out = torch.empty_like(x)
    _stack_cuda(x, (T * C, 1, C), out, (T * C, 1, C), w1, b1, w2, bout,
                B, C, T)
    return out

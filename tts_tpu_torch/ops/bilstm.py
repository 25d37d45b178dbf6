"""Bidirectional LSTM over ragged lengths (≙ tts_tpu/ops/pallas/
fused_bilstm.py: ``flip_sequences``, ``fused_bilstm``).

As in tts_tpu, the reversal is done outside the recurrence: the backward
direction scans ``flip_sequences(x, lengths)`` forward over all T steps
(padding included) and its output is flipped back, which equals a flax
``Bidirectional`` with ``seq_lengths`` inside each item's length. One step
of either direction is the fused cell

    gates = [x_t, h] @ W + b        W (C + H, 4H), gates i, f, g, o
    c' = f c + i g,  h' = o tanh(c')

``bilstm`` dispatches by device: a CUDA tensor runs the hand-written kernel
(``ops/cuda/bilstm.cu``), a CPU tensor the plain version ``bilstm_torch``.
Both take float32 operands only (tts_tpu's ``compute_dtype=float32``); bf16
operands wait for a tensor-core kernel, and asking for them raises.
"""

from __future__ import annotations

import torch

from tts_tpu_torch.ops.cuda import bilstm as bilstm_cuda


def flip_sequences(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Reverse the first ``lengths[b]`` steps of ``x[b]`` (B, T, ...); the
    index rule is tts_tpu's, ``(len - 1 - t) mod T``, so pad steps are
    permuted, not kept in place."""
    B, T = x.shape[0], x.shape[1]
    t = torch.arange(T, device=x.device)[None, :]
    idx = torch.remainder(lengths.to(x.device).long()[:, None] - 1 - t, T)
    idx = idx.reshape(B, T, *([1] * (x.dim() - 2))).expand_as(x)
    return torch.gather(x, 1, idx)


def _check_operands(x, wf, bf, wb, bb, compute_dtype) -> None:
    if compute_dtype != torch.float32:
        raise ValueError(f"bilstm: only float32 operands are ported, not "
                         f"{compute_dtype} (bf16 waits for tensor cores)")
    for name, t in (("x", x), ("wf", wf), ("bf", bf), ("wb", wb),
                    ("bb", bb)):
        if t.dtype != torch.float32:
            raise ValueError(f"bilstm: {name} must be float32, got "
                             f"{t.dtype}")
    C = x.shape[2]
    H = wf.shape[1] // 4
    for name, w, b in (("forward", wf, bf), ("backward", wb, bb)):
        if tuple(w.shape) != (C + H, 4 * H) or tuple(b.shape) != (4 * H,):
            raise ValueError(f"bilstm: {name} weights must be "
                             f"({C + H}, {4 * H}) and ({4 * H},), got "
                             f"{tuple(w.shape)} and {tuple(b.shape)}")


def lstm_cell(x: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
              w: torch.Tensor, b: torch.Tensor):
    """The fused cell, plain: (h', c') from x (B, C), h, c (B, H)."""
    gates = torch.cat([x, h], dim=1) @ w + b
    i, f, g, o = gates.split(h.shape[1], dim=1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def _scan_torch(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                ) -> torch.Tensor:
    """One direction, forward over all steps: (B, T, C) -> (B, T, H)."""
    B, T, _ = x.shape
    h = c = x.new_zeros(B, w.shape[1] // 4)
    out = []
    for t in range(T):
        h, c = lstm_cell(x[:, t], h, c, w, b)
        out.append(h)
    return torch.stack(out, dim=1)


def bilstm_torch(x: torch.Tensor, lengths: torch.Tensor, wf: torch.Tensor,
                 bf: torch.Tensor, wb: torch.Tensor, bb: torch.Tensor,
                 compute_dtype=torch.float32) -> torch.Tensor:
    """The plain version: x (B, T, C), lengths (B,), fused weights
    (C + H, 4H) and biases (4H,) per direction -> (B, T, 2H) float32."""
    _check_operands(x, wf, bf, wb, bb, compute_dtype)
    fwd = _scan_torch(x, wf, bf)
    bwd = _scan_torch(flip_sequences(x, lengths), wb, bb)
    return torch.cat([fwd, flip_sequences(bwd, lengths)], dim=-1)


def bilstm(x: torch.Tensor, lengths: torch.Tensor, wf: torch.Tensor,
           bf: torch.Tensor, wb: torch.Tensor, bb: torch.Tensor,
           compute_dtype=torch.float32) -> torch.Tensor:
    """(B, T, C) -> (B, T, 2H): the kernel for a CUDA tensor (it raises on
    what it does not take), the plain version for a CPU tensor."""
    _check_operands(x, wf, bf, wb, bb, compute_dtype)
    if x.device.type == "cpu":
        return bilstm_torch(x, lengths, wf, bf, wb, bb)
    xr = flip_sequences(x, lengths)
    out = bilstm_cuda.bilstm_cuda(x, xr, wf, bf, wb, bb)   # (2, T, B, H)
    fwd = out[0].transpose(0, 1)
    bwd = out[1].transpose(0, 1)
    return torch.cat([fwd, flip_sequences(bwd, lengths)], dim=-1)

"""Monotonic alignment search and duration -> path
(≙ tts_tpu/ops/mas.py: ``maximum_path``, ``maximum_path_jnp``,
``generate_path``).

``maximum_path`` dispatches by device: a CUDA tensor runs the hand-written
kernel (``ops/cuda/mas.cu``), a CPU tensor the plain PyTorch version
``maximum_path_torch``. Both compute in float32 with the same order of
operations, so their paths are equal bit for bit."""

from __future__ import annotations

import torch

from tts_tpu_torch.ops.cuda import mas as mas_cuda

_NEG = -1e9


def maximum_path_torch(value: torch.Tensor, mask: torch.Tensor
                       ) -> torch.Tensor:
    """Best monotonic alignment path, the plain version (≙
    ``maximum_path_jnp``): a loop over mel columns, vectorized over batch and
    text.

    value: (B, T_x, T_y) float32 log-likelihoods (text x mel); mask: same
    shape, 1 inside each item's (t_x, t_y) rectangle. Returns the 0/1 path
    (B, T_x, T_y), float32, multiplied by ``mask``. In the backtrack x never
    steps below 0 (the guard of tts_tpu's numpy oracle)."""
    B, T_x, T_y = value.shape
    dev = value.device
    value = torch.where(mask > 0, value, torch.zeros((), device=dev)).float()
    t_xs = (mask[:, :, 0] > 0).sum(dim=1)
    t_ys = (mask[:, 0, :] > 0).sum(dim=1)
    xs = torch.arange(T_x, device=dev)
    neg = torch.full((), _NEG, dtype=torch.float32, device=dev)
    # the diagonal into x = 0: from the start at y = 0, from nowhere after
    start = torch.zeros((B, 1), device=dev)
    nowhere = torch.full((B, 1), _NEG, device=dev)

    # forward: best score per (x, y); decision = came diagonally from x-1
    prev = torch.full((B, T_x), _NEG, device=dev)
    decisions = torch.empty((T_y, B, T_x), dtype=torch.bool, device=dev)
    for y in range(T_y):
        stay = torch.where(xs == y, neg, prev)
        diag = torch.cat([start if y == 0 else nowhere, prev[:, :-1]], dim=1)
        decisions[y] = diag >= stay
        prev = torch.maximum(stay, diag) + value[:, :, y]

    # backtrack from (t_x - 1, t_y - 1), all items at once
    path = torch.zeros((B, T_x, T_y), device=dev)
    items = torch.arange(B, device=dev)
    cur = torch.zeros(B, dtype=torch.long, device=dev)
    for y in range(T_y - 1, -1, -1):
        cur = torch.where(t_ys - 1 == y, t_xs - 1, cur)
        active = t_ys > y
        path[items, cur, y] = active.float()
        moved = decisions[y].gather(1, cur[:, None])[:, 0]
        step = active & moved & (cur > 0) & (y > 0)
        cur = cur - step.long()
    return path * mask


def maximum_path(value: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(B, T_x, T_y) float32 ``value`` and ``mask`` -> 0/1 path of the same
    shape. The kernel for a CUDA tensor (it raises on what it does not
    take), the plain version for a CPU tensor."""
    if value.device.type == "cpu":
        return maximum_path_torch(value, mask)
    return mas_cuda.maximum_path_cuda(value, mask)


def generate_path(durations: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """durations: (B, T_x) int frame counts; mask: (B, T_x, T_y).
    Returns the hard monotonic path (B, T_x, T_y) in ``mask``'s dtype."""
    T_y = mask.shape[2]
    ends = torch.cumsum(durations, dim=1)[:, :, None]          # (B, T_x, 1)
    starts = torch.cat([torch.zeros_like(ends[:, :1]), ends[:, :-1]], dim=1)
    ys = torch.arange(T_y, device=mask.device)[None, None, :]
    path = ((ys >= starts) & (ys < ends)).to(mask.dtype)
    return path * mask

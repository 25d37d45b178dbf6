"""Duration -> alignment path (≙ tts_tpu/ops/mas.py::generate_path).

Only the inference-side companion is ported; the monotonic alignment search
itself (``maximum_path``) comes with Glow-TTS training."""

from __future__ import annotations

import torch


def generate_path(durations: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """durations: (B, T_x) int frame counts; mask: (B, T_x, T_y).
    Returns the hard monotonic path (B, T_x, T_y) in ``mask``'s dtype."""
    T_y = mask.shape[2]
    ends = torch.cumsum(durations, dim=1)[:, :, None]          # (B, T_x, 1)
    starts = torch.cat([torch.zeros_like(ends[:, :1]), ends[:, :-1]], dim=1)
    ys = torch.arange(T_y, device=mask.device)[None, None, :]
    path = ((ys >= starts) & (ys < ends)).to(mask.dtype)
    return path * mask

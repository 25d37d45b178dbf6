"""Length masking (≙ tts_tpu/ops/masking.py)."""

from __future__ import annotations

import torch


def sequence_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """(B,) int lengths -> (B, max_len) bool mask; True inside the sequence."""
    pos = torch.arange(max_len, dtype=lengths.dtype, device=lengths.device)
    return pos[None, :] < lengths[:, None]

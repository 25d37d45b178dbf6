"""Attention diagnostics (≙ tts_tpu/utils/measures.py)."""

from __future__ import annotations

import numpy as np


def alignment_diagonal_score(alignments, binary: bool = False) -> float:
    """Mean of the largest attention weight of each decoder step: how close
    an alignment (B, T_dec, T_in) is to a clean monotonic path."""
    align = np.asarray(alignments)
    maxs = align.max(axis=-1)
    if binary:
        maxs = (maxs > 0.5).astype(np.float32)
    return float(maxs.mean())

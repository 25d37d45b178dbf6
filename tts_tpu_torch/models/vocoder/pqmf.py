"""PQMF synthesis filterbank (≙ tts_tpu/models/vocoder/pqmf.py).

The Kaiser-windowed prototype and its cosine-modulated synthesis filters are
designed with scipy as in tts_tpu; synthesis runs POLYPHASE at frame rate:
phase p of output frame t is sum_j sum_c syn[j, c, p] * sub[c, t + j - q],
zero outside the signal. Analysis comes with GAN training.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def design_prototype_filter(taps: int = 62, cutoff: float = 0.142,
                            beta: float = 9.0) -> np.ndarray:
    """Kaiser-windowed sinc lowpass prototype, length taps + 1."""
    from scipy.signal import firwin

    return firwin(taps + 1, cutoff, window=("kaiser", beta))


class PQMF:
    """N-band synthesis filterbank (stateless; arrays precomputed)."""

    def __init__(self, N: int = 4, taps: int = 62, cutoff: float = 0.142,
                 beta: float = 9.0):
        self.N = N
        self.taps = taps
        h_proto = design_prototype_filter(taps, cutoff, beta)
        n = np.arange(taps + 1)
        G = np.zeros((N, taps + 1))
        for k in range(N):
            phase = (2 * k + 1) * np.pi / (2 * N) * (n - taps / 2)
            G[k] = 2 * h_proto * np.cos(phase - (-1) ** k * np.pi / 4)
        pad = taps // 2
        Ksyn = G.T * N                       # (taps+1, N): tap k, subband c
        J = (taps + 1 + N - 1) // N          # frame taps per phase
        q = pad // N                         # left frame pad
        syn = np.zeros((J, N, N), np.float32)   # (frame tap, subband, phase)
        for p in range(N):
            rp = (pad - p) % N
            for j in range(J):
                k = N * j + rp
                if k <= taps:
                    syn[j, :, p] = Ksyn[k, :]
        self.syn_poly = syn
        self.syn_pad = (q, J - 1 - q)

    def synthesis(self, x: torch.Tensor) -> torch.Tensor:
        """(B, N, T) subbands -> (B, 1, T*N) waveform, in float32."""
        B, N, T = x.shape
        w = torch.from_numpy(np.ascontiguousarray(
            np.transpose(self.syn_poly, (2, 1, 0)))).to(x.device)  # (p, c, j)
        xp = F.pad(x.float(), self.syn_pad)
        phases = F.conv1d(xp, w)                                    # (B, p, T)
        return phases.transpose(1, 2).reshape(B, 1, T * N)

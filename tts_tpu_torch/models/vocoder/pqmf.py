"""PQMF analysis and synthesis filterbank (≙ tts_tpu/models/vocoder/pqmf.py).

The Kaiser-windowed prototype and its cosine-modulated filters are designed
with scipy as in tts_tpu; both directions run POLYPHASE at frame rate.
Synthesis: phase p of output frame t is sum_j sum_c syn[j, c, p] *
sub[c, t + j - q], zero outside the signal. Analysis: subband o of frame t
is sum_j sum_p ana[j, p, o] * x[N (t + j - a) + p], a = ``ana_pad[0]``.
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
    """N-band filterbank (stateless; arrays precomputed)."""

    def __init__(self, N: int = 4, taps: int = 62, cutoff: float = 0.142,
                 beta: float = 9.0):
        self.N = N
        self.taps = taps
        h_proto = design_prototype_filter(taps, cutoff, beta)
        n = np.arange(taps + 1)
        H = np.zeros((N, taps + 1))
        G = np.zeros((N, taps + 1))
        for k in range(N):
            phase = (2 * k + 1) * np.pi / (2 * N) * (n - taps / 2)
            H[k] = 2 * h_proto * np.cos(phase + (-1) ** k * np.pi / 4)
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

        # analysis: sample N (t + u) + p meets tap k = N u + pad + p
        Kana = H.T                           # (taps+1, N): tap k, subband o
        u_lo = -((pad + N - 1) // N)
        u_hi = (taps - pad) // N
        ana = np.zeros((u_hi - u_lo + 1, N, N), np.float32)  # (j, phase, o)
        for p in range(N):
            for u in range(u_lo, u_hi + 1):
                k = N * u + pad + p
                if 0 <= k <= taps:
                    ana[u - u_lo, p, :] = Kana[k, :]
        self.ana_poly = ana
        self.ana_pad = (-u_lo, u_hi)

    def analysis(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 1, T) waveform -> (B, N, T // N) subbands, in float32 whatever
        x's dtype (as tts_tpu)."""
        B, _, T = x.shape
        w = torch.from_numpy(np.ascontiguousarray(
            np.transpose(self.ana_poly, (2, 1, 0)))).to(x.device)  # (o, p, j)
        phases = x.float().reshape(B, T // self.N, self.N).transpose(1, 2)
        return F.conv1d(F.pad(phases, self.ana_pad), w)

    def synthesis(self, x: torch.Tensor) -> torch.Tensor:
        """(B, N, T) subbands -> (B, 1, T*N) waveform, in float32."""
        B, N, T = x.shape
        w = torch.from_numpy(np.ascontiguousarray(
            np.transpose(self.syn_poly, (2, 1, 0)))).to(x.device)  # (p, c, j)
        xp = F.pad(x.float(), self.syn_pad)
        phases = F.conv1d(xp, w)                                    # (B, p, T)
        return phases.transpose(1, 2).reshape(B, 1, T * N)

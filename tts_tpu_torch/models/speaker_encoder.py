"""GE2E speaker encoder: stacked LSTM-with-projection d-vector model
(≙ tts_tpu/models/speaker_encoder.py), with Mozilla TTS's names
(``layers.{i}.lstm.*``, ``layers.{i}.linear.weight``).

Each layer is ``nn.LSTM`` (cuDNN on the card) followed by a bias-free
projection. flax's ``OptimizedLSTMCell`` keeps one bias per gate (on the h
side); torch has two, ``b_ih + b_hh``: the whole bias lives in ``bias_ih``
and ``bias_hh`` is held at zero (``requires_grad`` off), as in the Tacotron2
encoder, so the optimizer and the gradient clip see what tts_tpu's see.
"""

from __future__ import annotations

import torch
from torch import nn


def l2_normalize(x: torch.Tensor) -> torch.Tensor:
    """x / max(||x||, 1e-8) over the last axis."""
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=1e-8)


class LSTMWithProjection(nn.Module):
    def __init__(self, input_size: int, hidden_size: int, proj_size: int):
        super().__init__()
        self.lstm = nn.LSTM(input_size, hidden_size, batch_first=True)
        self.lstm.bias_hh_l0.requires_grad_(False)
        self.linear = nn.Linear(hidden_size, proj_size, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear(self.lstm(x)[0])


class SpeakerEncoder(nn.Module):
    def __init__(self, input_dim: int = 40, proj_dim: int = 256,
                 lstm_dim: int = 768, num_lstm_layers: int = 3):
        super().__init__()
        self.proj_dim = proj_dim
        self.layers = nn.Sequential(*[
            LSTMWithProjection(input_dim if i == 0 else proj_dim, lstm_dim,
                               proj_dim)
            for i in range(num_lstm_layers)])
        # Mozilla's init: Xavier-normal weights, zero biases
        for name, p in self.named_parameters():
            if "bias" in name:
                nn.init.zeros_(p)
            else:
                nn.init.xavier_normal_(p)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """mel (B, T, n_mel) -> L2-normalized d-vector (B, proj_dim) of the
        last frame."""
        return l2_normalize(self.layers(x)[:, -1])

    @torch.no_grad()
    def compute_embedding(self, x: torch.Tensor, num_frames: int = 160,
                          overlap: float = 0.5) -> torch.Tensor:
        """Sliding-window d-vector: windows of ``num_frames`` at a hop of
        ``num_frames * (1 - overlap)``, their d-vectors averaged and
        renormalized; a mel no longer than one window is embedded whole.
        The windows run as one batch."""
        B, T = x.shape[:2]
        if T <= num_frames:
            return self(x)
        hop = max(1, int(num_frames * (1 - overlap)))
        offsets = range(0, T - num_frames + 1, hop)
        windows = torch.cat([x[:, o:o + num_frames] for o in offsets])
        embs = self(windows).view(len(offsets), B, -1)
        return l2_normalize(embs.mean(dim=0))

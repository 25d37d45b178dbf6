"""Speaker-verification losses: GE2E (softmax or contrast) and AngleProto
(≙ tts_tpu/losses/ge2e.py), modules because both learn a scale ``w`` and
an offset ``b`` (0-d parameters, Mozilla's names). Input: d-vectors
(N speakers, M utterances, D).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tts_tpu_torch.models.speaker_encoder import l2_normalize


class _ScaledCosine(nn.Module):
    def __init__(self):
        super().__init__()
        self.w = nn.Parameter(torch.tensor(10.0))       # tts_tpu's init
        self.b = nn.Parameter(torch.tensor(-5.0))

    def scale(self, sim: torch.Tensor) -> torch.Tensor:
        # w floored at 1e-6 (no gradient to w below it)
        return torch.clamp(self.w, min=1e-6) * sim + self.b


class GE2ELoss(_ScaledCosine):
    """Each utterance against every speaker's centroid; its own speaker's
    centroid leaves the utterance out (the sum of the other M - 1, over
    max(M - 1, 1)). ``softmax``: cross-entropy over speakers; ``contrast``:
    1 - sigmoid(own) + the hardest other speaker's sigmoid."""

    def __init__(self, loss_method: str = "softmax"):
        super().__init__()
        if loss_method not in ("softmax", "contrast"):
            raise ValueError(f"unknown GE2E loss method {loss_method!r}")
        self.loss_method = loss_method

    def forward(self, dvecs: torch.Tensor) -> torch.Tensor:
        N, M, _ = dvecs.shape
        centroids = l2_normalize(dvecs.mean(dim=1))                # (N, D)
        excl = (dvecs.sum(dim=1, keepdim=True) - dvecs) / max(M - 1, 1)
        unit = l2_normalize(dvecs)
        sim = torch.einsum("nmd,kd->nmk", unit, centroids)          # (N, M, N)
        own = (unit * l2_normalize(excl)).sum(dim=-1)               # (N, M)
        eye = torch.eye(N, dtype=torch.bool, device=dvecs.device)[:, None]
        sim = self.scale(torch.where(eye, own[:, :, None], sim))
        if self.loss_method == "softmax":
            logp = F.log_softmax(sim, dim=-1)
            return -torch.diagonal(logp, dim1=0, dim2=2).mean()
        sig = torch.sigmoid(sim)
        own_sig = torch.diagonal(sig, dim1=0, dim2=2)
        hardest = sig.masked_fill(eye, float("-inf")).amax(dim=-1)
        return (1.0 - own_sig.t() + hardest).mean()


class AngleProtoLoss(_ScaledCosine):
    """The last utterance of each speaker is the query, the mean of the
    other M - 1 the prototype; cross-entropy over speakers."""

    def forward(self, dvecs: torch.Tensor) -> torch.Tensor:
        query = l2_normalize(dvecs[:, -1])                          # (N, D)
        proto = l2_normalize(dvecs[:, :-1].mean(dim=1))             # (N, D)
        logp = F.log_softmax(self.scale(query @ proto.t()), dim=-1)
        return -torch.diagonal(logp).mean()

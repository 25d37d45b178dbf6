"""GAN-TTS random window discriminators, plain PyTorch (≙
tts_tpu/models/vocoder/rwd.py: ``DBlock``, ``GBlock``, the unconditional and
conditional discriminators and ``RandomWindowDiscriminator``), in (B, C, T)
layout, with tts_tpu's layer names (no Mozilla module has them):
``uncond_{i}`` / ``cond_{i}``, each with ``in_block``, ``down_{j}``
(``res_conv``, ``conv1``, ``conv2``), ``cond_block`` (plus ``cond_conv``)
and ``out``.

tts_tpu draws the crop offsets inside its graph from split keys. Here they
are drawn from an explicit host ``torch.Generator`` (``draw_offsets``) and
handed in (``offsets``), so a caller can use one draw for several calls and
a test can hand in the offsets tts_tpu drew. One offset per window for the
whole batch, as tts_tpu's. tts_tpu's conditioning is optional; its trainer
always passes it, and so the port takes it always.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

MAX_CHANNELS = 512
UNCOND_FACTORS = (8, 4)
BASE_CHANNELS = 64


def frame_rate_factors(hop_length: int) -> Tuple[int, ...]:
    """The conditional branch's audio downsampling chain: 8, 4, 4, 2 as far
    as they divide the hop, then the rest (hop 256: (8, 4, 4, 2))."""
    factors, rem = [], hop_length
    for f in (8, 4, 4, 2):
        if rem % f == 0 and rem > 1:
            factors.append(f)
            rem //= f
    if rem > 1:
        factors.append(rem)
    return tuple(factors)


class DBlock(nn.Module):
    """Average-pool by ``downsample``, then relu -> conv (k 3) -> relu ->
    conv (k 3, dilation 2) plus a 1x1 residual."""

    def __init__(self, in_channels: int, channels: int, downsample: int = 1):
        super().__init__()
        self.downsample = downsample
        self.res_conv = nn.Conv1d(in_channels, channels, 1)
        self.conv1 = nn.Conv1d(in_channels, channels, 3, padding=1)
        self.conv2 = nn.Conv1d(channels, channels, 3, padding=2, dilation=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.downsample > 1:
            x = F.avg_pool1d(x, self.downsample)
        y = self.conv2(F.relu(self.conv1(F.relu(x))))
        return y + self.res_conv(x)


class GBlock(nn.Module):
    """A DBlock without pooling whose first conv's output gets a 1x1
    projection of the conditioning added."""

    def __init__(self, channels: int, cond_channels: int):
        super().__init__()
        self.res_conv = nn.Conv1d(channels, channels, 1)
        self.conv1 = nn.Conv1d(channels, channels, 3, padding=1)
        self.cond_conv = nn.Conv1d(cond_channels, channels, 1)
        self.conv2 = nn.Conv1d(channels, channels, 3, padding=2, dilation=2)

    def forward(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        y = self.conv1(F.relu(x)) + self.cond_conv(cond)
        return self.conv2(F.relu(y)) + self.res_conv(x)


def _dblocks(module: nn.Module, factors: Sequence[int]) -> int:
    ch = BASE_CHANNELS
    module.in_block = DBlock(1, ch, 1)
    for i, f in enumerate(factors):
        nxt = min(ch * f, MAX_CHANNELS)
        module.add_module(f"down_{i}", DBlock(ch, nxt, f))
        ch = nxt
    return ch


class UncondDiscriminator(nn.Module):
    def __init__(self, downsample_factors: Sequence[int] = UNCOND_FACTORS):
        super().__init__()
        self.n_down = len(downsample_factors)
        self.out = nn.Linear(_dblocks(self, downsample_factors), 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.in_block(x)
        for i in range(self.n_down):
            y = getattr(self, f"down_{i}")(y)
        return self.out(F.relu(y).mean(dim=-1))


class CondDiscriminator(nn.Module):
    def __init__(self, audio_downsample_factors: Sequence[int],
                 cond_channels: int = 80):
        super().__init__()
        self.n_down = len(audio_downsample_factors)
        ch = _dblocks(self, audio_downsample_factors)
        self.cond_block = GBlock(ch, cond_channels)
        self.out = nn.Linear(ch, 1)

    def forward(self, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        y = self.in_block(x)
        for i in range(self.n_down):
            y = getattr(self, f"down_{i}")(y)
        T = min(y.shape[-1], c.shape[-1])
        y = self.cond_block(y[..., :T], c[..., :T])
        return self.out(F.relu(y).mean(dim=-1))


class RandomWindowDiscriminator(nn.Module):
    """(x (B, 1, T), c (B, C, T_frames), offsets) -> (scores, []): per
    window size an unconditional score on a crop of x and a conditional
    score on a frame window of c and the audio it covers (scores in the
    order uncond_0, cond_0, uncond_1, ...), at the offsets that
    ``draw_offsets`` draws. Windows longer than the signal are clipped to
    it."""

    def __init__(self, cond_channels: int = 80, hop_length: int = 256,
                 window_sizes: Sequence[int] = (512, 1024, 2048, 4096, 8192)):
        super().__init__()
        self.hop_length = hop_length
        self.window_sizes = tuple(window_sizes)
        factors = frame_rate_factors(hop_length)
        for i in range(len(self.window_sizes)):
            self.add_module(f"uncond_{i}", UncondDiscriminator())
            self.add_module(f"cond_{i}",
                            CondDiscriminator(factors, cond_channels))

    def windows(self, t_audio: int, t_frames: int
                ) -> List[Tuple[int, int, int]]:
        """(audio window, frame window, audio length of the frame window)
        of each window size."""
        out = []
        for ws in self.window_sizes:
            ws = min(ws, t_audio)
            frames = min(max(ws // self.hop_length, 1), t_frames)
            out.append((ws, frames, min(frames * self.hop_length, t_audio)))
        return out

    def draw_offsets(self, t_audio: int, t_frames: int,
                     generator: torch.Generator) -> List[Tuple[int, int]]:
        """(audio crop start, first frame) per window, uniform over the
        valid starts, from one draw of ``generator``, a CPU generator (the
        offsets are host integers, so a draw on the device would wait for
        its queue)."""
        wins = self.windows(t_audio, t_frames)
        u = torch.rand(2 * len(wins), generator=generator,
                       dtype=torch.float64).tolist()
        return [(int(u[2 * i] * (t_audio - ws + 1)),
                 int(u[2 * i + 1] * (t_frames - frames + 1)))
                for i, (ws, frames, _) in enumerate(wins)]

    def forward(self, x: torch.Tensor, c: torch.Tensor,
                offsets: Sequence[Tuple[int, int]]):
        scores = []
        wins = self.windows(x.shape[-1], c.shape[-1])
        for i, ((ws, frames, n_audio), (start, f0)) in enumerate(
                zip(wins, offsets)):
            # as lax.dynamic_slice, a start past the end is clamped
            a0 = min(f0 * self.hop_length, x.shape[-1] - n_audio)
            scores += [getattr(self, f"uncond_{i}")(x[..., start:start + ws]),
                       getattr(self, f"cond_{i}")(x[..., a0:a0 + n_audio],
                                                  c[..., f0:f0 + frames])]
        return scores, []

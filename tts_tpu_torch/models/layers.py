"""Building blocks of the spectrogram models (≙ tts_tpu/models/layers.py:
Prenet, ConvBNBlock, Postnet, Tacotron2Encoder, StopNet), in PyTorch's
(B, C, T) layout for convolutions, with Mozilla TTS's module names so that a
Mozilla Tacotron2 state dict loads as it is.

Eval semantics are tts_tpu's: BatchNorm uses its running statistics
(eps 1e-5, as flax's), and every dropout is gated by train mode (tts_tpu's
prenet comment at layers.py:41-42). In ``train()`` mode BatchNorm
normalises by the batch statistics and updates its running ones as flax's
``BatchNorm(momentum=0.9)`` does, and every dropout draws its mask from the
model's ``torch.Generator`` (``Dropout``).

The port keeps three kinds of Mozilla parameters that tts_tpu does not
have: the conv bias before each BatchNorm, the LSTMs' second bias
(``bias_hh``; tts_tpu has one bias per gate) and the attention's ``v``
bias. They are held fixed (``requires_grad`` off): each is cancelled by
what follows it or duplicates another bias, so training them would change
nothing but the optimizer's state and the gradient norm.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from tts_tpu_torch.models.dropout import Dropout
from tts_tpu_torch.ops.bilstm import bilstm
from tts_tpu_torch.ops.masking import sequence_mask


class Linear(nn.Module):
    """Mozilla's ``Linear`` wrapper: the layer sits under ``linear_layer``."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True):
        super().__init__()
        self.linear_layer = nn.Linear(in_features, out_features, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear_layer(x)


class BatchNorm1d(nn.BatchNorm1d):
    """BatchNorm over the channels of (B, C) or (B, C, T), eps 1e-5. In
    ``train()`` mode it normalises by the batch's statistics and moves the
    running ones ``momentum`` (0.1) of the way to them, the running variance
    to the *biased* batch variance, as flax's ``BatchNorm(momentum=1 -
    momentum)`` does (``torch.nn.BatchNorm1d`` takes the unbiased one). The
    statistics are float32 whatever the input's dtype; in ``eval()`` mode a
    bfloat16 input is normalised in float32 and cast back, as flax does."""

    def __init__(self, num_features: int, momentum: float = 0.1):
        super().__init__(num_features, eps=1e-5, momentum=momentum)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x.float(), self.running_mean,
                                self.running_var, self.weight.float(),
                                self.bias.float(), False, 0.0,
                                self.eps).to(x.dtype)
        with torch.no_grad():
            dims = [0] + list(range(2, x.dim()))
            var, mean = torch.var_mean(x.float(), dim=dims, correction=0)
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
            self.num_batches_tracked.add_(1)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                            self.eps)


def hold_gru_rz_bias(bias_hh: torch.Tensor, hidden: int) -> None:
    """flax's ``GRUCell`` has no hidden-side bias on the r and z gates:
    hold that part of a torch GRU's ``bias_hh`` (gates r, z, n) at zero,
    its gradient dropped by a hook."""
    def hook(grad: torch.Tensor) -> torch.Tensor:
        grad = grad.clone()
        grad[:2 * hidden] = 0
        return grad

    with torch.no_grad():
        bias_hh[:2 * hidden].zero_()
    bias_hh.register_hook(hook)


class LinearBN(Linear):
    """Linear then BatchNorm over the features (prenet_type "bn")."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True):
        super().__init__(in_features, out_features, bias)
        self.batch_normalization = BatchNorm1d(out_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.batch_normalization(self.linear_layer(x))


class Prenet(nn.Module):
    """Bottleneck MLP: per layer linear (-> BN) -> relu (-> dropout 0.5 in
    train mode, "original" type only) (≙ Prenet)."""

    def __init__(self, in_features: int, prenet_type: str = "original",
                 prenet_dropout: bool = True,
                 out_features: Sequence[int] = (256, 256), bias: bool = True):
        super().__init__()
        if prenet_type not in ("original", "bn"):
            raise ValueError(f"unknown prenet_type: {prenet_type}")
        layer = LinearBN if prenet_type == "bn" else Linear
        dims = [in_features, *out_features]
        self.linear_layers = nn.ModuleList(
            layer(i, o, bias=bias) for i, o in zip(dims[:-1], dims[1:]))
        self.prenet_type = prenet_type
        self.dropout = (Dropout(0.5) if prenet_dropout
                        and prenet_type == "original" else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.linear_layers:
            x = torch.relu(layer(x))
            if self.dropout is not None:
                x = self.dropout(x)
        return x


class ConvBNBlock(nn.Module):
    """conv1d (SAME) -> BatchNorm -> activation -> dropout 0.5 in train mode
    (≙ ConvBNBlock). tts_tpu's conv has no bias (BatchNorm cancels it);
    Mozilla's has one, so the port keeps it, held fixed, and a tts_tpu tree
    maps to a zero bias."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 activation: Optional[str] = None):
        super().__init__()
        self.convolution1d = nn.Conv1d(in_channels, out_channels, kernel_size,
                                       padding=(kernel_size - 1) // 2)
        self.convolution1d.bias.requires_grad_(False)
        self.batch_normalization = BatchNorm1d(out_channels)
        if activation not in (None, "relu", "tanh"):
            raise ValueError(f"unknown activation: {activation}")
        self.activation = activation
        self.dropout = Dropout(0.5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.batch_normalization(self.convolution1d(x))
        if self.activation == "relu":
            x = torch.relu(x)
        elif self.activation == "tanh":
            x = torch.tanh(x)
        return self.dropout(x)


class Postnet(nn.Module):
    """4 x ConvBN(512, k=5, tanh) + ConvBN(n_mels, k=5, linear)
    (≙ Postnet). (B, n_mels, T) -> (B, n_mels, T)."""

    def __init__(self, out_channels: int, num_convs: int = 5,
                 hidden_channels: int = 512):
        super().__init__()
        dims = [out_channels] + [hidden_channels] * (num_convs - 1)
        self.convolutions = nn.ModuleList(
            ConvBNBlock(dims[i], dims[i + 1] if i + 1 < num_convs
                        else out_channels, 5,
                        "tanh" if i + 1 < num_convs else None)
            for i in range(num_convs))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.convolutions:
            x = layer(x)
        return x


class Encoder(nn.Module):
    """3 x ConvBN(k=5, relu) + a BiLSTM of C/2 per direction over the
    ragged lengths (≙ Tacotron2Encoder).

    ``lstm`` holds the weights under Mozilla's names (``weight_ih_l0``,
    ``..._reverse``). At eval without grad (serving, eval epochs, test
    sentences) the recurrence runs through ``ops.bilstm.bilstm``: the
    hand-written CUDA kernel (B7) on the card, its plain version on the
    CPU; neither has a backward. In ``train()`` mode or with grad enabled it
    runs through ``lstm`` itself over a packed sequence (cuDNN on the card;
    tts_tpu trains its flax LSTM outside any Pallas kernel too). The two
    agree inside each item's length; past it the outputs differ, and the
    attention's mask leaves them unread."""

    def __init__(self, in_features: int = 512):
        super().__init__()
        self.convolutions = nn.ModuleList(
            ConvBNBlock(in_features, in_features, 5, "relu")
            for _ in range(3))
        self.lstm = nn.LSTM(in_features, in_features // 2, num_layers=1,
                            batch_first=True, bias=True, bidirectional=True)
        self.lstm.bias_hh_l0.requires_grad_(False)
        self.lstm.bias_hh_l0_reverse.requires_grad_(False)

    def packed_lstm(self):
        """(wf, bf, wb, bb): per direction the fused (C + H, 4H) weight
        [W_ih^T; W_hh^T] and the bias b_ih + b_hh, gates i, f, g, o (≙
        ``pack_bilstm_params``)."""
        lstm = self.lstm
        out = []
        for sfx in ("", "_reverse"):
            w = torch.cat([getattr(lstm, f"weight_ih_l0{sfx}").t(),
                           getattr(lstm, f"weight_hh_l0{sfx}").t()], dim=0)
            b = (getattr(lstm, f"bias_ih_l0{sfx}")
                 + getattr(lstm, f"bias_hh_l0{sfx}"))
            out += [w.detach().contiguous(), b.detach().contiguous()]
        return tuple(out)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor,
                mask_pads: bool = False, packed=None) -> torch.Tensor:
        """x (B, C, T) embedded text -> (B, T, C). ``mask_pads`` zeroes the
        pad positions before and after every conv, so a text-length bucket
        gives the unpadded result (serving; tts_tpu's ``mask_pads``).
        ``packed``: ``packed_lstm()``'s result, when the caller keeps it
        (the kernel path only)."""
        mask = None
        if mask_pads:
            mask = sequence_mask(lengths, x.shape[2]).to(x.dtype)[:, None]
            x = x * mask
        for layer in self.convolutions:
            x = layer(x)
            if mask is not None:
                x = x * mask
        # the LSTM computes in its weights' dtype (float32 in mixed
        # precision, as tts_tpu's float32 carry makes its flax LSTM)
        x = x.transpose(1, 2).to(self.lstm.weight_hh_l0.dtype)
        if self.training or torch.is_grad_enabled():
            seq = nn.utils.rnn.pack_padded_sequence(
                x, lengths.cpu().long(), batch_first=True,
                enforce_sorted=False)
            out, _ = nn.utils.rnn.pad_packed_sequence(
                self.lstm(seq)[0], batch_first=True, total_length=x.shape[1])
            return out
        if packed is None:
            packed = self.packed_lstm()
        return bilstm(x.contiguous(), lengths, *packed)

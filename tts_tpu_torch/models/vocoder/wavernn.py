"""WaveRNN vocoder, fatchord's architecture, plain PyTorch (≙
tts_tpu/models/vocoder/wavernn.py: ``mulaw_encode_jnp`` / ``mulaw_decode_jnp``,
``label_to_float``, ``discretized_mix_logistic_loss``,
``sample_from_discretized_mix_logistic``, ``MelResNet``,
``UpsampleNetwork``, ``WaveRNN`` and ``wavernn_loss``).

The module tree is fatchord's (the WaveRNN that Mozilla TTS serves), so its
``state_dict`` loads unchanged and ``tts_tpu/compat/torch_port.py::
port_wavernn`` reads the port's: ``upsample.resnet.{conv_in, batch_norm,
layers.{i}.{conv1, batch_norm1, conv2, batch_norm2}, conv_out}``,
``upsample.up_layers.{2i+1}`` (a bias-free ``Conv2d(1, 1, (1, 2f + 1))``
after each stretch, one filter shared by every mel bin), ``I``, ``rnn1``,
``rnn2`` (``nn.GRU``), ``fc1``, ``fc2``, ``fc3``. BatchNorm is
``models/layers.py::BatchNorm1d`` (flax's biased running variance).
flax's ``GRUCell`` has no hidden-side bias on the r and z gates; torch's
gates add ``b_ih + b_hh`` there, so both packages compute the same function
and the converters put the sum on the input side.

``forward`` is the teacher-forced pass: ``nn.GRU`` over the whole sequence
(cuDNN on the card). ``generate`` steps the same weights one sample at a
time with ``torch.gru_cell``. Everything it does stays on the tensors'
device: its random numbers are drawn up front in one call from the caller's
``torch.Generator`` (one uniform a sample in bits mode, two in mold mode)
and moved once; a sample is drawn by inverting the class CDF at its
uniform (``draw_bits`` / ``draw_mold``), written into a preallocated
buffer and fed back, with no copy to the host and no branch on a tensor.
The inputs that do not depend on the previous sample (the conditioning and
aux parts of ``I``, ``fc1`` and ``fc2``) are projected for every sample in
one product before the loop. Because the draws are torch's, the audio is
not tts_tpu's sample for sample (ROADMAP: kept differences).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tts_tpu_torch.models.layers import BatchNorm1d
from tts_tpu_torch.models.vocoder.pwgan import Stretch2d

LOG_SCALE_MIN = -32.23619130191664


def mulaw_encode(x: torch.Tensor, qc: int) -> torch.Tensor:
    """mu-law companding and quantization to class ids in [0, qc)."""
    mu = qc - 1
    y = torch.sign(x) * torch.log1p(mu * x.abs()) / math.log1p(mu)
    return torch.clamp((y + 1.0) / 2.0 * mu + 0.5, 0, mu).to(torch.int64)


def mulaw_decode(ids: torch.Tensor, qc: int) -> torch.Tensor:
    mu = qc - 1
    y = 2.0 * ids.float() / mu - 1.0
    return torch.sign(y) / mu * (torch.pow(1.0 + mu, y.abs()) - 1.0)


def label_to_float(ids: torch.Tensor, bits: int) -> torch.Tensor:
    """Class id -> the network's input in [-1, 1]."""
    return 2.0 * ids.float() / (2 ** bits - 1.0) - 1.0


def discretized_mix_logistic_loss(y_hat: torch.Tensor, y: torch.Tensor,
                                  num_classes: int = 65536,
                                  log_scale_min: float = LOG_SCALE_MIN
                                  ) -> torch.Tensor:
    """Negative log-likelihood of ``y`` (B, T) in [-1, 1] under the
    discretized mixture of logistics ``y_hat`` (B, T, 3 * nr_mix) =
    [logit_probs, means, log_scales]; mean over batch and time."""
    nr_mix = y_hat.shape[-1] // 3
    logit_probs = y_hat[..., :nr_mix]
    means = y_hat[..., nr_mix:2 * nr_mix]
    log_scales = torch.clamp(y_hat[..., 2 * nr_mix:], min=log_scale_min)
    y = y[..., None]
    centered = y - means
    inv_std = torch.exp(-log_scales)
    half = 1.0 / (num_classes - 1)
    plus_in = inv_std * (centered + half)
    min_in = inv_std * (centered - half)
    log_cdf_plus = plus_in - F.softplus(plus_in)
    log_one_minus_cdf_min = -F.softplus(min_in)
    cdf_delta = torch.sigmoid(plus_in) - torch.sigmoid(min_in)
    mid_in = inv_std * centered
    log_pdf_mid = (mid_in - log_scales - 2.0 * F.softplus(mid_in)
                   + math.log(half * 2.0))
    log_probs = torch.where(
        y < -0.999, log_cdf_plus,
        torch.where(y > 0.999, log_one_minus_cdf_min,
                    torch.where(cdf_delta > 1e-5,
                                torch.log(torch.clamp(cdf_delta, min=1e-12)),
                                log_pdf_mid)))
    log_probs = log_probs + torch.log_softmax(logit_probs, dim=-1)
    return -torch.logsumexp(log_probs, dim=-1).mean()


def wavernn_loss(logits: torch.Tensor, target_ids: torch.Tensor
                 ) -> torch.Tensor:
    """Cross entropy over the quantized sample classes, mean over all."""
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           target_ids.reshape(-1).long())


def _inverse_cdf(probs: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The class whose CDF interval holds ``u``: probs (..., C), u (...)."""
    cdf = torch.cumsum(probs, dim=-1)
    ids = (cdf < u[..., None]).sum(dim=-1)
    return torch.clamp(ids, max=probs.shape[-1] - 1)


def draw_bits(logits: torch.Tensor, u: torch.Tensor,
              temperature: float = 1.0) -> torch.Tensor:
    """Class ids from logits (..., C) at uniforms ``u`` (...): the
    categorical distribution of ``softmax(logits / temperature)``."""
    if temperature != 1.0:
        logits = logits / temperature
    return _inverse_cdf(torch.softmax(logits, dim=-1), u)


def draw_mold(y_hat: torch.Tensor, u_sel: torch.Tensor, u_x: torch.Tensor,
              log_scale_min: float = LOG_SCALE_MIN) -> torch.Tensor:
    """Samples in [-1, 1] from the mixture ``y_hat`` (..., 3 * nr_mix): the
    component by inverting its CDF at ``u_sel``, then the logistic's
    inverse CDF at ``u_x`` (mapped into [1e-5, 1 - 1e-5], as tts_tpu's)."""
    nr_mix = y_hat.shape[-1] // 3
    sel = _inverse_cdf(torch.softmax(y_hat[..., :nr_mix], dim=-1), u_sel)
    sel = sel[..., None]
    means = y_hat[..., nr_mix:2 * nr_mix].gather(-1, sel)[..., 0]
    log_scales = torch.clamp(
        y_hat[..., 2 * nr_mix:].gather(-1, sel)[..., 0], min=log_scale_min)
    u = 1e-5 + (1.0 - 2e-5) * u_x
    x = means + torch.exp(log_scales) * (torch.log(u) - torch.log1p(-u))
    return torch.clamp(x, -1.0, 1.0)


def sample_from_discretized_mix_logistic(
        y_hat: torch.Tensor, generator: Optional[torch.Generator] = None,
        log_scale_min: float = LOG_SCALE_MIN) -> torch.Tensor:
    """One step's samples (B,) from ``y_hat`` (B, 3 * nr_mix), both draws
    from ``generator``."""
    u = torch.rand((2,) + y_hat.shape[:-1], generator=generator,
                   device=generator.device if generator is not None
                   else y_hat.device).to(y_hat.device)
    return draw_mold(y_hat, u[0], u[1], log_scale_min)


def boundary_distance(logits: torch.Tensor, u: torch.Tensor,
                      temperature: float = 1.0) -> torch.Tensor:
    """How far each uniform ``u`` lies from the nearest edge of the class
    CDF of ``logits`` (bits mode; for mold, pass the mixture logits)."""
    if temperature != 1.0:
        logits = logits / temperature
    cdf = torch.cumsum(torch.softmax(logits, dim=-1), dim=-1)
    return (cdf - u[..., None]).abs().amin(dim=-1)


class ResBlock(nn.Module):
    def __init__(self, dims: int):
        super().__init__()
        self.conv1 = nn.Conv1d(dims, dims, 1, bias=False)
        self.conv2 = nn.Conv1d(dims, dims, 1, bias=False)
        self.batch_norm1 = BatchNorm1d(dims)
        self.batch_norm2 = BatchNorm1d(dims)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.batch_norm1(self.conv1(x)))
        return self.batch_norm2(self.conv2(y)) + x


class MelResNet(nn.Module):
    """A (2 pad + 1)-tap conv without padding (``pad`` context frames are
    used up on each side), BatchNorm and ReLU, ``res_blocks`` 1x1 residual
    blocks, then a 1x1 conv with bias."""

    def __init__(self, res_blocks: int, in_dims: int, compute_dims: int,
                 res_out_dims: int, pad: int):
        super().__init__()
        self.conv_in = nn.Conv1d(in_dims, compute_dims, 2 * pad + 1,
                                 bias=False)
        self.batch_norm = BatchNorm1d(compute_dims)
        self.layers = nn.ModuleList([ResBlock(compute_dims)
                                     for _ in range(res_blocks)])
        self.conv_out = nn.Conv1d(compute_dims, res_out_dims, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.batch_norm(self.conv_in(x)))
        for layer in self.layers:
            x = layer(x)
        return self.conv_out(x)


class UpsampleNetwork(nn.Module):
    """mel (B, M, T) -> (cond (B, (T - 2 pad) hop, M), aux (B, (T - 2 pad)
    hop, res_out_dims)): the aux path is the MelResNet repeated ``hop``
    times; the conditioning path stretches and smooths the mel per factor f
    with one (2f + 1)-tap filter that every bin shares (SAME padding), then
    crops ``pad * hop`` samples at both ends."""

    def __init__(self, feat_dims: int, upsample_factors: Sequence[int],
                 compute_dims: int, res_blocks: int, res_out_dims: int,
                 pad: int):
        super().__init__()
        self.hop = math.prod(upsample_factors)
        self.indent = pad * self.hop
        self.resnet = MelResNet(res_blocks, feat_dims, compute_dims,
                                res_out_dims, pad)
        layers = []
        for f in upsample_factors:
            conv = nn.Conv2d(1, 1, (1, 2 * f + 1), padding=(0, f),
                             bias=False)
            nn.init.constant_(conv.weight, 1.0 / (2 * f + 1))
            layers += [Stretch2d(f), conv]
        self.up_layers = nn.ModuleList(layers)

    def forward(self, mel: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        aux = self.resnet(mel).repeat_interleave(self.hop, dim=-1)
        m = mel[:, None]
        for layer in self.up_layers:
            m = layer(m)
        m = m[:, 0, :, self.indent:m.shape[-1] - self.indent]
        return m.transpose(1, 2), aux.transpose(1, 2)


class WaveRNN(nn.Module):
    """fatchord's WaveRNN. ``mode="bits"``: a categorical over 2**bits
    (mu-law when ``mulaw``) classes; ``"mold"``: a discretized mixture of
    ``nr_mix`` logistics over raw samples in [-1, 1]."""

    def __init__(self, bits: int = 10, rnn_dims: int = 512,
                 fc_dims: int = 512, feat_dims: int = 80,
                 compute_dims: int = 128, res_out_dims: int = 128,
                 res_blocks: int = 10, pad: int = 2,
                 upsample_factors: Sequence[int] = (4, 8, 8),
                 mulaw: bool = True, mode: str = "bits", nr_mix: int = 10):
        super().__init__()
        if mode not in ("bits", "mold"):
            raise ValueError(f"unknown WaveRNN mode {mode!r}")
        self.bits, self.mode, self.mulaw = bits, mode, mulaw
        self.pad = pad
        self.rnn_dims = rnn_dims
        self.upsample_factors = tuple(upsample_factors)
        self.aux_dims = res_out_dims // 4
        last_aux = res_out_dims - 3 * self.aux_dims
        self.n_classes = 3 * nr_mix if mode == "mold" else 2 ** bits
        self.upsample = UpsampleNetwork(feat_dims, upsample_factors,
                                        compute_dims, res_blocks,
                                        res_out_dims, pad)
        self.I = nn.Linear(feat_dims + self.aux_dims + 1, rnn_dims)
        self.rnn1 = nn.GRU(rnn_dims, rnn_dims, batch_first=True)
        self.rnn2 = nn.GRU(rnn_dims + self.aux_dims, rnn_dims,
                           batch_first=True)
        self.fc1 = nn.Linear(rnn_dims + self.aux_dims, fc_dims)
        self.fc2 = nn.Linear(fc_dims + last_aux, fc_dims)
        self.fc3 = nn.Linear(fc_dims, self.n_classes)

    @property
    def hop(self) -> int:
        return self.upsample.hop

    def features(self, mel: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """(cond, a1, a2, a3, a4), each (B, T_samples, .)."""
        cond, aux = self.upsample(mel)
        d = self.aux_dims
        return (cond, aux[..., :d], aux[..., d:2 * d], aux[..., 2 * d:3 * d],
                aux[..., 3 * d:])

    def forward(self, x: torch.Tensor, mel: torch.Tensor) -> torch.Tensor:
        """Teacher-forced pass (≙ ``WaveRNN.__call__``): x (B, T_samples)
        previous samples in [-1, 1]; mel (B, M, T_frames) with ``pad``
        context frames each side, T_samples = (T_frames - 2 pad) * hop.
        Returns logits (B, T_samples, n_classes)."""
        cond, a1, a2, a3, a4 = self.features(mel)
        h = self.I(torch.cat([x[..., None], cond, a1], dim=-1))
        out1, _ = self.rnn1(h)
        h = h + out1
        out2, _ = self.rnn2(torch.cat([h, a2], dim=-1))
        h = h + out2
        h = F.relu(self.fc1(torch.cat([h, a3], dim=-1)))
        h = F.relu(self.fc2(torch.cat([h, a4], dim=-1)))
        return self.fc3(h)

    def draws(self, batch: int, samples: int,
              generator: Optional[torch.Generator],
              device: torch.device) -> torch.Tensor:
        """Every uniform that ``generate`` reads, in one call on the
        generator's device, moved once: (1 or 2, B, T_samples)."""
        n = 2 if self.mode == "mold" else 1
        gen_device = generator.device if generator is not None else device
        return torch.rand((n, batch, samples), generator=generator,
                          device=gen_device).to(device)

    @torch.no_grad()
    def sample_loop(self, mel: torch.Tensor, u: torch.Tensor,
                    temperature: float = 1.0) -> torch.Tensor:
        """The autoregressive loop at the uniforms ``u`` (``draws``):
        class ids (B, T_samples, int64) in bits mode, samples in [-1, 1]
        in mold mode."""
        cond, a1, a2, a3, a4 = self.features(mel)
        B, T = cond.shape[:2]
        R = self.rnn_dims
        # what does not depend on the previous sample, for every sample
        w_x = self.I.weight[:, 0]
        pre_i = F.linear(torch.cat([cond, a1], dim=-1), self.I.weight[:, 1:],
                         self.I.bias)
        pre_1 = F.linear(a3, self.fc1.weight[:, R:], self.fc1.bias)
        fc_dims = self.fc2.in_features - a4.shape[-1]
        pre_2 = F.linear(a4, self.fc2.weight[:, fc_dims:], self.fc2.bias)
        w1_h = self.fc1.weight[:, :R].t()
        w2_h = self.fc2.weight[:, :fc_dims].t()
        w3 = self.fc3.weight.t()
        g1 = (self.rnn1.weight_ih_l0, self.rnn1.weight_hh_l0,
              self.rnn1.bias_ih_l0, self.rnn1.bias_hh_l0)
        g2 = (self.rnn2.weight_ih_l0, self.rnn2.weight_hh_l0,
              self.rnn2.bias_ih_l0, self.rnn2.bias_hh_l0)

        mold = self.mode == "mold"
        out = cond.new_zeros((B, T)) if mold else torch.zeros(
            (B, T), dtype=torch.int64, device=cond.device)
        h1 = cond.new_zeros((B, R))
        h2 = cond.new_zeros((B, R))
        x_prev = cond.new_zeros((B,))
        for t in range(T):
            h = torch.addcmul(pre_i[:, t], x_prev[:, None], w_x)
            h1 = torch.gru_cell(h, h1, *g1)
            h = h + h1
            h2 = torch.gru_cell(torch.cat([h, a2[:, t]], dim=-1), h2, *g2)
            h = h + h2
            h = torch.relu(torch.addmm(pre_1[:, t], h, w1_h))
            h = torch.relu(torch.addmm(pre_2[:, t], h, w2_h))
            logits = torch.addmm(self.fc3.bias, h, w3)
            if mold:
                x_prev = draw_mold(logits, u[0, :, t], u[1, :, t])
                out[:, t] = x_prev
            else:
                ids = draw_bits(logits, u[0, :, t], temperature)
                out[:, t] = ids
                x_prev = label_to_float(ids, self.bits)
        return out

    def waveform(self, samples: torch.Tensor) -> torch.Tensor:
        """``sample_loop``'s output -> float waveform in [-1, 1]."""
        if self.mode == "mold":
            return samples
        if self.mulaw:
            return mulaw_decode(samples, 2 ** self.bits)
        return label_to_float(samples, self.bits)

    @torch.no_grad()
    def generate(self, mel: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 temperature: float = 1.0) -> torch.Tensor:
        """Autoregressive sampling (≙ ``WaveRNN.generate``): mel (B, M,
        T_frames) with ``pad`` context frames each side -> waveform (B,
        T_samples) in [-1, 1] (mu-law expanded when ``mulaw``)."""
        T = (mel.shape[-1] - 2 * self.pad) * self.hop
        u = self.draws(mel.shape[0], T, generator, mel.device)
        return self.waveform(self.sample_loop(mel, u, temperature))

    def previous_samples(self, samples: torch.Tensor) -> torch.Tensor:
        """The teacher-forced input that ``sample_loop``'s output fed back:
        its samples shifted right by one, as network inputs (0 first)."""
        x = samples if self.mode == "mold" else label_to_float(samples,
                                                                self.bits)
        return F.pad(x[:, :-1], (1, 0))

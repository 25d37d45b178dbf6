"""Glow-TTS: text encoder (transformer, gated convs or time-depth-separable
convs: ``encoder_type``) + duration predictor + flow decoder + MAS
(≙ tts_tpu/models/glow_tts.py).

Training (``forward``) runs the mel through the flows to the latent z,
builds the (text x frame) Gaussian log-likelihood map and finds the best
monotonic alignment with ``maximum_path`` (the CUDA kernel on the card),
both without gradient, as tts_tpu's ``stop_gradient``s; then it expands the
encoder statistics through that alignment. ``glow_tts_loss`` is the flow MLE
plus the duration loss; ``apply_ddi`` the data-dependent ActNorm init.
Inference runs the encoder as one fused call (B3: the hand-written kernels on
the card) where the configuration allows, expands the statistics by
predicted durations (``generate_path``) and inverts the flows.

With ``num_speakers`` > 1 a speaker embedding ``emb_g`` (64 wide, as
tts_tpu's registry builds it) conditions the duration predictor and every
coupling block; external speaker embeddings of that width
(``speaker_embeddings``) take precedence over ids, as in tts_tpu. B3
computes the encoder without speakers, so such a model runs its encoder
module.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn

from tts_tpu_torch.models.dropout import set_generator
from tts_tpu_torch.models.glow.decoder import FlowDecoder
from tts_tpu_torch.models.glow.encoder import GlowTTSEncoder
from tts_tpu_torch.models.glow.flows import ActNorm
from tts_tpu_torch.ops.glow_encoder import (fused_encoder_max_length,
                                            fused_glow_encoder,
                                            supports_fused_encoder)
from tts_tpu_torch.ops.mas import generate_path, maximum_path
from tts_tpu_torch.ops.masking import sequence_mask


class GlowTTS(nn.Module):
    def __init__(self, num_chars: int = 200, num_speakers: int = 1,
                 out_channels: int = 80,
                 hidden_channels_enc: int = 192,
                 hidden_channels_dec: int = 192, filter_channels: int = 768,
                 filter_channels_dp: int = 256,
                 encoder_type: str = "transformer", num_heads: int = 2,
                 num_layers_enc: int = 6, kernel_size: int = 3,
                 rel_attn_window_size: Optional[int] = 4,
                 kernel_size_dec: int = 5, dilation_rate: int = 1,
                 num_flow_blocks_dec: int = 12, num_block_layers: int = 4,
                 num_splits: int = 4, num_sqz: int = 2,
                 dropout_rate: float = 0.1, dropout_rate_dec: float = 0.05):
        super().__init__()
        self.num_sqz = num_sqz
        self.num_speakers = num_speakers
        c_in_channels = 64 if num_speakers > 1 else 0
        self.encoder = GlowTTSEncoder(
            num_chars=num_chars, out_channels=out_channels,
            hidden_channels=hidden_channels_enc,
            filter_channels=filter_channels,
            filter_channels_dp=filter_channels_dp,
            encoder_type=encoder_type, num_heads=num_heads,
            num_layers=num_layers_enc, kernel_size=kernel_size,
            rel_attn_window_size=rel_attn_window_size,
            dropout_rate=dropout_rate, c_in_channels=c_in_channels)
        self.decoder = FlowDecoder(
            in_channels=out_channels, hidden_channels=hidden_channels_dec,
            kernel_size=kernel_size_dec, dilation_rate=dilation_rate,
            num_flow_blocks=num_flow_blocks_dec,
            num_coupling_layers=num_block_layers,
            dropout_rate=dropout_rate_dec, num_splits=num_splits,
            num_sqz=num_sqz, c_in_channels=c_in_channels)
        if num_speakers > 1:
            self.emb_g = nn.Embedding(num_speakers, c_in_channels)
            nn.init.uniform_(self.emb_g.weight, -0.1, 0.1)

    def set_generator(self, generator: Optional[torch.Generator]) -> None:
        """Draw every dropout mask from ``generator`` (on the model's
        device)."""
        set_generator(self, generator)

    def store_inverse(self) -> None:
        """Cache every flow's inverse 1x1 weight; call after loading
        weights and moving the model to its device."""
        for flow in self.decoder.flows:
            if hasattr(flow, "store_inverse"):
                flow.store_inverse()

    def speaker_vector(self, speaker_ids: Optional[torch.Tensor] = None,
                       speaker_embeddings: Optional[torch.Tensor] = None
                       ) -> Optional[torch.Tensor]:
        """g (B, c_in, 1): the external embeddings where given, else the
        ids' rows of ``emb_g`` on a multi-speaker model, else None."""
        if speaker_embeddings is not None:
            return speaker_embeddings[:, :, None]
        if self.num_speakers > 1 and speaker_ids is not None:
            return self.emb_g(speaker_ids.long())[:, :, None]
        return None

    def forward(self, text: torch.Tensor, text_lengths: torch.Tensor,
                mel: torch.Tensor, mel_lengths: torch.Tensor,
                speaker_ids: Optional[torch.Tensor] = None,
                speaker_embeddings: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        """Training forward (≙ ``GlowTTS.__call__``). text (B, T_x) ids;
        mel (B, C, T_y) in NCW. Returns tts_tpu's keys; ``alignments`` is
        (B, T_y, T_x) as there, every other tensor NCW: z, y_mean,
        y_log_scale (B, C, T_y'); o_dur_log, o_attn_dur, x_mask (B, 1, T_x);
        y_mask (B, 1, T_y'); logdet (B,); y_lengths (B,), where T_y' is T_y
        cut to a multiple of num_sqz."""
        g = self.speaker_vector(speaker_ids, speaker_embeddings)
        o_mean, o_log_scale, o_dur_log, x_mask = self.encoder(
            text, text_lengths, g)
        y_max = mel.shape[2] // self.num_sqz * self.num_sqz
        mel = mel[:, :, :y_max]
        mel_lengths_sqz = (mel_lengths // self.num_sqz) * self.num_sqz
        y_mask = sequence_mask(mel_lengths_sqz, y_max).to(mel.dtype)[:, None]
        z, logdet, y_mask = self.decoder(mel, y_mask, g)

        # the alignment, without gradient (≙ tts_tpu's stop_gradients)
        with torch.no_grad():
            o_scale = torch.exp(-2.0 * o_log_scale)               # (B, C, T_x)
            logp1 = torch.sum(-0.5 * math.log(2 * math.pi) - o_log_scale,
                              dim=1)                              # (B, T_x)
            logp2 = torch.einsum("bct,bcy->bty", o_scale, -0.5 * z ** 2)
            logp3 = torch.einsum("bct,bcy->bty", o_mean * o_scale, z)
            logp4 = torch.sum(-0.5 * o_mean ** 2 * o_scale, dim=1)
            logp = logp1[:, :, None] + logp2 + logp3 + logp4[:, :, None]
            attn_mask = x_mask[:, 0, :, None] * y_mask[:, 0, None, :]
            attn = maximum_path(logp, attn_mask)                 # (B, T_x, T_y)

        # encoder statistics at frame rate; their gradients flow
        y_mean = torch.matmul(o_mean, attn)                      # (B, C, T_y)
        y_log_scale = torch.matmul(o_log_scale, attn)
        o_attn_dur = torch.log1p(attn.sum(dim=2))[:, None] * x_mask
        return {
            "z": z,
            "logdet": logdet,
            "y_mean": y_mean,
            "y_log_scale": y_log_scale,
            "o_dur_log": o_dur_log,
            "o_attn_dur": o_attn_dur,
            "alignments": attn.transpose(1, 2),
            "x_mask": x_mask,
            "y_mask": y_mask,
            "y_lengths": mel_lengths_sqz,
        }

    def decode_mean(self, y_mean: torch.Tensor, y_mask: torch.Tensor,
                    speaker_ids: Optional[torch.Tensor] = None,
                    speaker_embeddings: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
        """The inverse flow from ``forward``'s MAS-aligned latent means
        (≙ ``GlowTTS.decode_mean``): y_mean (B, C, T_y), y_mask (B, 1, T_y)
        -> a noise-free mel (B, T_y, C), true to the alignment; what
        ``bin/eval_model`` scores a Glow checkpoint by."""
        g = self.speaker_vector(speaker_ids, speaker_embeddings)
        mel, _ = self.decoder.reverse(y_mean * y_mask, y_mask, g)
        return mel.transpose(1, 2)

    def encode(self, text: torch.Tensor, text_lengths: torch.Tensor,
               g: Optional[torch.Tensor] = None):
        """The encoder as inference runs it. In eval mode without autograd,
        on a configuration that ``supports_fused_encoder`` accepts (no
        speakers) and a text no longer than ``fused_encoder_max_length``
        (what B3's attention block holds on the card), it is one
        ``fused_glow_encoder`` call (the B3 kernels for CUDA tensors, their
        plain version for CPU tensors); otherwise (training mode, grad mode,
        a speaker vector, a longer text, or under ``torch.export``, which
        traces the plain modules) the module with its dropout."""
        enc = self.encoder
        if (not self.training and not torch.is_grad_enabled()
                and not torch.compiler.is_exporting()
                and g is None and supports_fused_encoder(enc)):
            limit = fused_encoder_max_length(enc, text.device)
            if limit is None or text.shape[1] <= limit:
                return fused_glow_encoder(enc, enc.packed_weights(), text,
                                          text_lengths)
        return enc(text, text_lengths, g)

    @torch.no_grad()
    def inference(self, text: torch.Tensor,
                  text_lengths: Optional[torch.Tensor] = None,
                  speaker_ids: Optional[torch.Tensor] = None,
                  speaker_embeddings: Optional[torch.Tensor] = None,
                  noise_scale: float = 0.33, length_scale: float = 1.0,
                  y_max_length: int = 1024,
                  generator: Optional[torch.Generator] = None
                  ) -> Dict[str, torch.Tensor]:
        """Duration-driven flow inversion. ``y_max_length`` is the frame
        budget (rounded down to num_sqz), as in tts_tpu. Outputs keep
        tts_tpu's layout: ``model_outputs`` (B, T_y, C), ``alignments``
        (B, T_y, T_x), ``durations_log`` (B, T_x, 1)."""
        if text_lengths is None:
            text_lengths = torch.full((text.shape[0],), text.shape[1],
                                      dtype=torch.int32, device=text.device)
        g = self.speaker_vector(speaker_ids, speaker_embeddings)
        o_mean, o_log_scale, o_dur_log, x_mask = self.encode(text,
                                                              text_lengths, g)

        # expm1, not exp: durations were regressed against log1p(sum attn)
        w = torch.expm1(o_dur_log[:, 0]) * x_mask[:, 0] * length_scale
        w_ceil = torch.ceil(w)
        y_lengths = torch.clamp(w_ceil.sum(dim=1), 1, y_max_length
                                ).to(torch.int32)
        y_lengths = (torch.ceil(y_lengths / self.num_sqz) * self.num_sqz
                     ).to(torch.int32)
        y_max = y_max_length // self.num_sqz * self.num_sqz

        y_mask = sequence_mask(y_lengths, y_max).to(o_mean.dtype)[:, None]
        attn_mask = x_mask[:, 0, :, None] * y_mask[:, 0, None, :]
        attn = generate_path(w_ceil.to(torch.int32), attn_mask)  # (B,Tx,Ty)

        y_mean = torch.matmul(o_mean, attn)                  # (B, C, T_y)
        y_log_scale = torch.matmul(o_log_scale, attn)
        if noise_scale:
            noise = torch.randn(y_mean.shape, generator=generator,
                                device=y_mean.device, dtype=y_mean.dtype)
            z = (y_mean + torch.exp(y_log_scale) * noise_scale * noise) * y_mask
        else:
            # noise_scale == 0: deterministic, no random numbers drawn
            z = y_mean * y_mask
        mel, _ = self.decoder.reverse(z, y_mask, g)
        return {
            "model_outputs": mel.transpose(1, 2),
            "mel_lengths": y_lengths,
            "alignments": attn.transpose(1, 2),
            "durations_log": o_dur_log.transpose(1, 2),
        }


def glow_tts_loss(outputs: Dict[str, torch.Tensor],
                  text_lengths: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Flow MLE + duration loss (≙ tts_tpu's ``glow_tts_loss``) on
    ``GlowTTS.forward``'s outputs."""
    z, y_mask = outputs["z"], outputs["y_mask"]
    y_mean, y_log_scale = outputs["y_mean"], outputs["y_log_scale"]
    n_elems = torch.clamp(y_mask.sum() * z.shape[1], min=1.0)
    sq = torch.exp(-2.0 * y_log_scale) * (z - y_mean) ** 2
    log_mle = (0.5 * math.log(2 * math.pi)
               + (torch.sum(y_log_scale * y_mask)
                  + 0.5 * torch.sum(sq * y_mask)
                  - torch.sum(outputs["logdet"])) / n_elems)

    # Huber loss on log-durations, normalized by token count
    diff = outputs["o_dur_log"] - outputs["o_attn_dur"]
    huber = torch.where(diff.abs() < 1.0, 0.5 * diff ** 2, diff.abs() - 0.5)
    n_tokens = torch.clamp(text_lengths.sum().float(), min=1.0)
    loss_dur = torch.sum(huber * outputs["x_mask"]) / n_tokens
    return {"log_mle": log_mle, "loss_dur": loss_dur,
            "loss": log_mle + loss_dur}


@torch.no_grad()
def apply_ddi(model: GlowTTS, batch: Dict[str, torch.Tensor]) -> None:
    """Data-dependent ActNorm init (≙ tts_tpu's ``apply_ddi``): one forward
    pass over ``batch`` in the model's current mode (the trainer's is
    ``train()``, dropout on, as tts_tpu's), in which every ActNorm sets its
    ``bias`` and ``logs`` from its masked input statistics in place."""
    for m in model.modules():
        if isinstance(m, ActNorm):
            m.initialized = False
    model(batch["text"], batch["text_lengths"], batch["mel"],
          batch["mel_lengths"], batch.get("speaker_ids"),
          batch.get("speaker_embeddings"))

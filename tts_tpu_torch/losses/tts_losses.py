"""Masked spectrogram-model losses (≙ tts_tpu/losses/tts_losses.py:
``masked_loss``, ``bce_stopnet_loss``, ``differential_spectral_loss``,
``guided_attention_loss``, ``attention_entropy_loss``, ``tacotron_loss``).

Tensors are time-major as in tts_tpu: spectrograms (B, T, D), stop logits
and targets (B, T_dec), alignments (B, T_dec, T_in).
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from tts_tpu_torch.ops.masking import sequence_mask

Tensor = torch.Tensor


def masked_loss(x: Tensor, target: Tensor, lengths: Tensor,
                kind: str = "l1", seq_len_norm: bool = False) -> Tensor:
    """Masked L1 or MSE over (B, T, D) with (B,) valid lengths;
    ``seq_len_norm`` weighs every sequence equally whatever its length."""
    mask = sequence_mask(lengths, x.shape[1])[..., None].to(x.dtype)
    err = (x - target).abs() if kind == "l1" else (x - target).square()
    err = err * mask
    if seq_len_norm:
        norm_w = mask / mask.sum(dim=(1, 2), keepdim=True).clamp(min=1.0)
        return (err * norm_w).sum() / x.shape[0]
    return err.sum() / (mask.sum() * x.shape[2]).clamp(min=1.0)


def step_lengths(lengths: Tensor, r: int) -> Tensor:
    """Decoder steps of each item: ceil(frames / r)."""
    return torch.div(lengths + (r - 1), r, rounding_mode="floor")


def bce_stopnet_loss(logits: Tensor, targets: Tensor, lengths: Tensor,
                     r: int, pos_weight: float = 10.0,
                     masking: bool = True) -> Tensor:
    """Stop-token BCE with the positive class weighted by ``pos_weight``,
    over the ceil(length / r) steps of each item when ``masking``."""
    loss = -(pos_weight * targets * F.logsigmoid(logits)
             + (1.0 - targets) * F.logsigmoid(-logits))
    if not masking:
        return loss.mean()
    mask = sequence_mask(step_lengths(lengths, r),
                         logits.shape[1]).to(logits.dtype)
    return (loss * mask).sum() / mask.sum().clamp(min=1.0)


def differential_spectral_loss(x: Tensor, target: Tensor, lengths: Tensor,
                               kind: str = "l1",
                               seq_len_norm: bool = False) -> Tensor:
    """``masked_loss`` on frame-to-frame differences."""
    return masked_loss(x[:, 1:] - x[:, :-1], target[:, 1:] - target[:, :-1],
                       lengths - 1, kind, seq_len_norm)


def guided_attention_loss(alignments: Tensor, text_lengths: Tensor,
                          mel_step_lengths: Tensor,
                          sigma: float = 0.4) -> Tensor:
    """Attention mass off a Gaussian band around the diagonal, over the
    valid (step, symbol) pairs."""
    B, T_dec, T_in = alignments.shape
    dev = alignments.device
    n = torch.arange(T_in, device=dev)[None, None, :]
    t = torch.arange(T_dec, device=dev)[None, :, None]
    in_len = text_lengths.clamp(min=1)[:, None, None].float()
    dec_len = mel_step_lengths.clamp(min=1)[:, None, None].float()
    w = 1.0 - torch.exp(-((n / in_len - t / dec_len) ** 2)
                        / (2 * sigma ** 2))
    mask = (sequence_mask(mel_step_lengths, T_dec)[:, :, None]
            & sequence_mask(text_lengths, T_in)[:, None, :])
    loss = alignments * w * mask
    return loss.sum() / mask.sum().clamp(min=1)


def attention_entropy_loss(alignments: Tensor) -> Tensor:
    """Mean entropy of the alignments over the last axis, divided by
    log(T_in)."""
    entropy = -(alignments * torch.log(alignments + 1e-8)).sum(-1)
    return entropy.mean() / math.log(alignments.shape[-1])


def tacotron_loss(outputs: Dict[str, Tensor], batch: Dict[str, Tensor], *,
                  r: int, loss_masking: bool = True,
                  seq_len_norm: bool = False, decoder_alpha: float = 0.25,
                  postnet_alpha: float = 0.25,
                  stopnet_pos_weight: float = 10.0, ga_alpha: float = 0.0,
                  decoder_diff_spec_alpha: float = 0.0,
                  postnet_diff_spec_alpha: float = 0.0,
                  use_linear: bool = False
                  ) -> Dict[str, Tensor]:
    """The Tacotron and Tacotron2 loss: its terms by name and their
    weighted sum under ``"loss"``. ``batch`` holds ``mel`` (B, T, n_mels),
    ``mel_lengths``, ``stop_targets`` (B, T / r) and ``text_lengths``; with
    ``use_linear`` (Tacotron v1) the post-net's target is ``batch["linear"]``
    (B, T, n_freq) where the batch has it, else the mel, as in tts_tpu. With double decoder
    consistency the coarse decoder's L1 and the distance of the alignments
    from the coarse ones (its steps stretched by integer index, no gradient)
    are added; with the backward decoder its L1 and its distance from the
    forward decoder's frames (no gradient)."""
    mel, lengths = batch["mel"], batch["mel_lengths"]
    post_target = batch.get("linear", mel) if use_linear else mel
    dec, post = outputs["decoder_outputs"], outputs["postnet_outputs"]
    losses: Dict[str, Tensor] = {}
    if loss_masking:
        losses["decoder_loss"] = masked_loss(dec, mel, lengths, "l1",
                                             seq_len_norm)
        losses["postnet_loss"] = masked_loss(post, post_target, lengths,
                                             "l1", seq_len_norm)
    else:
        losses["decoder_loss"] = (dec - mel).abs().mean()
        losses["postnet_loss"] = (post - post_target).abs().mean()
    total = (decoder_alpha * losses["decoder_loss"]
             + postnet_alpha * losses["postnet_loss"])

    losses["stopnet_loss"] = bce_stopnet_loss(
        outputs["stop_logits"], batch["stop_targets"], lengths, r,
        stopnet_pos_weight, loss_masking)
    total = total + losses["stopnet_loss"]

    if ga_alpha > 0:
        losses["ga_loss"] = guided_attention_loss(
            outputs["alignments"], batch["text_lengths"],
            step_lengths(lengths, r))
        total = total + ga_alpha * losses["ga_loss"]
    if decoder_diff_spec_alpha > 0:
        losses["decoder_diff_spec_loss"] = differential_spectral_loss(
            dec, mel, lengths, "l1", seq_len_norm)
        total = total + decoder_diff_spec_alpha * losses[
            "decoder_diff_spec_loss"]
    if postnet_diff_spec_alpha > 0:
        losses["postnet_diff_spec_loss"] = differential_spectral_loss(
            post, post_target, lengths, "l1", seq_len_norm)
        total = total + postnet_diff_spec_alpha * losses[
            "postnet_diff_spec_loss"]

    if "coarse_decoder_outputs" in outputs:
        losses["ddc_decoder_loss"] = masked_loss(
            outputs["coarse_decoder_outputs"], mel, lengths, "l1",
            seq_len_norm)
        total = total + decoder_alpha * losses["ddc_decoder_loss"]
        fine, coarse = outputs["alignments"], outputs["coarse_alignments"]
        T_fine, T_coarse = fine.shape[1], coarse.shape[1]
        idx = torch.clamp(torch.arange(T_fine, device=fine.device)
                          * T_coarse // T_fine, 0, T_coarse - 1)
        losses["ddc_attn_loss"] = (fine - coarse[:, idx].detach()
                                   ).abs().mean()
        total = total + losses["ddc_attn_loss"]

    if "backward_decoder_outputs" in outputs:
        back = outputs["backward_decoder_outputs"]
        losses["backward_decoder_loss"] = masked_loss(back, mel, lengths,
                                                      "l1", seq_len_norm)
        losses["decoder_consistency_loss"] = (back - dec.detach()
                                              ).abs().mean()
        total = total + decoder_alpha * (losses["backward_decoder_loss"]
                                         + losses["decoder_consistency_loss"])

    losses["loss"] = total
    return losses

"""GAN vocoder training step: generator update, then discriminator update
(≙ tts_tpu/train/gan.py: ``_gen_forward``, ``make_gan_train_step``, and
``_cast_floats`` of tts_tpu/train/state.py), on one device.

The order is tts_tpu's. The generator update takes the multi-scale STFT
losses (full band and, for a multiband generator, subbands) and, once the
discriminator runs (``train_disc``), the adversarial terms with the
discriminator's parameters frozen. The discriminator update then
regenerates ``y_hat`` for its own batch with the updated generator, without
gradients, and takes the discriminator loss on the fake and the real audio.
The warmup switch is a Python branch.

``mixed_precision`` is tts_tpu's: bfloat16 copies of the parameters run the
forwards (``torch.func.functional_call``), so gradients reach the float32
masters through the cast; the mel input is bfloat16; scores, features and
``y_hat`` return to float32 before the losses. It is not ``torch.autocast``,
which would cast per operation.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.func import functional_call

from tts_tpu_torch.losses.vocoder_losses import (discriminator_loss,
                                                 generator_loss)
from tts_tpu_torch.train.optim import RAdamW

Tensor = torch.Tensor


def cast_params(module: nn.Module, dtype: torch.dtype, frozen: bool
                ) -> Dict[str, Tensor]:
    """``module``'s parameters by name in ``dtype`` (≙ ``_cast_floats``);
    ``frozen`` detaches them, so no gradient reaches the module."""
    return {name: (p.detach() if frozen else p).to(dtype)
            for name, p in module.named_parameters()}


class GANTrainStep:
    """One alternating step on batches {"mel": (B, n_mels, frames),
    "audio": (B, 1, T)} already on the device. ``gen`` and ``disc`` are
    updated in place by ``opt_G`` and ``opt_D``."""

    def __init__(self, gen: nn.Module, disc: nn.Module, opt_G: RAdamW,
                 opt_D: RAdamW, *, hop_len: int = 256, conv_pad: int = 2,
                 use_pqmf: bool = False,
                 gen_loss_kwargs: Optional[Dict] = None,
                 disc_loss_kwargs: Optional[Dict] = None,
                 mixed_precision: bool = False):
        self.gen, self.disc = gen, disc
        self.opt_G, self.opt_D = opt_G, opt_D
        self.hop_len, self.conv_pad = hop_len, conv_pad
        self.use_pqmf = use_pqmf
        self.gkw = dict(gen_loss_kwargs or {})
        if use_pqmf:
            self.gkw.setdefault("use_subband_stft_loss", True)
        self.dkw = dict(disc_loss_kwargs or {})
        self.dtype = torch.bfloat16 if mixed_precision else torch.float32

    def gen_forward(self, params: Dict[str, Tensor], mel: Tensor,
                    t_audio: int) -> Tuple[Tensor, Optional[Tensor]]:
        """(full-band y_hat (B, 1, t_audio), subbands or None); conv_pad
        context frames are cut off the output's ends."""
        y_hat = functional_call(self.gen, params, (mel.to(self.dtype),))
        y_sub = None
        if self.use_pqmf:
            y_sub = y_hat
            y_hat = self.gen.pqmf.synthesis(y_hat)
        offset = self.conv_pad * self.hop_len
        if y_hat.shape[-1] > t_audio:
            y_hat = y_hat[..., offset:offset + t_audio]
        return y_hat, y_sub

    def disc_apply(self, params: Dict[str, Tensor], y: Tensor
                   ) -> Tuple[List[Tensor], List[List[Tensor]]]:
        """Scores and features in float32, as lists over scales."""
        scores, feats = functional_call(self.disc, params,
                                        (y.to(self.dtype),))
        if isinstance(scores, Tensor):           # one MelganDiscriminator
            scores, feats = [scores], [feats]
        return ([s.float() for s in scores],
                [[f.float() for f in ff] for ff in feats])

    def generator_losses(self, batch: Dict[str, Tensor], train_disc: bool
                         ) -> Dict[str, Tensor]:
        y = batch["audio"]
        y_hat, y_hat_sub = self.gen_forward(
            cast_params(self.gen, self.dtype, frozen=False), batch["mel"],
            y.shape[-1])
        y_hat = y_hat.float()
        kwargs = dict(self.gkw)
        if y_hat_sub is not None:
            kwargs["y_hat_sub"] = y_hat_sub.float()
            kwargs["y_sub"] = self.gen.pqmf.analysis(y)
        if train_disc:
            d_params = cast_params(self.disc, self.dtype, frozen=True)
            kwargs["scores_fake"], kwargs["feats_fake"] = self.disc_apply(
                d_params, y_hat)
            if kwargs.get("use_feat_match_loss"):
                kwargs["feats_real"] = self.disc_apply(d_params, y)[1]
        return generator_loss(y_hat, y, **kwargs)

    def discriminator_losses(self, batch: Dict[str, Tensor]
                             ) -> Dict[str, Tensor]:
        with torch.no_grad():
            y_hat, _ = self.gen_forward(
                cast_params(self.gen, self.dtype, frozen=True), batch["mel"],
                batch["audio"].shape[-1])
        d_params = cast_params(self.disc, self.dtype, frozen=False)
        scores_fake, _ = self.disc_apply(d_params, y_hat)
        scores_real, _ = self.disc_apply(d_params, batch["audio"])
        return discriminator_loss(scores_fake, scores_real, **self.dkw)

    def __call__(self, batch_G: Dict[str, Tensor], batch_D: Dict[str, Tensor],
                 train_disc: bool) -> Dict[str, float]:
        """Both updates; returns the losses (before the updates) as
        floats."""
        self.opt_G.zero_grad()
        losses = self.generator_losses(batch_G, train_disc)
        losses["G_loss"].backward()
        self.opt_G.step()
        if train_disc:
            self.opt_D.zero_grad()
            d_losses = self.discriminator_losses(batch_D)
            d_losses["D_loss"].backward()
            self.opt_D.step()
            losses.update(d_losses)
        return {k: v.item() for k, v in losses.items()}

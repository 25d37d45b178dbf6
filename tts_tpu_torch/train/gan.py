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

Two more inputs come from random draws, as in tts_tpu: a noise-driven
generator (ParallelWaveGAN, ``needs_noise``) takes white noise at the audio
rate beside the mel, and a discriminator that takes the mel
(``disc_takes_cond``: the random window discriminators) takes crop offsets.
Both flags are read off the modules. tts_tpu splits three keys a step: the
generator update's noise, the generator update's discriminator offsets
(fake and real alike), and one for the discriminator update, whose
regenerated ``y_hat`` draws new noise and whose fake and real scores share
offsets. Here the noise is one draw from ``generator`` (on the device) and
the offsets one from ``crop_generator`` (on the host, since slicing needs
them as host integers: a draw on the device would stall the queue), or
either is handed in through ``draws``.

With ``mesh`` the step is data-parallel over the mesh's data dim (≙
``make_gan_train_step(mesh=...)``): each rank runs both updates on its part
of the batches; the generator's gradients and losses are averaged over the
ranks before ``opt_G``, the discriminator's before ``opt_D``
(``parallel/data_parallel.py``), and the noise and crop generators are
reseeded per rank (``rank_seed``), as tts_tpu folds the axis index into
its key. B5 and B6 run per rank. The vocoder trainer does not use this
mode, as tts_tpu's does not.

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
from tts_tpu_torch.models.vocoder.pwgan import ParallelWaveganGenerator
from tts_tpu_torch.parallel import data_parallel as DP
from tts_tpu_torch.train.optim import RAdamW

Tensor = torch.Tensor


def as_lists(out) -> Tuple[List[Tensor], Optional[List[List[Tensor]]]]:
    """A discriminator's output -> (scores, features per scale or None)
    (≙ tts_tpu's ``_as_lists``): a bare score tensor (the ParallelWaveGAN
    discriminators), ``(score, features)`` of one MelGAN discriminator, or
    lists over scales; no features (the random window discriminators'
    ``[]``) is None, so no feature-matching term is taken."""
    scores, feats = out if isinstance(out, tuple) else (out, None)
    if isinstance(scores, Tensor):
        scores, feats = [scores], ([feats] if feats else None)
    return list(scores), (list(feats) if feats else None)


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
                 generator: Optional[torch.Generator] = None,
                 crop_generator: Optional[torch.Generator] = None,
                 gen_loss_kwargs: Optional[Dict] = None,
                 disc_loss_kwargs: Optional[Dict] = None,
                 mixed_precision: bool = False, mesh=None,
                 axis: str = "data"):
        self.gen, self.disc = gen, disc
        self.opt_G, self.opt_D = opt_G, opt_D
        self.hop_len, self.conv_pad = hop_len, conv_pad
        self.use_pqmf = use_pqmf
        self.needs_noise = isinstance(gen, ParallelWaveganGenerator)
        self.disc_takes_cond = hasattr(disc, "draw_offsets")
        self.generator, self.crop_generator = generator, crop_generator
        self.gkw = dict(gen_loss_kwargs or {})
        if use_pqmf:
            self.gkw.setdefault("use_subband_stft_loss", True)
        self.dkw = dict(disc_loss_kwargs or {})
        self.dtype = torch.bfloat16 if mixed_precision else torch.float32
        self.group = None
        if mesh is not None:
            self.group, self.n, rank = DP.require_group(mesh, axis)
            self.generator, self.crop_generator = (
                g if g is None else torch.Generator(g.device).manual_seed(
                    DP.rank_seed(g.initial_seed(), rank))
                for g in (generator, crop_generator))

    def _reduce(self, module: nn.Module, losses: Dict[str, Tensor]
                ) -> Dict:
        """With a mesh, ``module``'s gradients averaged over the data dim
        and ``losses`` too (as floats)."""
        if self.group is None:
            return losses
        DP.average_gradients(module.parameters(), self.group, self.n)
        return DP.average_losses(losses, self.group, self.n)

    def draw(self, batch: Dict[str, Tensor]) -> Dict:
        """One side's random inputs: white noise (B, 1, T) for a
        noise-driven generator, crop offsets for a discriminator that takes
        the mel."""
        out = {}
        audio = batch["audio"]
        if self.needs_noise:
            out["noise"] = torch.randn(audio.shape, generator=self.generator,
                                       device=audio.device)
        if self.disc_takes_cond:
            out["offsets"] = self.disc.draw_offsets(
                audio.shape[-1], batch["mel"].shape[-1], self.crop_generator)
        return out

    def gen_forward(self, params: Dict[str, Tensor], mel: Tensor,
                    t_audio: int, noise: Optional[Tensor] = None
                    ) -> Tuple[Tensor, Optional[Tensor]]:
        """(full-band y_hat (B, 1, t_audio), subbands or None); conv_pad
        context frames are cut off the output's ends."""
        args = (mel.to(self.dtype),)
        if self.needs_noise:
            args = (noise.to(self.dtype),) + args
        y_hat = functional_call(self.gen, params, args)
        y_sub = None
        if self.use_pqmf:
            y_sub = y_hat
            y_hat = self.gen.pqmf.synthesis(y_hat)
        offset = self.conv_pad * self.hop_len
        if y_hat.shape[-1] > t_audio:
            y_hat = y_hat[..., offset:offset + t_audio]
        return y_hat, y_sub

    def disc_apply(self, params: Dict[str, Tensor], y: Tensor, mel: Tensor,
                   offsets=None
                   ) -> Tuple[List[Tensor], Optional[List[List[Tensor]]]]:
        """Scores and features (None when the discriminator has none) in
        float32, as lists over scales or windows."""
        if self.disc_takes_cond:
            out = functional_call(self.disc, params,
                                  (y.to(self.dtype), mel.to(self.dtype)),
                                  {"offsets": offsets})
        else:
            out = functional_call(self.disc, params, (y.to(self.dtype),))
        scores, feats = as_lists(out)
        return ([s.float() for s in scores],
                feats and [[f.float() for f in ff] for ff in feats])

    def generator_losses(self, batch: Dict[str, Tensor], train_disc: bool,
                         draws: Optional[Dict] = None) -> Dict[str, Tensor]:
        draws = self.draw(batch) if draws is None else draws
        y = batch["audio"]
        y_hat, y_hat_sub = self.gen_forward(
            cast_params(self.gen, self.dtype, frozen=False), batch["mel"],
            y.shape[-1], draws.get("noise"))
        y_hat = y_hat.float()
        kwargs = dict(self.gkw)
        if y_hat_sub is not None:
            kwargs["y_hat_sub"] = y_hat_sub.float()
            kwargs["y_sub"] = self.gen.pqmf.analysis(y)
        if train_disc:
            d_params = cast_params(self.disc, self.dtype, frozen=True)
            offsets = draws.get("offsets")
            kwargs["scores_fake"], kwargs["feats_fake"] = self.disc_apply(
                d_params, y_hat, batch["mel"], offsets)
            if kwargs.get("use_feat_match_loss"):
                kwargs["feats_real"] = self.disc_apply(
                    d_params, y, batch["mel"], offsets)[1]
        return generator_loss(y_hat, y, **kwargs)

    def discriminator_losses(self, batch: Dict[str, Tensor],
                             draws: Optional[Dict] = None
                             ) -> Dict[str, Tensor]:
        draws = self.draw(batch) if draws is None else draws
        with torch.no_grad():
            y_hat, _ = self.gen_forward(
                cast_params(self.gen, self.dtype, frozen=True), batch["mel"],
                batch["audio"].shape[-1], draws.get("noise"))
        d_params = cast_params(self.disc, self.dtype, frozen=False)
        offsets = draws.get("offsets")
        scores_fake, _ = self.disc_apply(d_params, y_hat, batch["mel"],
                                         offsets)
        scores_real, _ = self.disc_apply(d_params, batch["audio"],
                                         batch["mel"], offsets)
        return discriminator_loss(scores_fake, scores_real, **self.dkw)

    def __call__(self, batch_G: Dict[str, Tensor], batch_D: Dict[str, Tensor],
                 train_disc: bool, draws: Optional[Dict[str, Dict]] = None
                 ) -> Dict[str, float]:
        """Both updates; returns the losses (before the updates) as
        floats. ``draws`` ({"G": ..., "D": ...}, each as ``draw`` gives)
        replaces the step's random draws."""
        draws = draws or {}
        self.opt_G.zero_grad()
        losses = self.generator_losses(batch_G, train_disc, draws.get("G"))
        losses["G_loss"].backward()
        losses = self._reduce(self.gen, losses)
        self.opt_G.step()
        if train_disc:
            self.opt_D.zero_grad()
            d_losses = self.discriminator_losses(batch_D, draws.get("D"))
            d_losses["D_loss"].backward()
            d_losses = self._reduce(self.disc, d_losses)
            self.opt_D.step()
            losses.update(d_losses)
        return {k: v.item() if isinstance(v, Tensor) else v
                for k, v in losses.items()}

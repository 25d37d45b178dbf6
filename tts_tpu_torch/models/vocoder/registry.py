"""Vocoder model factories by config name
(≙ tts_tpu/models/vocoder/registry.py: ``setup_generator`` and
``setup_discriminator``, MelGAN family)."""

from __future__ import annotations

from typing import Any, Dict


def setup_generator(c: Dict[str, Any], use_weight_norm: bool = True):
    name = c["generator_model"].lower()
    params = dict(c.get("generator_model_params", {}))
    in_channels = c.get("audio", {}).get("num_mels", 80)
    if name == "melgan_generator":
        from tts_tpu_torch.models.vocoder.melgan import MelganGenerator
        return MelganGenerator(
            in_channels=in_channels, out_channels=1,
            base_channels=params.get("base_channels", 512),
            upsample_factors=tuple(params.get("upsample_factors",
                                              (8, 8, 2, 2))),
            num_res_blocks=params.get("num_res_blocks", 3),
            use_weight_norm=use_weight_norm)
    if name == "multiband_melgan_generator":
        from tts_tpu_torch.models.vocoder.multiband_melgan import \
            MultibandMelganGenerator
        return MultibandMelganGenerator(
            in_channels=in_channels,
            base_channels=params.get("base_channels", 384),
            upsample_factors=tuple(params.get("upsample_factors",
                                              (2, 8, 2, 2))),
            num_res_blocks=params.get("num_res_blocks", 3),
            use_weight_norm=use_weight_norm)
    if name == "fullband_melgan_generator":
        from tts_tpu_torch.models.vocoder.multiband_melgan import \
            FullbandMelganGenerator
        return FullbandMelganGenerator(
            in_channels=in_channels,
            base_channels=params.get("base_channels", 512),
            upsample_factors=tuple(params.get("upsample_factors",
                                              (2, 8, 2, 2))),
            num_res_blocks=params.get("num_res_blocks", 4),
            use_weight_norm=use_weight_norm)
    raise KeyError(f"unknown or not yet ported generator model: {name}")


def setup_discriminator(c: Dict[str, Any]):
    name = c["discriminator_model"].lower()
    params = dict(c.get("discriminator_model_params", {}))
    if name == "melgan_multiscale_discriminator":
        from tts_tpu_torch.models.vocoder.melgan import \
            MelganMultiscaleDiscriminator
        return MelganMultiscaleDiscriminator(
            num_scales=params.get("num_scales", 3))
    if name == "melgan_discriminator":
        from tts_tpu_torch.models.vocoder.melgan import MelganDiscriminator
        return MelganDiscriminator()
    raise KeyError(f"unknown or not yet ported discriminator model: {name}")

"""Vocoder model factories by config name
(≙ tts_tpu/models/vocoder/registry.py: ``setup_generator`` and
``setup_discriminator`` with tts_tpu's defaults)."""

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
    if name == "istft_melgan_generator":
        from tts_tpu_torch.models.vocoder.istft_melgan import \
            ISTFTMelganGenerator
        return ISTFTMelganGenerator(
            in_channels=in_channels,
            base_channels=params.get("base_channels", 512),
            upsample_factors=tuple(params.get("upsample_factors", (8, 8))),
            num_res_blocks=params.get("num_res_blocks", 3),
            n_fft_head=params.get("n_fft_head", 16),
            hop_head=params.get("hop_head", 4),
            use_weight_norm=use_weight_norm)
    if name == "parallel_wavegan_generator":
        from tts_tpu_torch.models.vocoder.pwgan import \
            ParallelWaveganGenerator
        return ParallelWaveganGenerator(
            aux_channels=in_channels,
            num_res_blocks=params.get("num_res_blocks", 30),
            stacks=params.get("stacks", 3),
            upsample_factors=tuple(params.get("upsample_factors",
                                              (4, 4, 4, 4))),
            use_weight_norm=use_weight_norm)
    if name == "wavernn":
        # tts_tpu's overloaded ``mode``: an int is bits mode with that many
        # bits, "mold" the mixture-of-logistics head
        from tts_tpu_torch.models.vocoder.wavernn import WaveRNN
        mode = c.get("mode", params.get("mode", "bits"))
        bits = params.get("bits", 10)
        if isinstance(mode, int):
            bits, mode = mode, "bits"
        return WaveRNN(
            bits=bits,
            rnn_dims=params.get("rnn_dims", 512),
            fc_dims=params.get("fc_dims", 512),
            feat_dims=in_channels,
            compute_dims=params.get("compute_dims", 128),
            res_out_dims=params.get("res_out_dims", 128),
            res_blocks=params.get("res_blocks", 10),
            pad=params.get("pad", 2),
            upsample_factors=tuple(params.get("upsample_factors", (4, 8, 8))),
            mulaw=params.get("mulaw", True),
            mode=mode,
            nr_mix=params.get("nr_mix", 10))
    raise KeyError(f"unknown generator model: {name}")


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
    if name == "parallel_wavegan_discriminator":
        from tts_tpu_torch.models.vocoder.pwgan import \
            ParallelWaveganDiscriminator
        return ParallelWaveganDiscriminator(
            num_layers=params.get("num_layers", 10))
    if name == "residual_parallel_wavegan_discriminator":
        from tts_tpu_torch.models.vocoder.pwgan import \
            ResidualParallelWaveganDiscriminator
        return ResidualParallelWaveganDiscriminator(
            num_layers=params.get("num_layers", 30),
            stacks=params.get("stacks", 3))
    if name == "random_window_discriminator":
        from tts_tpu_torch.models.vocoder.rwd import RandomWindowDiscriminator
        audio = c.get("audio", {})
        return RandomWindowDiscriminator(
            cond_channels=audio.get("num_mels", 80),
            hop_length=audio.get("hop_length", 256),
            window_sizes=tuple(params.get("window_sizes",
                                          (512, 1024, 2048, 4096, 8192))))
    raise KeyError(f"unknown or not yet ported discriminator model: {name}")

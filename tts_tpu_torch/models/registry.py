"""TTS model factory from config (≙ tts_tpu/models/registry.py: Glow-TTS
with any of its three encoders, Tacotron2 and Tacotron v1)."""

from __future__ import annotations

from typing import Any, Dict


def setup_model(num_chars: int, num_speakers: int, c: Dict[str, Any],
                speaker_embedding_dim: int = 0):
    """``speaker_embedding_dim`` > 0: a multi-speaker Tacotron2 reads
    external d-vectors of that width instead of learning an embedding per
    speaker id (tts_tpu's trainer passes the width of its speakers.json)."""
    name = c["model"].lower()
    audio = c.get("audio", {})
    # r_init covers the largest r of the gradual-training schedule: the
    # decoder's projection and stopnet are sized by it, so a checkpoint
    # trained with gradual r loads into a model built from the config
    gradual = c.get("gradual_training") or []
    r = c.get("r", 7)
    r_init = max([r] + [e[1] for e in gradual])
    if name == "glow_tts":
        from tts_tpu_torch.models.glow_tts import GlowTTS
        # hard-coded hyperparameters as in tts_tpu (and the reference's
        # setup_model); the dropout rates are tts_tpu's GlowTTS defaults,
        # which its trainer trains with (active only in train() mode)
        return GlowTTS(
            num_chars=num_chars,
            num_speakers=num_speakers,
            out_channels=audio.get("num_mels", 80),
            hidden_channels_enc=c.get("hidden_channels_encoder", 192),
            hidden_channels_dec=c.get("hidden_channels_decoder", 192),
            encoder_type=c.get("encoder_type", "transformer"),
            rel_attn_window_size=4,
            dropout_rate=0.1,
            dropout_rate_dec=0.05,
        )
    if name == "tacotron2":
        from tts_tpu_torch.models.tacotron2 import Tacotron2
        gst = c.get("gst", {}) or {}
        return Tacotron2(
            num_chars=num_chars,
            num_speakers=num_speakers,
            external_speaker_dim=speaker_embedding_dim,
            use_gst=c.get("use_gst", False),
            gst_num_style_tokens=gst.get("gst_style_tokens", 10),
            gst_embedding_dim=gst.get("gst_embedding_dim", 512),
            gst_num_heads=gst.get("gst_num_heads", 4),
            n_mels=audio.get("num_mels", 80),
            r=r,
            r_init=r_init,
            encoder_dim=c.get("encoder_dim", 512),
            embedding_dim=c.get("embedding_dim", 512),
            prenet_type=c.get("prenet_type", "original"),
            prenet_dropout=c.get("prenet_dropout", True),
            attn_type=c.get("attention_type", "original"),
            attn_dim=c.get("attn_dim", 128),
            attn_K=c.get("attention_heads", 5),
            location_attn=c.get("location_attn", True),
            use_forward_attn=c.get("use_forward_attn", False),
            use_transition_agent=c.get("transition_agent", False),
            forward_attn_mask=c.get("forward_attn_mask", False),
            attn_norm=c.get("attention_norm", "softmax"),
            windowing=c.get("windowing", False),
            separate_stopnet=c.get("separate_stopnet", True),
            bidirectional_decoder=c.get("bidirectional_decoder", False),
            double_decoder_consistency=c.get("double_decoder_consistency",
                                             False),
            ddc_r=c.get("ddc_r", 6),
            max_decoder_steps=c.get("max_decoder_steps", 1000),
        )
    if name == "tacotron":
        from tts_tpu_torch.models.tacotron import Tacotron
        return Tacotron(
            num_chars=num_chars,
            num_speakers=num_speakers,
            use_gst=c.get("use_gst", False),
            n_mels=audio.get("num_mels", 80),
            linear_dim=audio.get("fft_size", 1024) // 2 + 1,
            r=r,
            r_init=r_init,
            memory_size=c.get("memory_size", -1),
            prenet_type=c.get("prenet_type", "original"),
            prenet_dropout=c.get("prenet_dropout", True),
            attn_type=c.get("attention_type", "original"),
            attn_K=c.get("attention_heads", 5),
            location_attn=c.get("location_attn", True),
            use_forward_attn=c.get("use_forward_attn", False),
            use_transition_agent=c.get("transition_agent", False),
            forward_attn_mask=c.get("forward_attn_mask", False),
            attn_norm=c.get("attention_norm", "sigmoid"),
            windowing=c.get("windowing", False),
            separate_stopnet=c.get("separate_stopnet", True),
            max_decoder_steps=c.get("max_decoder_steps", 500),
        )
    raise KeyError(f"unknown model: {name}")

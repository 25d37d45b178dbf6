"""TTS model factory from config (≙ tts_tpu/models/registry.py; the
Glow-TTS branch only — the Tacotron family comes in a later slice)."""

from __future__ import annotations

from typing import Any, Dict


def setup_model(num_chars: int, num_speakers: int, c: Dict[str, Any]):
    name = c["model"].lower()
    if name == "glow_tts":
        if num_speakers > 1:
            raise NotImplementedError(
                "multi-speaker Glow-TTS is not ported yet")
        if c.get("encoder_type", "transformer") != "transformer":
            raise NotImplementedError(
                "only the transformer Glow-TTS encoder is ported")
        from tts_tpu_torch.models.glow_tts import GlowTTS
        audio = c.get("audio", {})
        # hard-coded hyperparameters as in tts_tpu (and the reference's
        # setup_model); the dropout rates are tts_tpu's GlowTTS defaults,
        # which its trainer trains with (active only in train() mode)
        return GlowTTS(
            num_chars=num_chars,
            out_channels=audio.get("num_mels", 80),
            hidden_channels_enc=c.get("hidden_channels_encoder", 192),
            hidden_channels_dec=c.get("hidden_channels_decoder", 192),
            rel_attn_window_size=4,
            dropout_rate=0.1,
            dropout_rate_dec=0.05,
        )
    raise KeyError(f"unknown or not yet ported model: {name}")

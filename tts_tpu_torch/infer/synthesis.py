"""End-to-end synthesis helper: text -> id sequence -> model -> mel, and
the waveform by Griffin-Lim when no vocoder is served (≙ tts_tpu/infer/
synthesis.py: ``text_to_seqvec``, ``compute_style_mel``,
``bucket_text_length``, the Glow-TTS, Tacotron2 and Tacotron branches of
``run_model``, ``inv_spectrogram``, ``trim_silence`` and ``synthesis``).
A speaker id, an external speaker embedding (d-vector) and a GST style
wav reach the model as in tts_tpu. PyTorch runs eagerly, so there is no
compiled-function cache. Griffin-Lim runs on the host in numpy
(``AudioProcessor``), as in tts_tpu."""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from tts_tpu_torch.text import phoneme_to_sequence, text_to_sequence


def text_to_seqvec(text: str, c: Dict, tp=None) -> np.ndarray:
    if c.get("use_phonemes", False):
        seq = phoneme_to_sequence(
            text, c.get("text_cleaner", "phoneme_cleaners"),
            language=c.get("phoneme_language", "en-us"),
            enable_eos_bos=c.get("enable_eos_bos_chars", False), tp=tp)
    else:
        seq = text_to_sequence(text, c.get("text_cleaner", "english_cleaners"),
                               tp=tp)
    return np.asarray(seq, dtype=np.int32)


def compute_style_mel(style_wav: str, ap) -> np.ndarray:
    """The normalized mel (1, T, n_mels) of a style wav."""
    return ap.melspectrogram(ap.load_wav(style_wav))[None]


TEXT_BUCKETS = (32, 64, 96, 128, 192, 256, 384, 512)


def bucket_text_length(n: int, buckets=TEXT_BUCKETS) -> int:
    """Smallest bucket >= n. Kept from tts_tpu so that served audio matches
    it; masked attention makes the padding inert."""
    for b in buckets:
        if n <= b:
            return b
    return n


def check_speaker_id(model, speaker_id: Optional[int]) -> None:
    """Raise ValueError, on the host, for a speaker id outside a
    multi-speaker model's ``num_speakers``: on the card an embedding
    lookup out of range is a device-side assert, after which every CUDA
    call of the process fails. A single-speaker model ignores the id."""
    n = getattr(model, "num_speakers", 1)
    if speaker_id is not None and n > 1 and not 0 <= speaker_id < n:
        raise ValueError(f"speaker_id {speaker_id} is not in 0..{n - 1}")


def run_model(model, inputs: torch.Tensor, c: Dict,
              max_decoder_steps: Optional[int] = None,
              generator: Optional[torch.Generator] = None,
              text_lengths: Optional[torch.Tensor] = None,
              speaker_id: Optional[int] = None,
              speaker_embedding: Optional[np.ndarray] = None,
              style_mel: Optional[np.ndarray] = None
              ) -> Dict[str, torch.Tensor]:
    """Model-family dispatch (Glow-TTS, Tacotron2, Tacotron). A Tacotron2
    whose configuration ``supports_fused_decode`` runs
    ``taco2_fused_inference`` (the B7 and B8 kernels on the card), any
    other ``model.inference``; the choice depends on the configuration
    only. Both compute tts_tpu's ``Tacotron2.inference``
    (``max_decoder_steps`` defaults to the model's budget, with windowing
    where the configuration sets it). Tacotron v1 runs ``model.inference``
    (windowing where set; no kernel), its ``postnet_outputs`` the linear
    spectrogram. Glow-TTS in eval mode runs its encoder as the fused B3
    call (``GlowTTS.encode``) where ``supports_fused_encoder`` takes it.
    ``speaker_id`` and ``speaker_embedding`` (D,) become a batch of one;
    ``style_mel`` (1, T, n_mels) goes to the Tacotrons only; a speaker id
    out of range raises ValueError (``check_speaker_id``)."""
    dev = inputs.device
    kwargs: Dict[str, Any] = {}
    check_speaker_id(model, speaker_id)
    if speaker_id is not None:
        kwargs["speaker_ids"] = torch.tensor([speaker_id], device=dev)
    if speaker_embedding is not None:
        kwargs["speaker_embeddings"] = torch.as_tensor(
            speaker_embedding, dtype=torch.float32, device=dev)[None]
    model_name = c.get("model", "tacotron2").lower()
    if model_name in ("tacotron", "tacotron2"):
        from tts_tpu_torch.infer.fast_decode import (supports_fused_decode,
                                                     taco2_fused_inference)
        if model_name == "tacotron2" and supports_fused_decode(model):
            return taco2_fused_inference(model, inputs, text_lengths,
                                         max_decoder_steps)
        if style_mel is not None:
            kwargs["style_mel"] = torch.as_tensor(
                style_mel, dtype=torch.float32, device=dev)
        return model.inference(inputs, text_lengths,
                               max_decoder_steps=max_decoder_steps, **kwargs)
    if model_name != "glow_tts":
        raise KeyError(f"unknown model: {model_name}")
    out = model.inference(
        inputs, text_lengths, **kwargs,
        noise_scale=c.get("inference_noise_scale", 0.33),
        length_scale=c.get("length_scale", 1.0),
        y_max_length=max_decoder_steps or 1024, generator=generator)
    out["postnet_outputs"] = out["model_outputs"]
    return out


def inv_spectrogram(postnet_output: np.ndarray, ap, c: Dict) -> np.ndarray:
    """Griffin-Lim of a normalized mel (Tacotron2, Glow-TTS), or of a linear
    spectrogram for Tacotron v1."""
    if c.get("model", "tacotron2").lower() == "tacotron":
        return ap.inv_spectrogram(postnet_output)
    return ap.inv_melspectrogram(postnet_output)


def trim_silence(wav: np.ndarray, ap) -> np.ndarray:
    """Cut 10 ms from each end (tts_tpu's rule)."""
    margin = int(ap.sample_rate * 0.01)
    return wav[margin:-margin] if len(wav) > 2 * margin else wav


def synthesis(model, text: str, c: Dict, device: torch.device, *,
              max_decoder_steps: Optional[int] = None, tp=None,
              generator: Optional[torch.Generator] = None, ap=None,
              use_griffin_lim: bool = False,
              do_trim_silence: bool = False,
              speaker_id: Optional[int] = None,
              speaker_embedding: Optional[np.ndarray] = None,
              style_wav: Optional[str] = None) -> Dict[str, Any]:
    """Text -> normalized mel of the valid frames: 'postnet_outputs'
    (T, n_mels) numpy, and 'alignments' (T_y, T_x); with
    ``use_griffin_lim`` also 'wav', Griffin-Lim through ``ap`` (trimmed by
    10 ms at each end with ``do_trim_silence``). ``style_wav`` is read
    (through ``ap``) only for a configuration with ``use_gst``."""
    seq = text_to_seqvec(text, c, tp=tp)
    n = len(seq)
    text_lengths = None
    if c.get("bucket_text", True):
        b = bucket_text_length(n)
        if b > n:
            seq = np.pad(seq, (0, b - n))
        text_lengths = torch.tensor([n], dtype=torch.int32, device=device)
    inputs = torch.from_numpy(seq.astype(np.int64))[None].to(device)
    style_mel = None
    if style_wav is not None and c.get("use_gst", False):
        style_mel = compute_style_mel(style_wav, ap)
    out = run_model(model, inputs, c, max_decoder_steps, generator,
                    text_lengths=text_lengths, speaker_id=speaker_id,
                    speaker_embedding=speaker_embedding, style_mel=style_mel)
    postnet = out["postnet_outputs"][0].float().cpu().numpy()
    n_valid = int(out["mel_lengths"][0])
    if n_valid > 0:
        postnet = postnet[:n_valid]
    result = {"postnet_outputs": postnet,
              "alignments": out["alignments"][0].cpu().numpy()}
    if use_griffin_lim:
        wav = inv_spectrogram(postnet, ap, c)
        result["wav"] = trim_silence(wav, ap) if do_trim_silence else wav
    return result

"""Synthesizer: checkpointed Glow-TTS or Tacotron2 + MelGAN-family vocoder,
sentence-wise (≙ tts_tpu/infer/synthesizer.py for these models).

Checkpoints are ``torch.save({"model": state_dict, ...})`` files; a Mozilla
TTS state dict loads as it is, since the port keeps its key names, and a
Tacotron2 checkpoint's ``"r"`` (a gradual-training run's r) is served. A
Tacotron2 whose configuration the fused decode supports runs the B7 and B8
kernels on the card (``infer/synthesis.py::run_model``). On
``cuda`` (the default) the vocoder always runs through the hand-written
kernels: ``megakernel_inference`` when the upsample factors are even, else
the per-stack path ``fused_inference``. On ``device="cpu"`` the same calls
take their plain PyTorch versions.
"""

from __future__ import annotations

import re
import time
from typing import Dict, List

import numpy as np
import torch

from tts_tpu_torch import DeviceLike, resolve_device
from tts_tpu_torch.audio import AudioProcessor
from tts_tpu_torch.config import load_config
from tts_tpu_torch.infer.synthesis import synthesis
from tts_tpu_torch.models.glow_tts import GlowTTS
from tts_tpu_torch.models.registry import setup_model
from tts_tpu_torch.models.tacotron2 import Tacotron2
from tts_tpu_torch.models.vocoder.fold import fold_weight_norm
from tts_tpu_torch.models.vocoder.registry import setup_generator
from tts_tpu_torch.models.vocoder.serving import fused_inference, pack_stacks
from tts_tpu_torch.ops.cuda.fused_melgan import (megakernel_inference,
                                                 megakernel_supported,
                                                 pack_generator_params)
from tts_tpu_torch.text import num_symbols

_SENTENCE_RE = re.compile(r"(?<=[.!?])\s+(?=[A-Z\"'(])|(?<=[.!?])$")


def split_into_sentences(text: str) -> List[str]:
    parts = [s.strip() for s in _SENTENCE_RE.split(text.strip())]
    return [s for s in parts if s]


def load_checkpoint(path: str) -> Dict:
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    return ckpt if "model" in ckpt else {"model": ckpt}


def load_state_dict(path: str) -> Dict[str, torch.Tensor]:
    return load_checkpoint(path)["model"]


class Synthesizer:
    def __init__(self, tts_checkpoint: str, tts_config: str,
                 vocoder_checkpoint: str, vocoder_config: str,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.tts_config = load_config(tts_config)
        self.ap = AudioProcessor(**self.tts_config.audio)
        self.model = setup_model(
            num_symbols(self.tts_config.get("use_phonemes", False)),
            self.tts_config.get("num_speakers", 1), self.tts_config)
        ckpt = load_checkpoint(tts_checkpoint)
        self.model.load_state_dict(ckpt["model"])
        self.model.to(self.device).eval()
        if isinstance(self.model, GlowTTS):
            self.model.store_inverse()
        # serve at the checkpoint's reduction factor: a gradual-training
        # run stopped mid-schedule serves at its trained r, not the config's
        if isinstance(self.model, Tacotron2) and ckpt.get("r"):
            self.model.set_r(int(ckpt["r"]))

        self.vocoder_config = load_config(vocoder_config)
        self.vocoder_ap = AudioProcessor(**self.vocoder_config.audio)
        # fold weight norm once at load: serving runs bare kernels
        sd = fold_weight_norm(load_state_dict(vocoder_checkpoint))
        gen = setup_generator(self.vocoder_config, use_weight_norm=False)
        gen.load_state_dict(sd)
        self.vocoder_model = gen.to(self.device).eval()
        if megakernel_supported(gen):
            self._packed = pack_generator_params(gen, sd, self.device)
            self._stacks = None
        else:
            self._packed = None
            self._stacks = pack_stacks(self.vocoder_model)

    @torch.no_grad()
    def _vocode(self, mel_norm: np.ndarray) -> np.ndarray:
        """Normalized mel (T, n_mels) -> waveform through the kernels.

        As in tts_tpu, the mel length is bucketed (rounded up to 32 frames,
        edge-padded) and the waveform is cut back to ``n * hop`` samples. The
        generator has already edge-padded ``inference_padding`` frames, so
        the cut keeps pad-generated lead samples and drops real tail samples;
        this is kept on purpose so served audio matches tts_tpu."""
        n = mel_norm.shape[0]
        nb = max(32, -(-n // 32) * 32)
        if nb > n:
            mel_norm = np.pad(mel_norm, ((0, nb - n), (0, 0)), mode="edge")
        mel = torch.from_numpy(np.ascontiguousarray(mel_norm, np.float32))
        mel = mel[None].to(self.device)
        gen = self.vocoder_model
        if self._packed is not None:
            wav = megakernel_inference(gen, self._packed, mel)
        else:
            wav = fused_inference(gen, self._stacks, mel)
        wav = wav[0, :, 0].cpu().numpy()
        hop = self.vocoder_ap.hop_length
        return wav[:n * hop] if n < nb else wav

    def tts(self, text: str) -> np.ndarray:
        """Text -> waveform, sentence by sentence with silence joins."""
        start = time.time()
        wavs: List[np.ndarray] = []
        for sentence in split_into_sentences(text) or [text]:
            generator = torch.Generator(self.device).manual_seed(0)
            result = synthesis(self.model, sentence, self.tts_config,
                               self.device, generator=generator)
            wavs.append(self._vocode(result["postnet_outputs"]))
            wavs.append(np.zeros(10000, np.float32))  # inter-sentence gap
        out = np.concatenate(wavs)
        process_time = time.time() - start
        audio_time = len(out) / self.ap.sample_rate
        print(f" > Processing time: {process_time:.3f}")
        print(f" > Real-time factor: {process_time / max(audio_time, 1e-6):.3f}")
        return out

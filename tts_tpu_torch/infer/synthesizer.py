"""Synthesizer: checkpointed Glow-TTS, Tacotron2 or Tacotron (v1) + an
optional GAN vocoder (the MelGAN family, ParallelWaveGAN or the iSTFT
MelGAN) or WaveRNN, sentence-wise, and streamed chunk by chunk for
Tacotron2 (``tts_stream``) (≙ tts_tpu/infer/synthesizer.py).

Each checkpoint is either the port's ``torch.save({"model": state_dict,
...})`` file (a Mozilla TTS state dict loads as it is, since the port keeps
its key names) or a tts_tpu checkpoint (flax msgpack, read without flax and
converted by ``compat/from_jax.py::state_dict_from_tts_tpu``); the format is
told by the file's first bytes. A Tacotron2 checkpoint's r (``"r"``, or
tts_tpu's ``meta["r"]``: a gradual-training run's r) is served, and so is
a Tacotron v1 one's. Without a vocoder the waveform is Griffin-Lim on the
host, as in tts_tpu. Tacotron v1 outputs a linear spectrogram, which no
mel vocoder reads: with a vocoder it is refused at load (ValueError;
tts_tpu hands the generator the linear bins and fails at the first
request, ROADMAP C26).

Glow-TTS runs its encoder as one fused call (B3; packed once at load); a
Tacotron2 whose configuration the fused decode supports runs the B7 and B8
kernels on the card (``infer/synthesis.py::run_model``). On ``cuda`` (the
default) a MelGAN-family vocoder always runs through the hand-written
kernels: ``megakernel_inference`` when the upsample factors are even, else
the per-stack path ``fused_inference``. On ``device="cpu"`` the same calls
take their plain PyTorch versions. Any other generator serves through its
module's ``inference`` with folded weights, as in tts_tpu (no TPU kernel
stands behind those either). ParallelWaveGAN's noise comes from a CPU
generator seeded 0 for each sentence, so a request gives the same audio
on every device: tts_tpu's Synthesizer passes that model no noise key and
raises (ROADMAP C18), and this is the rule tts_tpu applies to its other
stochastic vocoder, WaveRNN (``PRNGKey(0)``). The port's WaveRNN follows
it too: its mel is edge-padded by ``pad`` context frames and sampled
(``WaveRNN.generate``, the whole loop on the model's device) with uniforms
drawn in one call from a CPU generator seeded 0 for each sentence. A
WaveRNN whose upsampling is not the audio's hop is refused at load.
"""

from __future__ import annotations

import re
import time
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from tts_tpu_torch import DeviceLike, resolve_device
from tts_tpu_torch.audio import AudioProcessor
from tts_tpu_torch.compat.from_jax import state_dict_from_tts_tpu
from tts_tpu_torch.config import load_config
from tts_tpu_torch.infer.streaming import stream_mel_chunks
from tts_tpu_torch.infer.synthesis import (TEXT_BUCKETS, check_speaker_id,
                                           inv_spectrogram, synthesis)
from tts_tpu_torch.models.glow_tts import GlowTTS
from tts_tpu_torch.models.registry import setup_model
from tts_tpu_torch.models.tacotron import Tacotron
from tts_tpu_torch.models.tacotron2 import Tacotron2
from tts_tpu_torch.models.vocoder.fold import fold_weight_norm
from tts_tpu_torch.models.vocoder.istft_melgan import ISTFTMelganGenerator
from tts_tpu_torch.models.vocoder.melgan import MelganGenerator
from tts_tpu_torch.models.vocoder.pwgan import ParallelWaveganGenerator
from tts_tpu_torch.models.vocoder.registry import setup_generator
from tts_tpu_torch.models.vocoder.serving import fused_inference, pack_stacks
from tts_tpu_torch.models.vocoder.wavernn import WaveRNN
from tts_tpu_torch.ops.cuda.fused_melgan import (megakernel_inference,
                                                 megakernel_supported,
                                                 pack_generator_params)
from tts_tpu_torch.ops.glow_encoder import supports_fused_encoder
from tts_tpu_torch.text import num_symbols
from tts_tpu_torch.train.checkpoint import (is_torch_checkpoint,
                                            load_tts_tpu_checkpoint)

_SENTENCE_RE = re.compile(r"(?<=[.!?])\s+(?=[A-Z\"'(])|(?<=[.!?])$")


def split_into_sentences(text: str) -> List[str]:
    parts = [s.strip() for s in _SENTENCE_RE.split(text.strip())]
    return [s for s in parts if s]


def load_checkpoint(path: str, c: Dict) -> Dict:
    """{"model": the port's state dict[, "r": r]} from a torch checkpoint or
    a tts_tpu one (``c`` names the model that the converter maps)."""
    if is_torch_checkpoint(path):
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
        return ckpt if "model" in ckpt else {"model": ckpt}
    ckpt = load_tts_tpu_checkpoint(path)
    return {"model": state_dict_from_tts_tpu(ckpt, c),
            "r": ckpt["meta"].get("r")}


class Synthesizer:
    def __init__(self, tts_checkpoint: str, tts_config: str,
                 vocoder_checkpoint: Optional[str] = None,
                 vocoder_config: Optional[str] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.tts_config = load_config(tts_config)
        self.ap = AudioProcessor(**self.tts_config.audio)
        self.model = setup_model(
            num_symbols(self.tts_config.get("use_phonemes", False)),
            self.tts_config.get("num_speakers", 1), self.tts_config)
        ckpt = load_checkpoint(tts_checkpoint, self.tts_config)
        self.model.load_state_dict(ckpt["model"])
        self.model.to(self.device).eval()
        if isinstance(self.model, GlowTTS):
            self.model.store_inverse()
            if supports_fused_encoder(self.model.encoder):
                self.model.encoder.packed_weights()   # B3's operands, once
        # serve at the checkpoint's reduction factor: a gradual-training
        # run stopped mid-schedule serves at its trained r, not the config's
        if isinstance(self.model, (Tacotron, Tacotron2)) and ckpt.get("r"):
            self.model.set_r(int(ckpt["r"]))

        self.vocoder_model = None
        if vocoder_checkpoint:
            self._load_vocoder(vocoder_checkpoint, vocoder_config)

    def _load_vocoder(self, checkpoint: str, config: str) -> None:
        if isinstance(self.model, Tacotron):
            raise ValueError(
                "Tacotron (v1) outputs a linear spectrogram of "
                f"{self.model.last_linear.out_features} bins, which a mel "
                "vocoder cannot read; serve it without a vocoder "
                "(Griffin-Lim)")
        self.vocoder_config = load_config(config)
        self.vocoder_ap = AudioProcessor(**self.vocoder_config.audio)
        # fold weight norm once at load: serving runs bare kernels
        sd = fold_weight_norm(load_checkpoint(checkpoint,
                                              self.vocoder_config)["model"])
        gen = setup_generator(self.vocoder_config, use_weight_norm=False)
        # the iSTFT family emits prod(upsample_factors) * hop_head samples
        # per frame: fail at load, as tts_tpu does, where that is not the
        # audio's hop
        if (isinstance(gen, ISTFTMelganGenerator)
                and gen.hop != self.vocoder_ap.hop_length):
            raise ValueError(
                f"iSTFT-MelGAN total hop ({gen.hop}) != vocoder audio "
                f"hop_length ({self.vocoder_ap.hop_length}); fix the vocoder "
                f"config")
        # WaveRNN generates prod(upsample_factors) samples per frame: fail
        # at load, as tts_tpu does, where that is not the audio's hop
        if isinstance(gen, WaveRNN) and gen.hop != self.vocoder_ap.hop_length:
            raise ValueError(
                f"WaveRNN upsample_factors product ({gen.hop}) != vocoder "
                f"audio hop_length ({self.vocoder_ap.hop_length}); fix the "
                f"vocoder config")
        gen.load_state_dict(sd)
        self.vocoder_model = gen.to(self.device).eval()
        self._packed = self._stacks = None
        if not isinstance(gen, MelganGenerator):
            return                          # the module's own inference
        if megakernel_supported(gen):
            self._packed = pack_generator_params(gen, sd, self.device)
        else:
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
            wav = megakernel_inference(gen, self._packed, mel)[0, :, 0]
        elif self._stacks is not None:
            wav = fused_inference(gen, self._stacks, mel)[0, :, 0]
        elif isinstance(gen, ParallelWaveganGenerator):
            wav = gen.inference(mel.transpose(1, 2),
                                torch.Generator().manual_seed(0))[0, 0]
        elif isinstance(gen, WaveRNN):
            # tts_tpu's steps: edge-pad the context frames, then sample
            # with draws from a generator seeded 0 for each sentence
            mel_p = torch.nn.functional.pad(mel.transpose(1, 2),
                                            (gen.pad, gen.pad),
                                            mode="replicate")
            wav = gen.generate(mel_p, torch.Generator().manual_seed(0))[0]
        else:
            wav = gen.inference(mel.transpose(1, 2))[0, 0]
        wav = wav.cpu().numpy()
        hop = self.vocoder_ap.hop_length
        return wav[:n * hop] if n < nb else wav

    def tts(self, text: str, speaker_id: Optional[int] = None) -> np.ndarray:
        """Text -> waveform, sentence by sentence with silence joins; the
        vocoder's, or Griffin-Lim's when none is served. ``speaker_id``
        picks the speaker of a multi-speaker model (built with the config's
        ``num_speakers``); a single-speaker model ignores it. As in
        tts_tpu, this is the only conditioning ``tts`` passes: a model that
        reads external d-vectors or a GST style mel cannot be served
        through it (ROADMAP C20, C21); ``infer/synthesis.py::synthesis``
        takes both. An id outside the model's speakers raises ValueError
        before anything runs (``check_speaker_id``)."""
        check_speaker_id(self.model, speaker_id)
        start = time.time()
        wavs: List[np.ndarray] = []
        use_gl = self.vocoder_model is None
        for sentence in split_into_sentences(text) or [text]:
            generator = torch.Generator(self.device).manual_seed(0)
            result = synthesis(
                self.model, sentence, self.tts_config, self.device,
                generator=generator, ap=self.ap, use_griffin_lim=use_gl,
                do_trim_silence=self.tts_config.get("do_trim_silence",
                                                    False),
                speaker_id=speaker_id)
            wavs.append(result["wav"] if use_gl
                        else self._vocode(result["postnet_outputs"]))
            wavs.append(np.zeros(10000, np.float32))  # inter-sentence gap
        out = np.concatenate(wavs)
        process_time = time.time() - start
        audio_time = len(out) / self.ap.sample_rate
        print(f" > Processing time: {process_time:.3f}")
        print(f" > Real-time factor: {process_time / max(audio_time, 1e-6):.3f}")
        return out

    def tts_stream(self, text: str, speaker_id: Optional[int] = None,
                   chunk_chars: int = 48, decoder_steps: int = 128
                   ) -> Iterator[np.ndarray]:
        """Waveform chunks of ``text`` as they are ready (≙
        ``tts_stream``): each sentence is cut at word boundaries into
        chunks of at most ``chunk_chars`` characters, each chunk decoded
        by ``infer/streaming.py::stream_mel_chunks`` (the decoder state
        carried over) in ``decoder_steps`` steps and vocoded at once
        (``_vocode``: B1/B2 for the MelGAN family) or turned to audio by
        Griffin-Lim; 10,000 samples of silence follow each sentence.
        Tacotron2 only: Glow-TTS raises ValueError, Tacotron v1
        AttributeError (it has no ``inference_truncated``, as in tts_tpu:
        ROADMAP C25)."""
        check_speaker_id(self.model, speaker_id)
        for sentence in split_into_sentences(text) or [text]:
            for piece in stream_mel_chunks(
                    self.model, sentence, self.tts_config, self.device,
                    chunk_chars=chunk_chars, decoder_steps=decoder_steps,
                    speaker_id=speaker_id):
                mel = piece["mel"]
                if mel.shape[0] == 0:
                    continue
                if self.vocoder_model is not None:
                    yield self._vocode(mel)
                else:
                    yield inv_spectrogram(mel, self.ap, self.tts_config)
            yield np.zeros(10000, np.float32)  # inter-sentence gap

    def prewarm(self, buckets: Optional[List[int]] = None) -> float:
        """Serve one sentence per text bucket (``buckets``, or every bucket
        up to 256 symbols), so that the first request does not pay what a
        process pays at first use: loading the kernels' libraries, cuBLAS
        and cuDNN set-up, each bucket's first run. Every bucket and not one:
        eager PyTorch compiles no program per shape, but on an H100 a
        bucket's first run still costs ~40 ms more than its second after
        another bucket has warmed the process, and the other five buckets
        add ~0.04 s to the prewarm (``chip_smoke.py``'s prewarm phase).
        A multi-speaker model prewarms as speaker 0 (tts_tpu's default).
        Returns its seconds (the server's ``--prewarm``)."""
        t0 = time.time()
        speaker_id = 0 if self.tts_config.get("num_speakers", 1) > 1 else None
        todo = buckets or [b for b in TEXT_BUCKETS if b <= 256]
        for b in todo:
            self.tts("a" * max(1, b - 2) + ".", speaker_id=speaker_id)
        seconds = time.time() - t0
        print(f" > Prewarmed {len(todo)} text buckets in {seconds:.2f}s",
              flush=True)
        return seconds

"""Export a checkpoint's serving function as a ``torch.export`` program
(``.pt2``) (≙ tts_tpu/bin/export_model.py, which writes a TFLite file or a
TF SavedModel; the port does not depend on TensorFlow).

Usage:
  python -m tts_tpu_torch.bin.export_model --config_path c.json \
      --checkpoint_path model.pt --output_path model.pt2 \
      [--kind vocoder|tts] [--frames 256] [--y_max_length 400] [--batch 1]

``--kind vocoder``: a MelGAN-family generator as the Synthesizer serves
it, weight norm folded: mel (batch, frames, n_mels) -> waveform (batch,
samples), with the edge padding of its ``inference`` and, for
Multiband-MelGAN, PQMF synthesis. ``--kind tts``: text ids (batch, frames) and their lengths ->
the mel (batch, T, n_mels); Glow-TTS's ``inference`` at noise 0 with the
static frame budget ``--y_max_length``, a Tacotron's ``inference`` over the
config's ``max_decoder_steps`` (every step unrolled into the graph). The
trace runs on the CPU through the plain modules; the program is checked
against the eager function on the example inputs (``max_abs_diff``
printed) and can be moved to another device when it is run
(``export/deploy.py::run_program``).
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, Tuple

import torch
from torch import nn


class VocoderProgram(nn.Module):
    """mel (B, T, n_mels) -> waveform (B, samples): the generator's
    ``inference`` (edge padding, the generator, PQMF synthesis for
    Multiband-MelGAN) on folded weights."""

    def __init__(self, gen: nn.Module):
        super().__init__()
        self.gen = gen

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        gen = self.gen
        out = gen(gen.pad_inference(mel.transpose(1, 2)))
        if hasattr(gen, "pqmf"):
            out = gen.pqmf.synthesis(out)
        return out[:, 0]


class TTSProgram(nn.Module):
    """(text (B, T) ids, lengths (B,)) -> mel (B, T_mel, n_mels): Glow-TTS
    at noise 0 within ``y_max_length`` frames, or a Tacotron's greedy
    decode over ``max_decoder_steps``."""

    def __init__(self, model: nn.Module, y_max_length: int):
        super().__init__()
        self.model = model
        self.y_max_length = y_max_length

    def forward(self, text: torch.Tensor, lengths: torch.Tensor
                ) -> torch.Tensor:
        from tts_tpu_torch.models.glow_tts import GlowTTS
        if isinstance(self.model, GlowTTS):
            return self.model.inference(
                text, lengths, noise_scale=0.0,
                y_max_length=self.y_max_length)["model_outputs"]
        return self.model.inference(text, lengths)["postnet_outputs"]


def build_program(kind: str, config_path: str, checkpoint_path: str,
                  frames: int = 256, y_max_length: int = 400,
                  batch: int = 1) -> Tuple[nn.Module, Tuple[torch.Tensor, ...]]:
    """The module to export and its example inputs, on the CPU in eval
    mode."""
    from tts_tpu_torch.config import load_config
    from tts_tpu_torch.infer.synthesizer import load_checkpoint

    c = load_config(config_path)
    ckpt = load_checkpoint(checkpoint_path, c)
    if kind == "vocoder":
        from tts_tpu_torch.models.vocoder.fold import fold_weight_norm
        from tts_tpu_torch.models.vocoder.registry import setup_generator
        gen = setup_generator(c, use_weight_norm=False)
        gen.load_state_dict(fold_weight_norm(ckpt["model"]))
        n_mels = c["audio"].get("num_mels", 80)
        return (VocoderProgram(gen.eval()),
                (torch.zeros(batch, frames, n_mels),))
    from tts_tpu_torch.models.glow_tts import GlowTTS
    from tts_tpu_torch.models.registry import setup_model
    from tts_tpu_torch.text import num_symbols
    model = setup_model(num_symbols(c.get("use_phonemes", False)),
                        c.get("num_speakers", 1), c)
    model.load_state_dict(ckpt["model"])
    model.eval()
    if isinstance(model, GlowTTS):
        from tts_tpu_torch.models.weight_norm import remove_weight_norm
        remove_weight_norm(model)
        model.store_inverse()
    elif ckpt.get("r"):
        model.set_r(int(ckpt["r"]))
    text = torch.zeros(batch, frames, dtype=torch.int64)
    lengths = torch.full((batch,), frames, dtype=torch.int32)
    return TTSProgram(model, y_max_length), (text, lengths)


def main(argv=None) -> Dict:
    from tts_tpu_torch.export import export_program, max_abs_diff, run_program
    parser = argparse.ArgumentParser()
    parser.add_argument("--config_path", required=True)
    parser.add_argument("--checkpoint_path", required=True)
    parser.add_argument("--output_path", required=True)
    parser.add_argument("--kind", choices=["vocoder", "tts"],
                        default="vocoder")
    parser.add_argument("--frames", type=int, default=256,
                        help="mel frames (vocoder) or text length (tts) of "
                             "the program's input")
    parser.add_argument("--y_max_length", type=int, default=400,
                        help="Glow-TTS: the static mel-frame budget")
    parser.add_argument("--batch", type=int, default=1)
    args = parser.parse_args(argv)
    module, example = build_program(args.kind, args.config_path,
                                    args.checkpoint_path, args.frames,
                                    args.y_max_length, args.batch)
    t0 = time.perf_counter()
    program = export_program(module, example, args.output_path)
    seconds = time.perf_counter() - t0
    with torch.no_grad():
        eager = module(*example)
    err = max_abs_diff(run_program(program, *example), eager)
    print(f" > exported {args.kind} to {args.output_path} in {seconds:.1f} s;"
          f" max |exported - eager| {err:.3g}")
    return {"path": args.output_path, "export_s": seconds,
            "max_abs_diff": err}


if __name__ == "__main__":
    main()

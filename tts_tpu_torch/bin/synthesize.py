"""Synthesis CLI (≙ tts_tpu/bin/synthesize.py): text -> WAV file, printing
the run time and the real-time factor.

    python -m tts_tpu_torch.bin.synthesize "Text." CONFIG MODEL [OUT_DIR] \
        [--vocoder_path V --vocoder_config_path VC] [--speaker_id N] \
        [--device cpu]

MODEL and V may each be a port checkpoint (``torch.save``) or a tts_tpu
checkpoint (flax msgpack). Without a vocoder the waveform is Griffin-Lim.
Runs on CUDA unless ``--device`` names another device. The file is written
under tts_tpu's name rule: the words joined by ``_``, cut to 40 characters,
dots dropped, ``.wav``.
"""

from __future__ import annotations

import argparse
import os
import time


def main(argv=None) -> str:
    parser = argparse.ArgumentParser()
    parser.add_argument("text")
    parser.add_argument("config_path")
    parser.add_argument("model_path")
    parser.add_argument("out_path", nargs="?", default="tts_output")
    parser.add_argument("--vocoder_path", default=None)
    parser.add_argument("--vocoder_config_path", default=None)
    parser.add_argument("--speaker_id", type=int, default=None)
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda)")
    args = parser.parse_args(argv)
    if not args.text.strip():
        parser.error("text is empty")
    if args.vocoder_path and not args.vocoder_config_path:
        parser.error("--vocoder_path needs --vocoder_config_path")

    from tts_tpu_torch.audio.processor import write_wav
    from tts_tpu_torch.infer.synthesizer import Synthesizer

    synth = Synthesizer(args.model_path, args.config_path, args.vocoder_path,
                        args.vocoder_config_path, device=args.device)
    t0 = time.time()
    wav = synth.tts(args.text, speaker_id=args.speaker_id)
    dt = time.time() - t0
    audio_s = len(wav) / synth.ap.sample_rate
    print(f" > Run-time: {dt:.3f}s")
    print(f" > Real-time factor: {dt / max(audio_s, 1e-6):.4f}")

    os.makedirs(args.out_path, exist_ok=True)
    file_name = "_".join(args.text.split())[:40].replace(".", "") + ".wav"
    out_file = os.path.join(args.out_path, file_name)
    write_wav(out_file, wav, synth.ap.sample_rate)
    print(f" > Saved: {out_file}")
    return out_file


if __name__ == "__main__":
    main()

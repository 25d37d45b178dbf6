"""A Mozilla TTS or fatchord WaveRNN checkpoint (``.pth.tar``) -> a port
checkpoint (≙ tts_tpu/bin/convert_torch_checkpoint.py).

Usage:
  python -m tts_tpu_torch.bin.convert_torch_checkpoint \
      --model_type tacotron2 --config_path config.json \
      --torch_checkpoint model.pth.tar --out_dir ./converted [--num_chars N]

The port keeps Mozilla's and fatchord's key names, so conversion is a
strict load into the model that the config builds (``--model_type`` names
tts_tpu's nine: tacotron2, tacotron, glow_tts, melgan, multiband_melgan,
fullband_melgan, pwgan, speaker_encoder, wavernn, and must agree with the
config), after a key check that names what the file has and the model
lacks (a file with more residual blocks or upsample stages than the
config raises, as tts_tpu's converter does) and what it lacks. The one
change of layout is the port's single RNN bias: each LSTM's ``bias_hh`` and
the r and z thirds of each GRU's are added into ``bias_ih`` and zeroed (the
same function; tts_tpu's converter sums them the same way). Weight norm is
kept as the file has it; the Synthesizer folds it at load. The result is
``<out_dir>/converted_<model_type>_0.pt`` (``train/checkpoint.py``, with
the file's ``r`` where it has one), which the Synthesizer, the server and
the CLI serve.

The file is read with ``torch.load(weights_only=True)``: tensors and
plain containers, no code (tts_tpu unpickles anything). A file that also
holds objects, such as a config object, is refused with a ValueError; if
you trust it, load it with ``weights_only=False`` yourself and save its
``"model"`` entry alone.
"""

from __future__ import annotations

import argparse
import pickle
from typing import Dict, Optional

import torch
from torch import nn

MODEL_TYPES = ("tacotron2", "tacotron", "glow_tts", "melgan",
               "multiband_melgan", "fullband_melgan", "pwgan",
               "speaker_encoder", "wavernn")
GENERATORS = {"melgan": "melgan_generator",
              "multiband_melgan": "multiband_melgan_generator",
              "fullband_melgan": "fullband_melgan_generator",
              "pwgan": "parallel_wavegan_generator",
              "wavernn": "wavernn"}
EMBEDDINGS = {"tacotron2": "embedding.weight", "tacotron": "embedding.weight",
              "glow_tts": "encoder.emb.weight"}


def build_model(model_type: str, c: Dict, sd: Dict[str, torch.Tensor],
                num_chars: Optional[int] = None) -> nn.Module:
    """The port's model of ``model_type`` as the config ``c`` sizes it;
    a TTS model takes ``num_chars`` symbols (the file's embedding rows by
    default)."""
    if model_type in GENERATORS:
        name = c.get("generator_model", "").lower()
        if name != GENERATORS[model_type]:
            raise ValueError(f"--model_type {model_type} needs a config with "
                             f"generator_model {GENERATORS[model_type]!r}, "
                             f"not {name!r}")
        from tts_tpu_torch.models.vocoder.registry import setup_generator
        return setup_generator(c)
    if model_type == "speaker_encoder":
        from tts_tpu_torch.models.speaker_encoder import SpeakerEncoder
        m = c.get("model")
        if not isinstance(m, dict):
            raise ValueError("--model_type speaker_encoder needs a speaker "
                             "encoder config (its 'model' a dict of widths)")
        return SpeakerEncoder(
            input_dim=m.get("input_dim", c["audio"].get("num_mels", 40)),
            proj_dim=m.get("proj_dim", 256), lstm_dim=m.get("lstm_dim", 768),
            num_lstm_layers=m.get("num_lstm_layers", 3))
    name = str(c.get("model", "")).lower()
    if name != model_type:
        raise ValueError(f"--model_type {model_type} needs a config with "
                         f"model {model_type!r}, not {name!r}")
    from tts_tpu_torch.models.registry import setup_model
    n = num_chars or int(sd[EMBEDDINGS[model_type]].shape[0])
    return setup_model(n, c.get("num_speakers", 1), c)


def check_keys(model: nn.Module, sd: Dict[str, torch.Tensor]) -> None:
    """ValueError naming the keys the file has and the model lacks (more
    blocks or stages than the config gives) and those it lacks."""
    want = set(model.state_dict())
    extra = sorted(set(sd) - want)
    missing = sorted(want - set(sd))
    if extra:
        raise ValueError(
            f"the checkpoint has {len(extra)} entries the config's model "
            f"lacks (e.g. {extra[0]}): more residual blocks, upsample "
            f"stages or layers than the config gives? Pass its true config")
    if missing:
        raise ValueError(f"the checkpoint lacks {len(missing)} entries of "
                         f"the config's model (e.g. {missing[0]})")


def fold_rnn_biases(model: nn.Module, sd: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
    """``sd`` with each LSTM's whole ``bias_hh`` and each GRU's r and z
    thirds added into ``bias_ih`` and zeroed there: one bias per gate, the
    port's layout, computing the same function."""
    out = dict(sd)
    for prefix, mod in model.named_modules():
        if isinstance(mod, (nn.LSTM, nn.LSTMCell)):
            share = 1.0
        elif isinstance(mod, (nn.GRU, nn.GRUCell)):
            share = 2.0 / 3.0            # the r and z gates, not n
        else:
            continue
        for name, _ in mod.named_parameters(recurse=False):
            if not name.startswith("bias_hh"):
                continue
            key_hh = f"{prefix}.{name}" if prefix else name
            key_ih = key_hh.replace("bias_hh", "bias_ih")
            b_hh = out[key_hh].clone()
            n = int(b_hh.shape[0] * share)
            out[key_ih] = out[key_ih].clone()
            out[key_ih][:n] += b_hh[:n]
            b_hh[:n] = 0
            out[key_hh] = b_hh
    return out


def read_torch_checkpoint(path: str) -> Dict:
    """The file's dict, its state dict under ``"model"``."""
    try:
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as e:
        raise ValueError(
            f"{path} holds more than tensors and plain containers ({e}); "
            f"if you trust it, load it with weights_only=False and save "
            f"its 'model' entry alone") from e
    return ckpt if isinstance(ckpt, dict) and "model" in ckpt \
        else {"model": ckpt}


def convert(model_type: str, torch_checkpoint: str, out_dir: str,
            config_path: str, num_chars: Optional[int] = None) -> str:
    from tts_tpu_torch.config import load_config
    from tts_tpu_torch.train.checkpoint import save_checkpoint

    model_type = model_type.lower()
    if model_type not in MODEL_TYPES:
        raise ValueError(f"unknown model_type {model_type!r}")
    c = load_config(config_path)
    src = read_torch_checkpoint(torch_checkpoint)
    sd = {k: v.detach().float() if v.is_floating_point() else v.detach()
          for k, v in src["model"].items()}
    model = build_model(model_type, c, sd, num_chars)
    check_keys(model, sd)
    model.load_state_dict(fold_rnn_biases(model, sd), strict=True)
    r = src.get("r") if model_type in ("tacotron", "tacotron2") else None
    return save_checkpoint(out_dir, model=model, step=0, config=dict(c),
                           prefix=f"converted_{model_type}",
                           r=int(r) if r else None)


def main(argv=None) -> str:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--model_type", required=True, choices=MODEL_TYPES)
    parser.add_argument("--torch_checkpoint", required=True)
    parser.add_argument("--out_dir", required=True)
    parser.add_argument("--config_path", required=True)
    parser.add_argument("--num_chars", type=int, default=None)
    args = parser.parse_args(argv)
    path = convert(args.model_type, args.torch_checkpoint, args.out_dir,
                   args.config_path, args.num_chars)
    print(f" > Converted -> {path}")
    return path


if __name__ == "__main__":
    main()

"""The port's ``bin/convert_torch_checkpoint`` against tts_tpu's
converter, on the CPU: a seeded port model written as a legacy
``torch.save`` ``.pth.tar`` (Mozilla's format), converted by both packages,
the two results loaded into the port give the same outputs (1e-5 of their
largest magnitude), and the same as the source model; key checks; the two
model types tts_tpu cannot convert here. Helpers from
``test_torch_port_tooling.py``; narrow models.
"""

import json
import os

import numpy as np
import pytest
import torch

from tests.test_torch_port_tooling import (ROOT, TACO_SMALL, GLOW_SMALL,
                                           corpus, write_config)
from tts_tpu_torch.config import load_config

__all__ = ["corpus"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _vocoder_config(tmp_path, name, generator, params):
    c = dict(load_config(os.path.join(ROOT, "configs",
                                      "multiband_melgan.json")))
    c["generator_model"] = generator
    c["generator_model_params"] = params
    path = tmp_path / f"{name}.json"
    path.write_text(json.dumps(c, default=dict))
    return c, str(path)


CONVERTED = {
    "tacotron2": ("tacotron2_ljspeech", TACO_SMALL),
    "tacotron": ("tacotron2_ljspeech", dict(TACO_SMALL, model="tacotron")),
    "melgan": ("melgan_generator", dict(base_channels=32,
                                        upsample_factors=[8, 8, 2, 2])),
    "multiband_melgan": ("multiband_melgan_generator",
                         dict(base_channels=32, upsample_factors=[2, 8, 2, 2])),
    "pwgan": ("parallel_wavegan_generator", {}),
    "wavernn": ("wavernn", dict(rnn_dims=32, fc_dims=24, compute_dims=16,
                                res_out_dims=16)),
    "speaker_encoder": ("speaker_encoder", {}),
}


def converted_config(tmp_path, model_type, corpus):
    name, params = CONVERTED[model_type]
    if model_type in ("tacotron2", "tacotron"):
        return write_config(tmp_path, name, corpus, **params)
    if model_type == "speaker_encoder":
        c = dict(load_config(os.path.join(ROOT, "configs",
                                          "speaker_encoder.json")))
        c["model"] = dict(c["model"], lstm_dim=48, proj_dim=16)
        path = tmp_path / "speaker_encoder.json"
        path.write_text(json.dumps(c, default=dict))
        return c, str(path)
    return _vocoder_config(tmp_path, model_type, name, params)


def _outputs(model_type, model):
    """The model's output on seeded inputs, in eval mode."""
    model.eval()
    rng = np.random.default_rng(0)
    mel = torch.from_numpy(rng.standard_normal((1, 80, 10), np.float32))
    with torch.no_grad():
        if model_type in ("tacotron2", "tacotron"):
            text = torch.from_numpy(rng.integers(1, 40, (2, 13)))
            target = torch.from_numpy(rng.standard_normal((2, 8, 80),
                                                          np.float32))
            out = model(text, torch.tensor([13, 9]), target)
            return out["postnet_outputs"]
        if model_type == "speaker_encoder":
            return model(torch.from_numpy(rng.standard_normal(
                (2, 20, 40), np.float32)))
        if model_type == "wavernn":
            x = torch.from_numpy(rng.uniform(-1, 1, (1, 6 * model.hop))
                                 .astype(np.float32))
            return model(x, mel)
        if model_type == "pwgan":
            return model.inference(mel, torch.Generator().manual_seed(0))
        return model.inference(mel)


def _port_model(model_type, c, sd):
    from tts_tpu_torch.bin.convert_torch_checkpoint import build_model
    model = build_model(model_type, c, sd)
    model.load_state_dict(sd)
    return model


@pytest.mark.parametrize("model_type", sorted(CONVERTED))
def test_converter_matches_tts_tpu(model_type, corpus, tmp_path):
    """A seeded port model saved as a legacy ``torch.save`` ``.pth.tar``
    (Mozilla's format; ``"r"`` 2 beside a Tacotron's weights) and converted
    by the port, against tts_tpu's ``convert`` of the same file read back
    through the port's tts_tpu loader: the same outputs. The port's file
    has one bias per RNN gate. tts_tpu's converter cannot be compared for
    the other two types: its ``glow_tts`` builds Mozilla's default Glow-TTS
    (no encoder prenet, no relative attention window), which its registry
    does not build; its ``fullband_melgan`` reads three residual blocks,
    and the fullband generator has four (see the next test)."""
    from tts_tpu.bin.convert_torch_checkpoint import convert as j_convert
    from tts_tpu_torch.bin.convert_torch_checkpoint import (build_model,
                                                            main)
    from tts_tpu_torch.compat.from_jax import \
        speaker_encoder_state_dict_from_jax
    from tts_tpu_torch.infer.synthesizer import load_checkpoint
    from tts_tpu_torch.train.checkpoint import load_tts_tpu_checkpoint

    c, cfg = converted_config(tmp_path, model_type, corpus)
    torch.manual_seed(1)
    source = build_model(model_type, c, {"embedding.weight":
                                         torch.zeros(40, 1)}, None)
    sd = source.state_dict()
    for key, value in sd.items():          # non-trivial BatchNorm statistics
        if key.endswith("running_var"):
            value.uniform_(0.5, 1.5)
        elif key.endswith("running_mean"):
            value.normal_(0.0, 0.1)
    src = tmp_path / "model.pth.tar"
    torch.save({"model": sd, "r": 2, "step": 7}, src,
               _use_new_zipfile_serialization=False)

    path = main(["--model_type", model_type, "--torch_checkpoint", str(src),
                 "--out_dir", str(tmp_path / "port"), "--config_path", cfg])
    ours = torch.load(path, map_location="cpu", weights_only=True)
    assert ours.get("r") == (2 if model_type.startswith("tacotron")
                             else None)
    for key, value in ours["model"].items():
        if key.split(".")[-1].startswith("bias_hh"):
            n = value.shape[0] // (4 if "lstm" in key.lower()
                                   or "_rnn" in key else 3)
            assert not value[:2 * n].any(), key      # folded into bias_ih

    j_path = j_convert(model_type, str(src), str(tmp_path / "jax"), cfg)
    if model_type == "speaker_encoder":     # its params at the tree's root
        theirs = speaker_encoder_state_dict_from_jax(
            load_tts_tpu_checkpoint(j_path)["params"])
    else:
        theirs = load_checkpoint(j_path, c)["model"]
    got = _outputs(model_type, _port_model(model_type, c, ours["model"]))
    want = _outputs(model_type, _port_model(model_type, c, theirs))
    source.load_state_dict(sd)
    direct = _outputs(model_type, source)
    for other in (want, direct):
        assert got.shape == other.shape
        tol = 1e-5 * float(other.abs().max())
        assert float((got - other).abs().max()) <= tol


class _Config(dict):
    """A config object, as some Mozilla checkpoints pickle theirs."""


def test_converter_checks_keys_and_config(corpus, tmp_path):
    """A file with one more residual block than the config raises, as
    tts_tpu's converter does; a config of another model raises, and so
    does a file holding an object beside its tensors; Glow-TTS
    and the fullband generator (which tts_tpu cannot convert here) load
    strictly and keep their weights."""
    from tts_tpu_torch.bin.convert_torch_checkpoint import convert
    from tts_tpu_torch.models.registry import setup_model
    from tts_tpu_torch.models.vocoder.registry import setup_generator
    from tts_tpu_torch.text import num_symbols

    c, cfg = _vocoder_config(tmp_path, "wavernn", "wavernn",
                             dict(rnn_dims=16, fc_dims=16, compute_dims=8,
                                  res_out_dims=8, res_blocks=3))
    deeper = setup_generator(dict(c, generator_model_params=dict(
        c["generator_model_params"], res_blocks=4)))
    src = tmp_path / "deeper.pth.tar"
    torch.save({"model": deeper.state_dict()}, src,
               _use_new_zipfile_serialization=False)
    with pytest.raises(ValueError, match="resnet.layers.3"):
        convert("wavernn", str(src), str(tmp_path / "out"), cfg)
    with pytest.raises(ValueError, match="generator_model"):
        convert("melgan", str(src), str(tmp_path / "out"), cfg)
    # a file holding an object beside its tensors is not unpickled
    torch.save({"model": deeper.state_dict(), "config": _Config(r=7)}, src,
               _use_new_zipfile_serialization=False)
    with pytest.raises(ValueError, match="plain containers"):
        convert("wavernn", str(src), str(tmp_path / "out"), cfg)

    glow_c, glow_cfg = write_config(tmp_path, "glow_tts_ljspeech", corpus,
                                    **GLOW_SMALL)
    fb_c, fb_cfg = _vocoder_config(tmp_path, "fullband",
                                   "fullband_melgan_generator",
                                   dict(base_channels=32))
    for model_type, model, cfg_path in (
            ("glow_tts", setup_model(num_symbols(True), 1, glow_c), glow_cfg),
            ("fullband_melgan", setup_generator(fb_c), fb_cfg)):
        src = tmp_path / f"{model_type}.pth.tar"
        sd = model.state_dict()
        torch.save(sd, src, _use_new_zipfile_serialization=False)
        path = convert(model_type, str(src), str(tmp_path / "out"), cfg_path)
        got = torch.load(path, map_location="cpu", weights_only=True)["model"]
        assert got.keys() == sd.keys()
        assert all(torch.equal(got[k], sd[k]) for k in sd)



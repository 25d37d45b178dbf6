"""The port's ``torch.export`` deployment on the CPU: ``bin/export_model``
writes a ``.pt2`` of a small Multiband-MelGAN (its served ``inference``),
Glow-TTS (noise 0, a static frame budget; 3 flow blocks) and Tacotron2 (4 decoder steps,
unrolled); ``export/deploy.py::load_program`` reads it back and the
program on fresh inputs equals the eager function within 1e-5 of its
largest magnitude. Helpers from ``test_torch_port_tooling.py`` and
``test_torch_port_convert.py``.
"""

import os

import numpy as np
import pytest
import torch

from tests.test_torch_port_convert import _vocoder_config
from tests.test_torch_port_tooling import (GLOW_SMALL, TACO_SMALL, corpus,
                                           shallow_glow, write_config)

__all__ = ["corpus", "shallow_glow"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _export_case(kind, corpus, tmp_path):
    """(config path, checkpoint path, CLI flags) of a small seeded model."""
    from tts_tpu_torch.models.registry import setup_model
    from tts_tpu_torch.models.vocoder.registry import setup_generator
    from tts_tpu_torch.text import num_symbols
    torch.manual_seed(2)
    if kind == "vocoder":
        c, cfg = _vocoder_config(tmp_path, "mb", "multiband_melgan_generator",
                                 dict(base_channels=32,
                                      upsample_factors=[2, 8, 2, 2]))
        model, flags = setup_generator(c), ["--kind", "vocoder",
                                            "--frames", "12"]
    elif kind == "glow":
        c, cfg = write_config(tmp_path, "glow_tts_ljspeech", corpus,
                              **GLOW_SMALL)
        model = setup_model(num_symbols(True), 1, c)
        proj = model.encoder.duration_predictor.proj
        with torch.no_grad():
            proj.weight.zero_()
            proj.bias.fill_(float(np.log(3.5)))
        flags = ["--kind", "tts", "--frames", "9", "--y_max_length", "40"]
    else:
        c, cfg = write_config(tmp_path, "tacotron2_ljspeech", corpus,
                              max_decoder_steps=4, **TACO_SMALL)
        model = setup_model(num_symbols(True), 1, c)
        flags = ["--kind", "tts", "--frames", "9"]
    ckpt = tmp_path / "model.pt"
    torch.save({"model": model.state_dict()}, ckpt)
    return cfg, str(ckpt), flags


@pytest.mark.parametrize("kind", ["vocoder", "glow", "tacotron2"])
def test_export_round_trip(kind, corpus, tmp_path, shallow_glow):
    """``bin/export_model`` writes a ``.pt2`` that ``load_program`` reads
    back; the loaded program on fresh inputs equals the eager function
    (1e-5 of its largest magnitude); the vocoder's equals the served
    generator (``MultibandMelganGenerator.inference``)."""
    from tts_tpu_torch.bin.export_model import build_program, main
    from tts_tpu_torch.export import load_program, max_abs_diff, run_program

    cfg, ckpt, flags = _export_case(kind, corpus, tmp_path)
    out = str(tmp_path / "model.pt2")
    result = main(["--config_path", cfg, "--checkpoint_path", ckpt,
                   "--output_path", out] + flags)
    assert result["max_abs_diff"] <= 1e-6 and os.path.getsize(out) > 0
    module, example = build_program(
        "vocoder" if kind == "vocoder" else "tts", cfg, ckpt,
        frames=int(flags[3]),
        y_max_length=int(flags[5]) if kind == "glow" else 400)
    program = load_program(out)
    rng = np.random.default_rng(3)
    if kind == "vocoder":
        args = (torch.from_numpy(rng.standard_normal(example[0].shape,
                                                     np.float32)),)
    else:
        args = (torch.from_numpy(rng.integers(1, 40, example[0].shape)),
                torch.full_like(example[1], example[0].shape[1]))
    got = run_program(program, *args)
    with torch.no_grad():
        want = module(*args)
    assert got.shape == want.shape and float(want.abs().max()) > 1e-3
    assert max_abs_diff(got, want) <= 1e-5 * float(want.abs().max())
    if kind == "vocoder":
        served = module.gen.inference(args[0].transpose(1, 2))[:, 0]
        assert max_abs_diff(got, served) <= 1e-5 * float(want.abs().max())



"""The port's GAN vocoder trainer and CLI on the CPU, end to end: one epoch
of configs/multiband_melgan.json at full width on a tiny corpus, then the
generator checkpoint served through the port's Synthesizer. The step it
runs is held against tts_tpu's in tests/test_torch_port_gan_train.py.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from tests.fixtures import make_ljspeech_fixture

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and PyTorch's thread pool spinning against them made this file's
    full-width steps many times slower than on an idle machine."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_trainer_one_epoch_on_cpu_then_serves(tmp_path, monkeypatch):
    """The CLI trains configs/multiband_melgan.json at full width (its mixed
    precision on) on the 8-utterance fixture, 2 held out, batch 2 of 4,096
    samples (the shortest segment whose first upsampled stage outlasts the
    residual stack's reflect padding of 27), for one epoch of 3 steps, the
    first without the discriminator; the generator checkpoint serves
    through the port's Synthesizer. Without tensorboardX the trainer logs
    to the console only."""
    from tts_tpu_torch.bin.train_vocoder import main
    from tts_tpu_torch.config import load_config
    from tts_tpu_torch.infer.synthesizer import Synthesizer
    from tts_tpu_torch.models.registry import setup_model
    from tts_tpu_torch.text import num_symbols
    from tts_tpu_torch.train.checkpoint import latest_checkpoint

    corpus = make_ljspeech_fixture(str(tmp_path / "ljspeech"))
    c = load_config(os.path.join(ROOT, "configs", "multiband_melgan.json"))
    c.update(data_path=os.path.join(corpus, "wavs"), batch_size=2,
             seq_len=4096, epochs=1, eval_split_size=2,
             steps_to_start_discriminator=1)
    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    cfg = tmp_path / "vocoder.json"
    cfg.write_text(json.dumps(c))
    trainer = main(["--config_path", str(cfg), "--output_path",
                    str(tmp_path / "runs"), "--device", "cpu"])
    assert trainer.global_step == 3
    assert [s["train_disc"] for s in trainer.step_stats] == [False, True, True]
    for stats in trainer.step_stats:
        assert all(np.isfinite(v) for k, v in stats.items()
                   if k.startswith(("G_", "D_"))), stats
    ckpt = latest_checkpoint(trainer.output_path)
    assert os.path.basename(ckpt) == "checkpoint_3.pt"
    assert os.path.isfile(os.path.join(trainer.output_path,
                                       "checkpoint_disc_3.pt"))

    tts_cfg = os.path.join(ROOT, "configs", "glow_tts_ljspeech.json")
    tc = load_config(tts_cfg)
    torch.manual_seed(0)
    glow = setup_model(num_symbols(tc.get("use_phonemes", False)), 1, tc)
    with torch.no_grad():        # 6 frames per symbol, not expm1 of ~0
        glow.encoder.duration_predictor.proj.weight.zero_()
        glow.encoder.duration_predictor.proj.bias.fill_(float(np.log(6.5)))
    torch.save({"model": glow.state_dict()}, tmp_path / "glow.pt")
    synth = Synthesizer(str(tmp_path / "glow.pt"), tts_cfg, ckpt, str(cfg),
                        device="cpu")
    wav = synth.tts("Hello world.")
    assert wav.ndim == 1 and np.isfinite(wav).all()
    assert np.abs(wav).max() > 1e-3


def test_trainer_cli_raises_without_cuda(tmp_path, monkeypatch):
    """The trainer runs on CUDA unless --device names another device; with
    no card it raises instead of training on the CPU."""
    from tts_tpu_torch.bin.train_vocoder import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with open(os.path.join(ROOT, "configs", "multiband_melgan.json")) as f:
        cfg = tmp_path / "vocoder.json"
        cfg.write_text(f.read())
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--config_path", str(cfg), "--output_path",
              str(tmp_path / "runs")])


def test_latest_checkpoint_skips_the_discriminators(tmp_path):
    """``checkpoint_disc_<step>.pt`` matches the glob ``checkpoint_*`` but is
    not a generator checkpoint, whatever its step."""
    from tts_tpu_torch.train.checkpoint import latest_checkpoint

    for name in ("checkpoint_2.pt", "checkpoint_10.pt",
                 "checkpoint_disc_10.pt", "checkpoint_disc_99.pt",
                 "best_model.pt"):
        (tmp_path / name).write_bytes(b"")
    assert os.path.basename(latest_checkpoint(str(tmp_path))) == \
        "checkpoint_10.pt"
    assert os.path.basename(latest_checkpoint(
        str(tmp_path), prefix="checkpoint_disc")) == "checkpoint_disc_99.pt"
    assert latest_checkpoint(str(tmp_path / "missing")) is None

"""The port's Tacotron2 trainer and CLI on the CPU, and the Synthesizer's
prewarm.

``bin/train_tts.py`` trains configs/tacotron2_ljspeech.json at its widths
(DDC, mixed precision, phonemes, separate stopnet as shipped) for two
epochs of one step over a tiny LJSpeech-format corpus, with a gradual
schedule that moves r from 7 to 2 after the first step, an eval epoch and
the test sentences after each epoch. The checkpoint it writes serves
through the ``Synthesizer`` with the trained weights and r; the fast path's
packed weights (made at the first epoch's test sentences) follow the
second epoch's in-place update, so the fast path equals the plain
``Tacotron2.inference`` on the trained model, to 1e-5 (float32, other
orders of summation). A restored trainer holds the same weights, optimizer
state, step and r. The parity of the step with tts_tpu's is
``test_torch_port_taco2_train.py``'s.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from tests.fixtures import make_ljspeech_fixture

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 10
SENTENCE = "Be a voice, not an echo."


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _config(tmp_path, corpus):
    from tts_tpu_torch.config import load_config
    c = load_config(os.path.join(ROOT, "configs", "tacotron2_ljspeech.json"))
    c["datasets"] = [{"name": "ljspeech", "path": corpus,
                      "meta_file_train": "metadata.csv"}]
    c["phoneme_cache_path"] = str(tmp_path / "phonemes")
    c["gradual_training"] = [[0, 7, 4], [1, 2, 4]]
    c["epochs"], c["test_delay_epochs"], c["print_step"] = 2, 0, 1
    c["test_sentences"] = [SENTENCE]
    c["max_decoder_steps"] = STEPS
    path = tmp_path / "tacotron2.json"
    path.write_text(json.dumps(c))
    return c, str(path)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The CLI's run on the CPU, without tensorboardX (whose import alone
    takes seconds): the trainer, its config and the config's path."""
    from tts_tpu_torch.bin.train_tts import main
    tmp = tmp_path_factory.mktemp("taco2_train")
    c, cfg = _config(tmp, make_ljspeech_fixture(str(tmp / "ljspeech")))
    saved = sys.modules.get("tensorboardX")
    sys.modules["tensorboardX"] = None
    try:
        trainer = main(["--config_path", cfg, "--output_path",
                        str(tmp / "runs"), "--device", "cpu"])
    finally:
        if saved is None:
            sys.modules.pop("tensorboardX", None)
        else:
            sys.modules["tensorboardX"] = saved
    return trainer, c, cfg


def test_trainer_runs_the_schedule_and_moves_every_trained_tensor(trained):
    from tts_tpu_torch.models.layers import BatchNorm1d
    from tts_tpu_torch.models.registry import setup_model
    from tts_tpu_torch.text import num_symbols

    trainer, c, _ = trained
    assert trainer.dtype == torch.bfloat16
    assert [s["r"] for s in trainer.step_stats] == [7, 2]
    for stats in trainer.step_stats:
        assert {"decoder_loss", "postnet_loss", "stopnet_loss", "ga_loss",
                "ddc_decoder_loss", "ddc_attn_loss", "loss"} <= set(stats)
        assert all(np.isfinite(v) for v in stats.values()), stats
    assert trainer.model.r == 2 and trainer.model.coarse_decoder.r == 7
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(c.get("seed", 54321))
        init = setup_model(num_symbols(True), 1, c).state_dict()
    # the last step's gradients reach every trained tensor but the coarse
    # decoder's stopnet, whose logits no loss reads (in tts_tpu neither);
    # RAdam's first steps move a tensor by lr times its gradient, below
    # float32's resolution for the smallest, so "moved" is asserted where
    # the likeliest fault: the encoder's LSTM
    for name, p in trainer.model.named_parameters():
        if not p.requires_grad:
            assert torch.equal(p.detach(), init[name]), name
        elif name.startswith("coarse_decoder.stopnet"):
            assert p.grad is None, name
        else:
            assert float(p.grad.abs().max()) > 0, name
        if name.startswith("encoder.lstm.") and p.requires_grad:
            assert not torch.equal(p.detach(), init[name]), name
    # bf16 training moved every BatchNorm's running statistics, kept float32
    for name, m in trainer.model.named_modules():
        if isinstance(m, BatchNorm1d):
            assert m.running_var.dtype == m.running_mean.dtype == torch.float32
            assert not torch.equal(m.running_var, init[f"{name}.running_var"])


def test_checkpoint_serves_the_trained_weights_and_r(trained):
    """The last checkpoint (r 2 in it) through the Synthesizer equals the
    trainer's model; the fast path, whose packed weights were made before
    the last update, equals the plain decode on the trained weights."""
    from tts_tpu_torch.infer.synthesis import (run_model, synthesis,
                                               text_to_seqvec)
    from tts_tpu_torch.infer.synthesizer import Synthesizer
    from tts_tpu_torch.train.checkpoint import latest_checkpoint
    from tts_tpu_torch.train.trainer_tts import TTSTrainer

    trainer, c, cfg = trained
    ckpt = latest_checkpoint(trainer.output_path)
    assert torch.load(ckpt, weights_only=True)["r"] == 2
    assert os.path.isfile(os.path.join(trainer.output_path, "best_model.pt"))

    model = trainer.model.eval()
    seq = torch.from_numpy(text_to_seqvec(SENTENCE, c).astype(np.int64))[None]
    fast = run_model(model, seq, c)
    plain = model.inference(seq, max_decoder_steps=STEPS)
    for key in ("postnet_outputs", "stop_logits", "alignments"):
        np.testing.assert_allclose(fast[key].numpy(), plain[key].numpy(),
                                   atol=1e-5, err_msg=key)

    synth = Synthesizer(ckpt, cfg, device="cpu")
    assert synth.model.r == 2
    for name, value in model.state_dict().items():
        assert torch.equal(synth.model.state_dict()[name], value), name
    got = synthesis(synth.model, SENTENCE, c, torch.device("cpu"))
    want = synthesis(model, SENTENCE, c, torch.device("cpu"))
    np.testing.assert_array_equal(got["postnet_outputs"],
                                  want["postnet_outputs"])

    resumed = TTSTrainer(c, trainer.output_path, device="cpu")
    resumed.restore(ckpt)
    assert (resumed.global_step, resumed.r) == (trainer.global_step, 2)
    assert resumed.optimizer.count == trainer.optimizer.count
    for a, b in zip(resumed.optimizer.nu, trainer.optimizer.nu):
        assert torch.equal(a, b)


def test_prewarmed_synthesizer_serves_the_same_audio(trained):
    """Prewarm over two text buckets, then one request: the same audio as a
    Synthesizer that was not prewarmed."""
    from tts_tpu_torch.infer.synthesizer import Synthesizer
    from tts_tpu_torch.train.checkpoint import latest_checkpoint

    trainer, _, cfg = trained
    ckpt = latest_checkpoint(trainer.output_path)
    warm = Synthesizer(ckpt, cfg, device="cpu")
    assert warm.prewarm(buckets=[32, 64]) >= 0.0
    cold = Synthesizer(ckpt, cfg, device="cpu")
    np.testing.assert_array_equal(warm.tts(SENTENCE), cold.tts(SENTENCE))


def test_trainer_cli_raises_without_cuda(tmp_path, monkeypatch):
    """The trainer runs on CUDA unless --device names another device; with
    no card it raises instead of training on the CPU."""
    from tts_tpu_torch.bin.train_tts import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tmp_path / "tacotron2.json"
    with open(os.path.join(ROOT, "configs", "tacotron2_ljspeech.json")) as f:
        cfg.write_text(f.read())
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--config_path", str(cfg), "--output_path",
              str(tmp_path / "runs")])

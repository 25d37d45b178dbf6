"""Two repairs of the port, on the CPU.

- Checkpoint formats: a legacy ``torch.save`` file (a pickle, written with
  ``_use_new_zipfile_serialization=False`` as torch < 1.6 and Mozilla TTS
  ``.pth.tar`` files are) is a torch checkpoint and loads through the
  Synthesizer to the same weights as the zip format; a tts_tpu msgpack file
  is still told apart, and junk still raises.
- Long texts: ``GlowTTS.encode`` runs the fused encoder (B3; its plain
  version on the CPU) only up to ``fused_encoder_max_length``, the longest
  text B3's attention block holds on the card, and the module above it.
  The limit is patched down to a small T here; on the card it comes from
  ``glow_encoder.cu`` (``tests/test_torch_port_cuda.py`` holds it there).
  Fused against module: atol 1e-5 of the largest output, rtol 1e-4
  (float32, other summation orders).
"""

import json

import numpy as np
import pytest
import torch

from tts_tpu.train.checkpoint import save_checkpoint as save_tts_tpu
from tts_tpu_torch.config import load_config
from tts_tpu_torch.infer import synthesizer as synth_module
from tts_tpu_torch.models import glow_tts as glow_module
from tts_tpu_torch.models.glow_tts import GlowTTS
from tts_tpu_torch.models.registry import setup_model
from tts_tpu_torch.text import num_symbols
from tts_tpu_torch.train.checkpoint import is_torch_checkpoint

GLOW_CONFIG = "configs/glow_tts_ljspeech.json"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _small_config(tmp_path) -> str:
    """The shipped Glow-TTS config at hidden width 32 (a small state dict;
    the same model on both formats)."""
    c = dict(load_config(GLOW_CONFIG))
    c.update(hidden_channels_encoder=32, hidden_channels_decoder=32)
    path = tmp_path / "glow.json"
    path.write_text(json.dumps(c, default=dict))
    return str(path)


def test_legacy_torch_save_loads_through_the_synthesizer(tmp_path):
    cfg = _small_config(tmp_path)
    c = load_config(cfg)
    torch.manual_seed(0)
    model = setup_model(num_symbols(c.get("use_phonemes", False)), 1, c)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    legacy = str(tmp_path / "legacy.pth.tar")
    torch.save({"model": state, "step": 1}, legacy,
               _use_new_zipfile_serialization=False)
    modern = str(tmp_path / "modern.pt")
    torch.save({"model": state, "step": 1}, modern)
    with open(legacy, "rb") as f:
        assert f.read(1) == b"\x80"        # pickle's PROTO opcode
    assert is_torch_checkpoint(legacy) and is_torch_checkpoint(modern)

    served = {}
    for name, path in (("legacy", legacy), ("modern", modern)):
        s = synth_module.Synthesizer(path, cfg, device="cpu")
        served[name] = s.model.state_dict()
    assert served["legacy"].keys() == state.keys()
    for key, want in state.items():
        assert torch.equal(served["legacy"][key], want), key
        assert torch.equal(served["modern"][key], want), key


def test_msgpack_and_junk_are_still_told_apart(tmp_path):
    params = {"dense": {"kernel": np.ones((2, 3), np.float32),
                        "bias": np.zeros(3, np.float32)}}
    path = save_tts_tpu(str(tmp_path), params=params, step=3)
    with open(path, "rb") as f:
        assert 0x81 <= f.read(1)[0] <= 0x8F      # a fixmap with keys
    assert not is_torch_checkpoint(path)
    for name, head in (("junk", b"\x00not a checkpoint"),
                       ("text", b"{\"model\": 1}"), ("empty", b"")):
        bad = tmp_path / name
        bad.write_bytes(head)
        with pytest.raises(ValueError, match="neither"):
            is_torch_checkpoint(str(bad))


def _seeded_glow() -> GlowTTS:
    model = GlowTTS(num_chars=40, hidden_channels_enc=32,
                    hidden_channels_dec=16, filter_channels=64,
                    filter_channels_dp=48, num_layers_enc=2,
                    num_flow_blocks_dec=2, num_block_layers=2)
    g = torch.Generator().manual_seed(5)
    with torch.no_grad():     # refill: the prenet's zero projection and
        for p in model.encoder.parameters():   # unit LN scales hide errors
            p.copy_(torch.randn(p.shape, generator=g)
                    / max(1, p.shape[-1]) ** 0.5)
    return model.eval()


@pytest.mark.parametrize("limit", [8, 20])
def test_texts_above_the_limit_run_the_module(monkeypatch, limit):
    model = _seeded_glow()
    calls = []
    real = glow_module.fused_glow_encoder

    def spy(*args):
        calls.append(args[2].shape[1])
        return real(*args)
    monkeypatch.setattr(glow_module, "fused_glow_encoder", spy)
    monkeypatch.setattr(glow_module, "fused_encoder_max_length",
                        lambda enc, device: limit)
    rng = np.random.default_rng(6)
    text = torch.from_numpy(rng.integers(1, 40, (3, 24))).long()
    lengths = torch.tensor([24, 13, 5])
    for T in (limit + 1, 24, limit, limit - 3):
        x, n = text[:, :T], lengths.clamp(max=T)
        with torch.no_grad():
            got = model.encode(x, n)
            want = model.encoder(x, n)
        if T > limit:
            assert calls == [] or calls[-1] <= limit, calls
            for g, w in zip(got, want):
                assert torch.equal(g, w)
        else:
            assert calls[-1] == T
            for g, w in zip(got, want):
                np.testing.assert_allclose(
                    g.numpy(), w.numpy(), rtol=1e-4,
                    atol=1e-5 * float(w.abs().max()))
    assert calls == [limit, limit - 3]

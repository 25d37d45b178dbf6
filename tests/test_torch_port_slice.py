"""The port's serving slice as a whole: text -> Glow-TTS -> Multiband-MelGAN
-> waveform through ``Synthesizer`` and the HTTP server, against tts_tpu's
``Synthesizer`` on the same small configs and weights (device="cpu", so the
kernel wrappers run their plain versions). Also: the port imports nothing of
JAX, flax or tts_tpu, and its entry points refuse to fall back to the CPU
without being asked.
"""

import ast
import json
import os
import threading
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tts_tpu.models.glow_tts import GlowTTS as JGlowTTS
from tts_tpu.models.vocoder.multiband_melgan import \
    MultibandMelganGenerator as JMultiband
from tts_tpu.text import num_symbols
from tts_tpu.train.checkpoint import save_checkpoint
from tts_tpu_torch.compat.from_jax import (glow_tts_state_dict_from_jax,
                                           melgan_state_dict_from_jax)

from tests.torch_port_params import module_params

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AUDIO = {"sample_rate": 22050, "num_mels": 80, "fft_size": 1024,
         "hop_length": 256, "win_length": 1024, "signal_norm": True,
         "symmetric_norm": True, "max_norm": 4.0, "clip_norm": True,
         "mel_fmin": 50.0, "mel_fmax": 7600.0}
FACTORS = (2, 2, 2, 2)
# Wave tolerance: float32 through 6 encoder layers, 12 inverse flows and
# the generator, each a different summation order in the two packages.
WAV_ATOL = 1e-4


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Small configs, tts_tpu checkpoints and the port's checkpoints of the
    same weights. The duration head is pinned to 6 frames per symbol (as
    bench.py does), so the mel lengths are realistic and cannot hinge on a
    rounding flip."""
    d = tmp_path_factory.mktemp("served")
    tts_cfg = {"model": "glow_tts", "use_phonemes": False,
               "text_cleaner": "english_cleaners",
               "hidden_channels_encoder": 16, "hidden_channels_decoder": 16,
               "inference_noise_scale": 0.0, "audio": AUDIO}
    voc_cfg = {"generator_model": "multiband_melgan_generator",
               "generator_model_params": {"base_channels": 64,
                                          "upsample_factors": list(FACTORS),
                                          "num_res_blocks": 2},
               "audio": dict(AUDIO, hop_length=64)}
    paths = {"tts_config": str(d / "glow.json"),
             "vocoder_config": str(d / "melgan.json")}
    for name, cfg in (("tts_config", tts_cfg), ("vocoder_config", voc_cfg)):
        with open(paths[name], "w") as f:
            json.dump(cfg, f)

    glow = JGlowTTS(num_chars=num_symbols(False), hidden_channels_enc=16,
                    hidden_channels_dec=16)
    gparams = module_params(glow, 0, jnp.zeros((1, 8), jnp.int32),
                            jnp.array([8], jnp.int32), jnp.zeros((1, 12, 80)),
                            jnp.array([12], jnp.int32), train=False)
    proj = gparams["encoder"]["duration_predictor"]["proj"]
    proj["kernel"][:] = 0.0
    proj["bias"][:] = np.log(6.5)
    voc = JMultiband(base_channels=64, upsample_factors=FACTORS,
                     num_res_blocks=2)
    vparams = module_params(voc, 1, jnp.zeros((1, 8, 80)))

    paths["jax_tts"] = save_checkpoint(str(d / "jax_glow"), params=gparams)
    paths["jax_voc"] = save_checkpoint(str(d / "jax_voc"), params=vparams)
    paths["tts"] = str(d / "glow.pt")
    paths["voc"] = str(d / "melgan.pt")
    torch.save({"model": glow_tts_state_dict_from_jax(gparams)}, paths["tts"])
    torch.save({"model": melgan_state_dict_from_jax(vparams, FACTORS, 2)},
               paths["voc"])
    return paths


@pytest.fixture(scope="module")
def port_synth(served):
    from tts_tpu_torch.infer.synthesizer import Synthesizer
    return Synthesizer(served["tts"], served["tts_config"], served["voc"],
                       served["vocoder_config"], device="cpu")


def test_synthesizer_matches_tts_tpu(served, port_synth):
    from tts_tpu.infer.synthesizer import Synthesizer as JSynthesizer

    text = "Hello world. It is a test of the port!"
    jsynth = JSynthesizer(served["jax_tts"], served["tts_config"],
                          served["jax_voc"], served["vocoder_config"])
    want = jsynth.tts(text)
    got = port_synth.tts(text)
    assert got.shape == want.shape
    assert np.isfinite(got).all() and np.abs(got).max() > 1e-3
    np.testing.assert_allclose(got, want, atol=WAV_ATOL)


def test_vocoder_takes_the_kernel_path(port_synth):
    """Even factors: the synthesizer packs for megakernel_inference, the
    whole-generator kernel chain (its plain version on the CPU)."""
    assert port_synth._packed is not None and port_synth._stacks is None


def test_http_server(port_synth):
    from tts_tpu_torch.server.server import create_server

    server = create_server(port_synth, port=0, host="127.0.0.1")
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{port}"
    try:
        with urllib.request.urlopen(f"{base}/health", timeout=60) as r:
            assert json.loads(r.read())["status"] == "ok"
        with urllib.request.urlopen(f"{base}/", timeout=60) as r:
            assert b"tts_tpu_torch" in r.read()
        with urllib.request.urlopen(f"{base}/api/tts?text=Hello%20there.",
                                    timeout=120) as r:
            assert r.headers["Content-Type"] == "audio/wav"
            assert r.read(4) == b"RIFF"
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()


# ---------------------------------------------------------------------------
# the port stands alone
# ---------------------------------------------------------------------------

def _port_sources():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(ROOT, "tts_tpu_torch")):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return sorted(files)


def test_port_imports_no_jax_flax_or_tts_tpu():
    banned = ("jax", "jaxlib", "flax", "optax", "msgpack", "tts_tpu")
    offenders = []
    files = _port_sources()
    assert len(files) > 20
    for path in files:
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                if name.split(".")[0] in banned:
                    offenders.append(f"{os.path.relpath(path, ROOT)}: {name}")
    assert not offenders, offenders


# ---------------------------------------------------------------------------
# entry points run on CUDA unless asked for the CPU
# ---------------------------------------------------------------------------

@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_synthesizer_raises_without_cuda(served, no_cuda):
    from tts_tpu_torch.infer.synthesizer import Synthesizer
    with pytest.raises(RuntimeError, match="CUDA"):
        Synthesizer(served["tts"], served["tts_config"], served["voc"],
                    served["vocoder_config"])


def test_server_main_raises_without_cuda(served, no_cuda):
    from tts_tpu_torch.server.server import main
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--tts_checkpoint", served["tts"],
              "--tts_config", served["tts_config"],
              "--vocoder_checkpoint", served["voc"],
              "--vocoder_config", served["vocoder_config"]])


def test_kernel_weights_raise_without_cuda(no_cuda):
    from tts_tpu_torch.models.vocoder.multiband_melgan import \
        MultibandMelganGenerator
    from tts_tpu_torch.ops.cuda.fused_melgan import pack_generator_params
    gen = MultibandMelganGenerator(base_channels=32, upsample_factors=(2, 2),
                                   num_res_blocks=1, use_weight_norm=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        pack_generator_params(gen, gen.state_dict())
    assert pack_generator_params(gen, gen.state_dict(), device="cpu") \
        .proj_in_w.device.type == "cpu"

"""The port's Tacotron2 serving slice as a whole: text -> Tacotron2 (the fast
path: B7 and B8's plain versions on the CPU) -> Multiband-MelGAN -> waveform
through ``Synthesizer`` and the HTTP server, against tts_tpu's
``Synthesizer`` (which serves ``Tacotron2.inference``) on the same reduced
configs and weights. The checkpoints store r = 1, below the config's r = 2,
so both sides serve the checkpoint's r with the r_init = 2 projection. The
stopnet is silenced (zero weights, bias -10), so every request decodes the
config's 20 steps. Also: the port's serving modules load no JAX.
"""

import json
import os
import subprocess
import sys
import threading
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_tacotron2 import jax_variables
from tests.test_torch_port_slice import AUDIO, FACTORS, WAV_ATOL
from tests.torch_port_params import module_params
from tts_tpu.models.registry import setup_model as jsetup_model
from tts_tpu.models.vocoder.multiband_melgan import \
    MultibandMelganGenerator as JMultiband
from tts_tpu.text import num_symbols
from tts_tpu.train.checkpoint import save_checkpoint
from tts_tpu_torch.compat.from_jax import (melgan_state_dict_from_jax,
                                           tacotron2_state_dict_from_jax)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS, CKPT_R = 20, 1


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    d = tmp_path_factory.mktemp("served_taco2")
    tts_cfg = {"model": "tacotron2", "use_phonemes": False,
               "text_cleaner": "english_cleaners", "r": 2,
               "encoder_dim": 64, "embedding_dim": 64, "attn_dim": 32,
               "max_decoder_steps": STEPS, "audio": AUDIO}
    voc_cfg = {"generator_model": "multiband_melgan_generator",
               "generator_model_params": {"base_channels": 64,
                                          "upsample_factors": list(FACTORS),
                                          "num_res_blocks": 2},
               "audio": dict(AUDIO, hop_length=64)}
    paths = {"tts_config": str(d / "taco2.json"),
             "vocoder_config": str(d / "melgan.json")}
    for name, cfg in (("tts_config", tts_cfg), ("vocoder_config", voc_cfg)):
        with open(paths[name], "w") as f:
            json.dump(cfg, f)

    params, stats = jax_variables(jsetup_model(num_symbols(False), 1,
                                               tts_cfg), seed=3)
    stop = params["decoder"]["stopnet"]["linear"]
    stop["kernel"][:] = 0.0
    stop["bias"][:] = -10.0
    voc = JMultiband(base_channels=64, upsample_factors=FACTORS,
                     num_res_blocks=2)
    vparams = module_params(voc, 1, jnp.zeros((1, 8, 80)))

    paths["jax_tts"] = save_checkpoint(str(d / "jax_taco2"), params=params,
                                       batch_stats=stats, r=CKPT_R)
    paths["jax_voc"] = save_checkpoint(str(d / "jax_voc"), params=vparams)
    paths["tts"] = str(d / "taco2.pt")
    paths["voc"] = str(d / "melgan.pt")
    torch.save({"model": tacotron2_state_dict_from_jax(params, stats),
                "r": CKPT_R}, paths["tts"])
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
    from tts_tpu_torch.infer.fast_decode import supports_fused_decode

    assert supports_fused_decode(port_synth.model)
    assert port_synth.model.r == CKPT_R
    text = "Hello world. It is a test of the port!"
    jsynth = JSynthesizer(served["jax_tts"], served["tts_config"],
                          served["jax_voc"], served["vocoder_config"])
    want = jsynth.tts(text)
    got = port_synth.tts(text)
    # two sentences of STEPS * r frames (64 samples each), 10,000-sample gaps
    assert got.shape == want.shape == (2 * (STEPS * CKPT_R * 64 + 10000),)
    assert np.isfinite(got).all() and np.abs(got).max() > 1e-3
    np.testing.assert_allclose(got, want, atol=WAV_ATOL)


def test_http_server(port_synth):
    from tts_tpu_torch.audio.processor import read_wav
    from tts_tpu_torch.server.server import create_server

    server = create_server(port_synth, port=0, host="127.0.0.1")
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/api/tts?text=Hello%20there.",
                timeout=120) as r:
            assert r.headers["Content-Type"] == "audio/wav"
            wav, sr = read_wav(r.read())
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()
    assert sr == AUDIO["sample_rate"]
    assert len(wav) == STEPS * CKPT_R * 64 + 10000


def test_serving_modules_load_no_jax():
    """Importing the port's serving path, the Tacotron2 modules and kernel
    wrappers included, loads nothing of JAX, flax or tts_tpu."""
    code = ("import sys\n"
            "import tts_tpu_torch.server.server, tts_tpu_torch.infer."
            "synthesizer, tts_tpu_torch.infer.fast_decode\n"
            "import tts_tpu_torch.ops.cuda.bilstm, tts_tpu_torch.ops.cuda."
            "taco2_decode\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'flax', 'tts_tpu'))\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)

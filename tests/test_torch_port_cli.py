"""The port's synthesis CLI and its checkpoints, against tts_tpu, on the CPU.

``python -m tts_tpu_torch.bin.synthesize`` with ``--device cpu`` (the kernel
wrappers take their plain versions) on tts_tpu's own msgpack checkpoints
must write the WAV that tts_tpu's ``Synthesizer`` gives for the same files,
within ``WAV_ATOL`` (1e-4: float32 through the encoder, 12 inverse flows and
the generator in another summation order, then 16-bit WAV, 1 LSB = 3.1e-5);
on the port's torch checkpoints of the same weights it must write the same
file bit for bit. Without a vocoder both packages run Griffin-Lim (numpy,
seeded phases) on mels that differ by float32 rounding: held within
``GL_ATOL``. The duration head is pinned (6 frames per symbol), so no
duration can flip on a rounding difference.
"""

import json
import threading
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tts_tpu.audio.processor import write_wav as j_write_wav
from tts_tpu.infer.synthesizer import Synthesizer as JSynthesizer
from tts_tpu.models.glow_tts import GlowTTS as JGlowTTS
from tts_tpu.models.vocoder.multiband_melgan import \
    MultibandMelganGenerator as JMultiband
from tts_tpu.text import num_symbols
from tts_tpu.train.checkpoint import save_checkpoint
from tts_tpu_torch.audio.processor import read_wav
from tts_tpu_torch.bin.synthesize import main as synthesize
from tts_tpu_torch.compat.from_jax import (glow_tts_state_dict_from_jax,
                                           melgan_state_dict_from_jax)

from tests.torch_port_params import module_params

AUDIO = {"sample_rate": 22050, "num_mels": 80, "fft_size": 1024,
         "hop_length": 256, "win_length": 1024, "signal_norm": True,
         "symmetric_norm": True, "max_norm": 4.0, "clip_norm": True,
         "mel_fmin": 50.0, "mel_fmax": 7600.0, "griffin_lim_iters": 30}
FACTORS = (2, 2, 2, 2)
WAV_ATOL = 1e-4
GL_ATOL = 2e-3
TEXT = "It is a test of the port!"
GL_TEXT = "Hello there."


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Small configs; tts_tpu checkpoints (flax msgpack) and the port's
    torch checkpoints of the same seeded weights."""
    d = tmp_path_factory.mktemp("cli")
    tts_cfg = {"model": "glow_tts", "use_phonemes": False,
               "text_cleaner": "english_cleaners",
               "hidden_channels_encoder": 16, "hidden_channels_decoder": 16,
               "inference_noise_scale": 0.0, "do_trim_silence": True,
               "audio": AUDIO}
    voc_cfg = {"generator_model": "multiband_melgan_generator",
               "generator_model_params": {"base_channels": 64,
                                          "upsample_factors": list(FACTORS),
                                          "num_res_blocks": 2},
               "audio": dict(AUDIO, hop_length=64)}
    paths = {"tts_config": str(d / "glow.json"),
             "vocoder_config": str(d / "melgan.json"), "dir": d}
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
def tts_tpu_wavs(served):
    """tts_tpu's Synthesizer on its own files, written as its CLI writes
    them: with the vocoder, and (the same model, vocoder unset) through
    Griffin-Lim."""
    jsynth = JSynthesizer(served["jax_tts"], served["tts_config"],
                          served["jax_voc"], served["vocoder_config"])
    out = {}
    for name, text in (("vocoder", TEXT), ("griffin_lim", GL_TEXT)):
        if name == "griffin_lim":
            jsynth.vocoder_model = None
        path = str(served["dir"] / f"tts_tpu_{name}.wav")
        j_write_wav(path, jsynth.tts(text, speaker_id=2),
                    jsynth.ap.sample_rate)
        out[name] = read_wav(path)[0]
    return out


def _cli(served, text, model, out_dir, vocoder=None):
    args = [text, served["tts_config"], served[model],
            str(served["dir"] / out_dir), "--device", "cpu",
            "--speaker_id", "2"]
    if vocoder:
        args += ["--vocoder_path", served[vocoder],
                 "--vocoder_config_path", served["vocoder_config"]]
    path = synthesize(args)
    wav, sr = read_wav(path)
    assert sr == 22050 and np.isfinite(wav).all()
    return path, wav


def test_cli_on_tts_tpu_checkpoints_matches_tts_tpu(served, tts_tpu_wavs):
    path, got = _cli(served, TEXT, "jax_tts", "port_jax", "jax_voc")
    assert path.endswith("/It_is_a_test_of_the_port!.wav")
    want = tts_tpu_wavs["vocoder"]
    assert got.shape == want.shape and np.abs(got).max() > 1e-3
    np.testing.assert_allclose(got, want, atol=WAV_ATOL)
    _, same = _cli(served, TEXT, "tts", "port_torch", "voc")
    np.testing.assert_array_equal(same, got)


def test_griffin_lim_without_a_vocoder(served, tts_tpu_wavs):
    _, got = _cli(served, GL_TEXT, "jax_tts", "port_gl")
    want = tts_tpu_wavs["griffin_lim"]
    assert got.shape == want.shape and np.abs(got).max() > 1e-3
    np.testing.assert_allclose(got, want, atol=GL_ATOL)


def test_speaker_id_is_ignored_by_a_single_speaker_model(served):
    """tts_tpu passes the id on as speaker_ids and its single-speaker
    GlowTTS returns no speaker vector for it: the audio is unchanged."""
    from tts_tpu_torch.infer.synthesizer import Synthesizer
    synth = Synthesizer(served["tts"], served["tts_config"], device="cpu")
    assert synth.vocoder_model is None
    np.testing.assert_array_equal(synth.tts(GL_TEXT, speaker_id=5),
                                  synth.tts(GL_TEXT))


def test_server_starts_without_a_vocoder(served):
    from tts_tpu_torch.infer.synthesizer import Synthesizer
    from tts_tpu_torch.server.server import create_server, main

    with pytest.raises(SystemExit):     # a vocoder needs its config
        main(["--tts_checkpoint", served["jax_tts"], "--tts_config",
              served["tts_config"], "--vocoder_checkpoint", served["voc"]])
    synth = Synthesizer(served["jax_tts"], served["tts_config"],
                        device="cpu")
    server = create_server(synth, port=0, host="127.0.0.1")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = (f"http://127.0.0.1:{server.server_address[1]}"
           f"/api/tts?text=Hello%20there.")
    try:
        with urllib.request.urlopen(url, timeout=120) as r:
            assert r.headers["Content-Type"] == "audio/wav"
            wav, _ = read_wav(r.read())
        assert len(wav) > 10000 and np.isfinite(wav).all()
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()

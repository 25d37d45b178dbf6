"""The port's tooling against tts_tpu's, on the CPU: ``bin/eval_model``
(Glow-TTS through ``decode_mean``, Tacotron2 teacher-forced),
``bin/compute_statistics``, the figures (``utils/visual.py``; the Tacotron
trainer's ``test_run`` with and without matplotlib),
``utils/embeddings_visual.py``'s projection and ``utils/profiler.py``. The
converter's tests are ``test_torch_port_convert.py``, the export's
``test_torch_port_export.py``; they share this file's helpers.

Models are small (Glow-TTS hidden 32, 2 encoder layers and 3 flow blocks;
Tacotron2 with embedding and encoder 64, attention 32, no DDC) with weights from numpy seeds in tts_tpu's
shapes; the corpus is 8 synthetic LJSpeech-format items
(``tests/fixtures.py``), every one of them evaluated. tts_tpu's
``evaluate`` runs its model eagerly, op by op; the test jits the model's
``apply`` (the same function, compiled once). Tolerances: the
metrics within 1e-4 relative, the statistics 1e-6 relative.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import unfreeze

from tests.fixtures import make_ljspeech_fixture
from tests.test_torch_port_tacotron2 import jax_variables
from tests.torch_port_params import random_params
from tts_tpu.config import load_config as j_load_config
from tts_tpu.models.glow_tts import GlowTTS as JGlowTTS
from tts_tpu.models.registry import setup_model as j_setup_model
from tts_tpu.text import num_symbols as j_num_symbols
from tts_tpu.train.checkpoint import save_checkpoint as save_tts_tpu
from tts_tpu_torch.config import load_config
from tts_tpu_torch.models.glow_tts import GlowTTS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GLOW_SMALL = dict(hidden_channels_encoder=32, hidden_channels_decoder=32)
TACO_SMALL = dict(encoder_dim=64, embedding_dim=64, attn_dim=32, r=2,
                  gradual_training=None, double_decoder_consistency=False)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return make_ljspeech_fixture(str(tmp_path_factory.mktemp("ljspeech")))


def write_config(tmp_path, name, corpus, **overrides):
    """configs/<name>.json with ``overrides``, every corpus item held out
    (``meta_file_val``), written beside the test's files."""
    c = dict(load_config(os.path.join(ROOT, "configs", f"{name}.json")))
    c.update(overrides)
    c["datasets"] = [{"name": "ljspeech", "path": corpus,
                      "meta_file_train": "metadata.csv",
                      "meta_file_val": "metadata.csv"}]
    path = tmp_path / f"{name}.json"
    path.write_text(json.dumps(c, default=dict))
    return c, str(path)


def tts_tpu_checkpoint(tmp_path, cfg_path, seed=0):
    """A tts_tpu checkpoint of the config's model with seeded params and
    BatchNorm statistics; its path."""
    c = j_load_config(cfg_path)
    model = j_setup_model(j_num_symbols(c.get("use_phonemes", False)), 1, c)
    if c["model"] == "glow_tts":
        key = jax.random.PRNGKey(0)
        shapes = unfreeze(jax.eval_shape(lambda: model.init(
            {"params": key, "dropout": key, "noise": key},
            jnp.zeros((1, 8), jnp.int32), jnp.array([8]),
            jnp.zeros((1, 12, 80)), jnp.array([12]), train=False)))
        params = random_params(shapes["params"], np.random.default_rng(seed))
        stats = None
    else:
        params, stats = jax_variables(model, seed)
    save_tts_tpu(str(tmp_path / "ckpt"), params=params, batch_stats=stats,
                 step=1, r=c.get("r", 1))
    return str(tmp_path / "ckpt" / "checkpoint_1.ckpt")


GLOW_DEPTH = dict(num_layers_enc=2, num_flow_blocks_dec=3, num_block_layers=2)


class _ShallowJGlow(JGlowTTS):
    num_layers_enc: int = GLOW_DEPTH["num_layers_enc"]
    num_flow_blocks_dec: int = GLOW_DEPTH["num_flow_blocks_dec"]
    num_block_layers: int = GLOW_DEPTH["num_block_layers"]


class _ShallowGlow(GlowTTS):
    def __init__(self, **kwargs):
        super().__init__(**{**kwargs, **GLOW_DEPTH})


@pytest.fixture
def shallow_glow(monkeypatch):
    """Both registries build Glow-TTS at ``GLOW_DEPTH`` (2 encoder layers,
    3 flow blocks of 2 layers; the registries fix the depth, a cut here)."""
    import tts_tpu.models.glow_tts as jglow

    import tts_tpu_torch.models.glow_tts as glow
    monkeypatch.setattr(jglow, "GlowTTS", _ShallowJGlow)
    monkeypatch.setattr(glow, "GlowTTS", _ShallowGlow)


class _JittedApply:
    """A tts_tpu model whose ``apply`` is jitted (the same function,
    compiled once instead of op by op); every other attribute is the
    model's."""

    def __init__(self, module):
        self._module = module
        self.apply = jax.jit(module.apply,
                             static_argnames=("method", "train", "mutable"))

    def __getattr__(self, name):
        return getattr(self._module, name)


def _assert_metrics_match(got, want):
    assert set(got) == set(want), (sorted(got), sorted(want))
    for key, value in want.items():
        if isinstance(value, (bool, str)) or value is None:
            assert got[key] == value, key
        else:
            np.testing.assert_allclose(got[key], value, rtol=1e-4,
                                       atol=1e-6, err_msg=key)


@pytest.mark.parametrize("name", ["glow_tts_ljspeech", "tacotron2_ljspeech"])
def test_evaluate_matches_tts_tpu(name, corpus, tmp_path, monkeypatch,
                                  shallow_glow):
    """Both packages' ``evaluate`` on the same tts_tpu checkpoint and
    corpus: every metric. Tacotron2 also against itself as the reference
    checkpoint (tts_tpu's ``vs_ref_*``; tts_tpu cannot take one for a flow
    model, whose forward has no ``postnet_outputs``)."""
    from tts_tpu.bin.eval_model import evaluate as j_evaluate
    from tts_tpu.models import registry
    from tts_tpu_torch.bin.eval_model import main

    small = GLOW_SMALL if name.startswith("glow") else TACO_SMALL
    _, cfg = write_config(tmp_path, name, corpus, **small)
    ckpt = tts_tpu_checkpoint(tmp_path, cfg)
    ref = None if name.startswith("glow") else ckpt
    monkeypatch.setattr(registry, "setup_model",
                        lambda *a, **k: _JittedApply(j_setup_model(*a, **k)))
    want = j_evaluate(cfg, ckpt, ref_checkpoint=ref, num_items=8)
    args = ["--config_path", cfg, "--checkpoint", ckpt, "--num_items", "8",
            "--device", "cpu", "--out", str(tmp_path / "m.json")]
    got = main(args + (["--ref_checkpoint", ref] if ref else []))
    assert got["n_items"] == 8
    _assert_metrics_match(got, want)
    assert json.loads((tmp_path / "m.json").read_text()) == got
    if ref:
        assert got["vs_ref_max_abs_diff"] == 0.0


def test_compute_statistics_matches_tts_tpu(corpus, tmp_path):
    from tts_tpu.bin.compute_statistics import \
        compute_statistics as j_compute
    from tts_tpu_torch.bin.compute_statistics import main

    c, cfg = write_config(tmp_path, "glow_tts_ljspeech", corpus)
    want = j_compute(j_load_config(cfg), str(tmp_path / "want.npy"))
    main(["--config_path", cfg, "--out_path", str(tmp_path / "got.npy")])
    got = np.load(tmp_path / "got.npy", allow_pickle=True).item()
    assert got.keys() == want.keys()
    assert got["audio_config"] == want["audio_config"]
    for key in ("mel_mean", "mel_std", "linear_mean", "linear_std"):
        assert got[key].dtype == np.float32
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6,
                                   err_msg=key)
    # the statistics normalize the port's audio processor
    from tts_tpu_torch.audio import AudioProcessor
    ap = AudioProcessor(**dict(c["audio"], stats_path=str(tmp_path
                                                          / "got.npy")))
    np.testing.assert_array_equal(ap.mel_scaler[0], got["mel_mean"])


# ---------------------------------------------------------------------------
# figures, embeddings, profiler
# ---------------------------------------------------------------------------

def test_figures_match_tts_tpus_plots():
    import matplotlib.pyplot as plt

    from tts_tpu.utils import visual as JV
    from tts_tpu_torch.audio import AudioProcessor
    from tts_tpu_torch.utils import visual as V

    rng = np.random.default_rng(4)
    align = rng.random((1, 20, 12)).astype(np.float32)
    spec = rng.standard_normal((20, 80)).astype(np.float32)
    ap = AudioProcessor(**load_config(os.path.join(
        ROOT, "configs", "glow_tts_ljspeech.json"))["audio"])
    wav = (0.1 * rng.standard_normal(2048)).astype(np.float32)
    for got, want in ((V.plot_alignment(align, info="step 3"),
                       JV.plot_alignment(align, info="step 3")),
                      (V.plot_spectrogram(spec, ap),
                       JV.plot_spectrogram(spec, ap))):
        g, w = got.axes[0].images[0], want.axes[0].images[0]
        np.testing.assert_array_equal(g.get_array(), w.get_array())
        assert got.axes[0].get_xlabel() == want.axes[0].get_xlabel()
    figures = V.plot_results(wav, 0.5 * wav, ap)
    assert sorted(figures) == sorted(JV.plot_results(wav, 0.5 * wav, ap))
    plt.close("all")


def test_project_embeddings_is_tts_tpus_pca():
    from tts_tpu.utils.embeddings_visual import project_embeddings as j_proj
    from tts_tpu_torch.utils.embeddings_visual import (plot_embeddings,
                                                       project_embeddings)
    emb = np.random.default_rng(5).standard_normal((12, 16))
    np.testing.assert_allclose(project_embeddings(emb), j_proj(emb),
                               rtol=0, atol=1e-10)
    fig = plot_embeddings(emb, num_utter_per_speaker=3)
    assert len(fig.axes[0].collections[0].get_offsets()) == 12


def test_profiler_traces_and_annotates_on_the_cpu(tmp_path):
    from tts_tpu_torch.utils.profiler import annotate, memory_stats, trace
    with trace(str(tmp_path / "prof")) as prof:
        with annotate("port_region"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert any(e.key == "port_region" for e in prof.key_averages())
    text = (tmp_path / "prof" / "trace.json").read_text()
    assert "port_region" in text
    assert memory_stats() is None          # no CUDA here


def test_test_run_logs_figures_and_without_matplotlib_audio(corpus,
                                                            tmp_path):
    """The Tacotron2 trainer's test sentences (shipped widths, 6 decoder
    steps): with matplotlib, tts_tpu's spectrogram and alignment figures
    per sentence; with matplotlib missing, one message, no figures, the
    same audio."""
    from tts_tpu_torch.train.trainer_tts import TTSTrainer

    c, _ = write_config(tmp_path, "tacotron2_ljspeech", corpus,
                        max_decoder_steps=6, test_sentences=["Be a voice."],
                        phoneme_cache_path=str(tmp_path / "phonemes"))
    saved = {k: sys.modules.get(k) for k in ("tensorboardX", "matplotlib")}
    sys.modules["tensorboardX"] = None
    logged = []
    try:
        trainer = TTSTrainer(c, str(tmp_path / "run"), device="cpu")
        tb_eval_figures = trainer.tb.tb_eval_figures
        trainer.tb.tb_eval_figures = lambda step, figures: (
            logged.append(sorted(figures)), tb_eval_figures(step, figures))
        with_figures = trainer.test_run()
        sys.modules["matplotlib"] = None
        without = trainer.test_run()
        again = trainer.test_run()
    finally:
        for key, module in saved.items():
            if module is None:
                sys.modules.pop(key, None)
            else:
                sys.modules[key] = module
    assert logged == [["test_0_alignment", "test_0_spectrogram"], [], []]
    assert trainer.said_no_figures
    for audios in (without, again):
        np.testing.assert_array_equal(audios["test_0"],
                                      with_figures["test_0"])
